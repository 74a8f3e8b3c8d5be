from .pipeline import HostLoader, SyntheticCTC, source_for

__all__ = ['HostLoader', 'SyntheticCTC', 'source_for']
