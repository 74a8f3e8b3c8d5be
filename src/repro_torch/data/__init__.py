from .pipeline import (HostLoader, SyntheticCTC, SyntheticLM, TokenFile,
                       source_for)

__all__ = ['HostLoader', 'SyntheticCTC', 'SyntheticLM', 'TokenFile',
           'source_for']
