from .pipeline import (HostLoader, PipelineConfig, ShardedLoader,
                       SyntheticCTC, SyntheticLM, TokenFile, source_for)

__all__ = ['HostLoader', 'PipelineConfig', 'ShardedLoader', 'SyntheticCTC',
           'SyntheticLM', 'TokenFile', 'source_for']
