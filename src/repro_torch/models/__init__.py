"""Models of the port: the paper's CTC LSTM (``chipmunk_net``) and the dense
decoder-only LM (``layers``, ``transformer``), selected by
``registry.get_bundle``."""
from . import chipmunk_net, layers, registry, transformer
from .registry import ModelBundle, get_bundle

__all__ = ['chipmunk_net', 'layers', 'registry', 'transformer',
           'ModelBundle', 'get_bundle']
