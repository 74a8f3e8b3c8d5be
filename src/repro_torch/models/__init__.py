"""Models of the port: the paper's CTC LSTM (``chipmunk_net``), the LMs
(``layers``, ``transformer``) and the recurrent LMs (``recurrent``: xLSTM,
Hymba), selected by ``registry.get_bundle``."""
from . import chipmunk_net, layers, recurrent, registry, transformer
from .registry import ModelBundle, get_bundle

__all__ = ['chipmunk_net', 'layers', 'recurrent', 'registry', 'transformer',
           'ModelBundle', 'get_bundle']
