"""Models of the port: the paper's CTC LSTM (``chipmunk_net``), the LMs
(``layers``, ``transformer``) and the recurrent LMs (``recurrent``: xLSTM,
Hymba), selected by ``registry.get_bundle``."""
from . import chipmunk_net, layers, recurrent, registry, transformer
from .registry import (ModelBundle, TensorSpec, batch_axes, get_bundle,
                       input_specs)

__all__ = ['chipmunk_net', 'layers', 'recurrent', 'registry', 'transformer',
           'ModelBundle', 'TensorSpec', 'batch_axes', 'get_bundle',
           'input_specs']
