"""K5 and K6, the per-step f32 LSTM kernels (``csrc/lstm_gates_rec.cu``),
their plain PyTorch versions (``ref``) and their public ops: the fused cell
``lstm_cell_fused`` (K6) and the ``cuda_step`` backend (K5)."""
from .kernel import (gates_geometry, gates_rec_geometry, lstm_gates,
                     lstm_gates_rec)
from .ops import lstm_cell_fused, lstm_layer_fused, lstm_step_fused
from .ref import lstm_gates_rec_ref, lstm_gates_ref

__all__ = ['gates_geometry', 'gates_rec_geometry', 'lstm_gates',
           'lstm_gates_rec', 'lstm_cell_fused', 'lstm_layer_fused',
           'lstm_step_fused', 'lstm_gates_rec_ref', 'lstm_gates_ref']
