"""K5, the per-step f32 LSTM kernel (``csrc/lstm_gates_rec.cu``), its plain
PyTorch version (``ref``) and its public ops: the ``cuda_step`` backend."""
from .kernel import gates_rec_geometry, lstm_gates_rec
from .ops import lstm_layer_fused, lstm_step_fused
from .ref import lstm_gates_rec_ref, lstm_gates_ref

__all__ = ['gates_rec_geometry', 'lstm_gates_rec', 'lstm_layer_fused',
           'lstm_step_fused', 'lstm_gates_rec_ref', 'lstm_gates_ref']
