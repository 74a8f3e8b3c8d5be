"""The four persistent LSTM kernels of the port — f32 (K1, K2) and the
int8 silicon datapath (K3, K4) — their plain PyTorch versions (``ref``) and
their public ops, the f32 ones differentiable."""
from .kernel import (LaunchGeometry, lstm_seq, lstm_seq_quantized,
                     seq_geometry, seq_q_geometry)
from .ops import (QuantizedLayerWeights, lstm_layer_seq,
                  lstm_layer_seq_quantized, lstm_seq_fused)
from .ref import (lstm_seq_quantized_ref, lstm_seq_ref,
                  lstm_stack_seq_quantized_ref, lstm_stack_seq_ref)
from .stack_kernel import (lstm_stack_seq_kernel, lstm_stack_seq_kernel_q,
                           stack_geometry, stack_q_geometry)
from .stack_ops import (QuantizedStackWeights, StackWeights, lstm_stack_seq,
                        lstm_stack_seq_quantized,
                        lstm_stack_seq_fused,
                        lstm_stack_seq_quantized_auto,
                        stack_fused_compatible, stack_kernel_weights,
                        stack_kernel_weights_q)

__all__ = ['LaunchGeometry', 'lstm_seq', 'lstm_seq_quantized', 'seq_geometry',
           'seq_q_geometry', 'lstm_layer_seq', 'lstm_layer_seq_quantized',
           'lstm_seq_fused', 'lstm_stack_seq_fused',
           'lstm_seq_quantized_ref', 'lstm_seq_ref',
           'lstm_stack_seq_quantized_ref', 'lstm_stack_seq_ref',
           'lstm_stack_seq_kernel', 'lstm_stack_seq_kernel_q',
           'stack_geometry', 'stack_q_geometry', 'QuantizedLayerWeights',
           'QuantizedStackWeights', 'StackWeights', 'lstm_stack_seq',
           'lstm_stack_seq_quantized', 'lstm_stack_seq_quantized_auto',
           'stack_fused_compatible', 'stack_kernel_weights',
           'stack_kernel_weights_q']
