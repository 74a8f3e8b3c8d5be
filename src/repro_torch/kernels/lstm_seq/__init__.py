"""The two persistent f32 LSTM kernels of the serving path (K1, K2), their
plain PyTorch versions (``ref``) and their public ops."""
from .kernel import LaunchGeometry, lstm_seq, seq_geometry
from .ops import lstm_layer_seq
from .ref import lstm_seq_ref, lstm_stack_seq_ref
from .stack_kernel import lstm_stack_seq_kernel, stack_geometry
from .stack_ops import (StackWeights, lstm_stack_seq, stack_fused_compatible,
                        stack_kernel_weights)

__all__ = ['LaunchGeometry', 'lstm_seq', 'seq_geometry', 'lstm_layer_seq',
           'lstm_seq_ref', 'lstm_stack_seq_ref', 'lstm_stack_seq_kernel',
           'stack_geometry', 'StackWeights', 'lstm_stack_seq',
           'stack_fused_compatible', 'stack_kernel_weights']
