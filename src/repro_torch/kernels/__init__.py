"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Each kernel lives in its own subpackage with ``kernel.py`` (the wrapper
that launches it on CUDA tensors and runs its plain version on CPU ones),
``ops.py`` (its public ops) and ``ref.py`` (the plain version): the f32 and
int8 LSTM sequence kernels K1-K4 (``lstm_seq``), the per-step LSTM kernels
K5 and K6 (``lstm_gates``), the int8 matmul K7 (``quant_matmul``) and
attention K8 (``flash_attention``).  Sources live in ``repro_torch/csrc``;
``_build`` compiles them with ``nvcc`` for ``sm_90a`` at their first CUDA
launch and loads them with ``ctypes``.  Importing this package needs
neither ``nvcc`` nor a card.
"""
from . import flash_attention, lstm_gates, lstm_seq, quant_matmul

__all__ = ['flash_attention', 'lstm_gates', 'lstm_seq', 'quant_matmul']
