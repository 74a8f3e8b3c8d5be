"""PyTorch/CUDA port of the Chipmunk reproduction (forward / serving path).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``core.lstm``, ``core.quant``, ``core.systolic``,
``kernels.lstm_seq``, ``models``, ``serving``, ``launch``) so each
counterpart is easy to find.  It imports ``torch`` and numpy only — never
``jax`` and never ``repro``.  The four persistent LSTM kernels (f32 K1, K2;
the int8 silicon datapath K3, K4) are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built lazily by ``kernels._build`` at their first CUDA launch;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
