"""PyTorch/CUDA port of the Chipmunk reproduction (forward / serving path).

The JAX package ``repro`` is the reference; this package mirrors its module
names (``configs``, ``core.lstm``, ``kernels.lstm_seq``, ``models``,
``serving``, ``launch``) so each counterpart is easy to find.  It imports
``torch`` and numpy only — never ``jax`` and never ``repro``.  The two
persistent LSTM kernels are hand-written CUDA C++ for ``sm_90a``
(``csrc/``), built lazily by ``kernels._build`` at their first CUDA launch;
on CPU tensors every kernel wrapper runs its plain PyTorch version.
"""
