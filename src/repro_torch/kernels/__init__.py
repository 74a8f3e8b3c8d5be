"""Hand-written Hopper kernels of the port and their plain PyTorch versions.

Sources live in ``repro_torch/csrc``; ``_build`` compiles them with ``nvcc``
for ``sm_90a`` at their first CUDA launch and loads them with ``ctypes``.
Importing this package needs neither ``nvcc`` nor a card.
"""
