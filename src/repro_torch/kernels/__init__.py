"""Hand-written CUDA kernels of the port, one directory per kernel:
``csrc/`` (CUDA C++), ``ops.py`` (wrapper) and ``ref.py`` (plain PyTorch)."""
