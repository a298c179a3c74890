"""PyTorch/CUDA port of ``repro`` for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package imports none of
it. Each module names the JAX module it ports. Every Pallas kernel on a
ported path has a hand-written CUDA counterpart under
``kernels/<name>/csrc``, built with ``nvcc`` at first use; a kernel
wrapper runs its plain PyTorch version only for tensors on the CPU.
"""
