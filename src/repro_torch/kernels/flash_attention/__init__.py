"""Causal flash-attention forward (B10), the softmax baseline's prefill."""
from repro_torch.kernels.flash_attention import ops, ref  # noqa: F401
