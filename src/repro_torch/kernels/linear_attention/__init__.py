"""Chunked causal linear attention (B2) and its §3.3 backward (B3)."""
from repro_torch.kernels.linear_attention import ops, ref  # noqa: F401
