"""Chunked gated (decay) linear attention (B8) and its recompute
backward (B9)."""
from repro_torch.kernels.gated_linear_attention import ops, ref  # noqa: F401
