"""fused_recurrent kernel package."""
from repro_torch.kernels.fused_recurrent import ops, ref  # noqa: F401
