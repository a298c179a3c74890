"""lookup kernel package."""
from repro_torch.kernels.lookup import ops, ref  # noqa: F401
