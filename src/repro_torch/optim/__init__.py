"""Optimizer substrate of the port (``repro/optim``): Adam/AdamW,
schedules, clipping, gradient accumulation and gradient compression with
error feedback."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamState, Optimizer, adam, adamw, apply_updates, clip_by_global_norm,
    global_norm, opt_state_specs,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant, cosine_warmup, linear_warmup,
)
from repro_torch.optim.accumulate import GradAccumulator  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    ErrorFeedback, compress_bf16, decompress_bf16,
)
