"""Optimizer substrate of the port (``repro/optim``): Adam/AdamW,
schedules, clipping and gradient accumulation. The gradient compression
of ``compress.py`` (``ErrorFeedback``) is not ported yet."""

from repro_torch.optim.adamw import (  # noqa: F401
    AdamState, Optimizer, adam, adamw, apply_updates, clip_by_global_norm,
    global_norm,
)
from repro_torch.optim.schedule import (  # noqa: F401
    constant, cosine_warmup, linear_warmup,
)
from repro_torch.optim.accumulate import GradAccumulator  # noqa: F401
