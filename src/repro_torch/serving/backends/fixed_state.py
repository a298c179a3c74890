"""FixedStateBackend — the paper's linear and gated-linear families
(port of ``repro/serving/backends/fixed_state.py``).

Per attention layer the whole attended context is an O(k²)
(S, H, Dk, Dv) state (plus the k-sized normaliser under the linear
backend), constant in context length. Decode and recurrent ingest run
through the fused recurrent CUDA kernels, B1 (``decode_linear``) and B7
(``decode_gated``), on CUDA tensors; admission is an O(k²)-per-layer
copy whatever the request's history.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.backends.base import (
    ATTN_KINDS,
    DecodeBackend,
    _pattern_kinds,
    register_backend,
)

@register_backend
class FixedStateBackend(DecodeBackend):
    """Linear / gated-linear attention (fixed-size O(k²) state)."""

    name = "fixed_state"
    priority = 90          # generic fallback: pure-family backends first

    @classmethod
    def handles(cls, cfg: ModelConfig) -> bool:
        return cfg.fixed_state_decode

    def _validate(self, cfg: ModelConfig) -> None:
        if not cfg.fixed_state_decode:
            raise ValueError(
                f"backend {self.name!r} requires a fixed-size decode "
                f"state; config {cfg.name!r} has attention_backend="
                f"{cfg.attention_backend!r} with attention layers "
                f"({sorted(_pattern_kinds(cfg) & set(ATTN_KINDS))})")
