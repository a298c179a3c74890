"""RWKV6Backend — pure RWKV-6 stacks as a serving backend (port of
``repro/serving/backends/rwkv6.py``).

RWKV-6 is the paper's eq. 4 with vector decay and a bonus term: per
layer the decode state is two ``(S, d_model)`` token-shift rows plus a
``(S, heads, head_dim, head_dim)`` wkv matrix, fixed-size and O(1) in
context, so admission copies O(k²) bytes per layer whatever the
request's history. Each admission prefills the prompt through B8's
exclusive route (one launch per layer on CUDA tensors); decode windows
and ingest chunks step the single-token decode (plain PyTorch, as JAX's
masked per-step scan). Varlen prefill is attention-only, so
``resolve_modes`` turns ``admission="auto"`` into ``per_request``.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.backends.base import (
    DecodeBackend,
    _pattern_kinds,
    register_backend,
)


@register_backend
class RWKV6Backend(DecodeBackend):
    """Pure RWKV-6 layer stacks (token-shift + wkv matrix state)."""

    name = "rwkv6"
    priority = 10

    @classmethod
    def handles(cls, cfg: ModelConfig) -> bool:
        return _pattern_kinds(cfg) == frozenset({"rwkv"})

    def _validate(self, cfg: ModelConfig) -> None:
        if _pattern_kinds(cfg) != frozenset({"rwkv"}):
            raise ValueError(
                f"backend {self.name!r} serves pure rwkv patterns; config "
                f"{cfg.name!r} has kinds {sorted(_pattern_kinds(cfg))}")
        if cfg.rwkv is None:
            raise ValueError(
                f"backend {self.name!r}: config {cfg.name!r} has rwkv "
                f"layers but no RWKVConfig (cfg.rwkv)")
