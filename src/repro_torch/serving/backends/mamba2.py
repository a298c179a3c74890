"""Mamba2Backend — pure Mamba-2 (SSD) stacks as a serving backend (port
of ``repro/serving/backends/mamba2.py``).

Mamba-2's decode state is the paper's fixed-size property in SSM form:
per layer a ``(S, conv_kernel - 1, conv_dim)`` conv window and an
``(S, heads, d_state, head_dim)`` SSD state, O(1) in context length, so
admission copies O(k²) bytes per layer whatever the request's history.
Each admission prefills the prompt through B8's inclusive route (one
launch per layer on CUDA tensors); decode windows and ingest chunks
step the single-token decode (plain PyTorch, JAX's masked per-step
scan), inactive slots bit for bit. Varlen prefill is attention-only,
so ``resolve_modes`` turns ``admission="auto"`` into ``per_request``.
Hybrids (zamba2-7b: mamba and ``shared_attn``) go to the attention
family's backend, ``FixedStateBackend`` or ``SoftmaxKVBackend``, as in
JAX.
"""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.backends.base import (
    DecodeBackend,
    _pattern_kinds,
    register_backend,
)


@register_backend
class Mamba2Backend(DecodeBackend):
    """Pure Mamba-2 layer stacks (fixed-size conv + SSD state)."""

    name = "mamba2"
    priority = 10

    @classmethod
    def handles(cls, cfg: ModelConfig) -> bool:
        return _pattern_kinds(cfg) == frozenset({"mamba"})

    def _validate(self, cfg: ModelConfig) -> None:
        if _pattern_kinds(cfg) != frozenset({"mamba"}):
            raise ValueError(
                f"backend {self.name!r} serves pure mamba patterns; config "
                f"{cfg.name!r} has kinds {sorted(_pattern_kinds(cfg))}")
        if cfg.ssm is None:
            raise ValueError(
                f"backend {self.name!r}: config {cfg.name!r} has mamba "
                f"layers but no SSMConfig (cfg.ssm)")
