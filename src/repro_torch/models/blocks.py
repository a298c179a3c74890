"""Block dispatch, ``"attn"`` kind (port of ``repro/models/blocks.py``):
pre-norm self-attention (``softmax``, ``linear`` or ``gated_linear``) +
MLP.

``shared_attn``, ``cross``, ``mamba`` and ``rwkv`` blocks and MoE MLPs are
not ported yet and raise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as A
from repro_torch.models import layers as L

Tensor = torch.Tensor
Params = Dict[str, Any]


def _require_attn(kind: str, cfg: ModelConfig) -> None:
    if kind != "attn" or cfg.moe is not None:
        raise NotImplementedError(
            f"{cfg.name}: the port has dense 'attn' blocks only (got "
            f"kind {kind!r}{', MoE' if cfg.moe is not None else ''})")


def block_params(kind: str, gen: torch.Generator, cfg: ModelConfig, *,
                 lead: Tuple[int, ...] = (), dtype=torch.float32) -> Params:
    _require_attn(kind, cfg)
    return {
        "norm1": L.rmsnorm_params(cfg.d_model, lead=lead, dtype=dtype,
                                  device=gen.device),
        "norm2": L.rmsnorm_params(cfg.d_model, lead=lead, dtype=dtype,
                                  device=gen.device),
        "attn": A.attention_params(gen, cfg, lead=lead, dtype=dtype),
        "mlp": L.mlp_params(gen, cfg.d_model, cfg.d_ff, cfg.act, lead=lead,
                            dtype=dtype),
    }


def block_state_init(kind: str, cfg: ModelConfig, batch: int, *,
                     max_len: Optional[int] = None,
                     lead: Tuple[int, ...] = (), device=None) -> A.AttnState:
    _require_attn(kind, cfg)
    return A.init_attn_state(cfg, batch, max_len=max_len, lead=lead,
                             device=device)


def _mlp_residual(p: Params, x: Tensor, cfg: ModelConfig) -> Tensor:
    return x + L.mlp(p["mlp"], L.apply_norm(cfg.norm, p["norm2"], x),
                     cfg.act)


def block_apply(kind: str, p: Params, x: Tensor, cfg: ModelConfig, *,
                want_state: bool = False, attention_kernel: bool = True,
                varlen: Optional[Tensor] = None
                ) -> Tuple[Tensor, Optional[A.AttnState]]:
    """x: (B, T, D) → (x, state_or_None). ``varlen``: (B,) per-row valid
    lengths of an END-padded batch (bucket-padded batched prefill)."""
    _require_attn(kind, cfg)
    h1 = L.apply_norm(cfg.norm, p["norm1"], x)
    att, st = A.attention_apply(p["attn"], h1, cfg, want_state=want_state,
                                attention_kernel=attention_kernel,
                                varlen=varlen)
    return _mlp_residual(p, x + att, cfg), st


def block_decode(kind: str, p: Params, x: Tensor, state: A.AttnState,
                 pos: Tensor, cfg: ModelConfig, *,
                 active: Optional[Tensor] = None
                 ) -> Tuple[Tensor, A.AttnState]:
    """x: (B, D) one token per sequence; pos: () or (B,); ``active``:
    (B,) bool slot mask, inactive rows keep their state bit for bit. The
    state is updated in place."""
    _require_attn(kind, cfg)
    h1 = L.apply_norm(cfg.norm, p["norm1"], x)
    att, st = A.attention_decode(p["attn"], h1, state, pos, cfg,
                                 active=active)
    return _mlp_residual(p, x + att, cfg), st


def block_decode_window(kind: str, p: Params, x: Tensor, state: A.AttnState,
                        pos0: Tensor, cfg: ModelConfig, *,
                        lens: Optional[Tensor] = None
                        ) -> Tuple[Tensor, A.AttnState]:
    """x: (B, W, D) — W known tokens per sequence, one fused kernel launch
    per block for the linear family; under softmax the attention steps
    single-token decode over the window (JAX scans ``block_decode``; the
    MLP is per token, so running it once over the window is the same
    function). ``lens``: (B,) per-row valid window lengths. The state is
    updated in place."""
    _require_attn(kind, cfg)
    h1 = L.apply_norm(cfg.norm, p["norm1"], x)
    att, st = A.attention_decode_window(p["attn"], h1, state, pos0, cfg,
                                        lens=lens)
    return _mlp_residual(p, x + att, cfg), st


def block_ingest_window(kind: str, p: Params, x: Tensor, state: A.AttnState,
                        pos0: Tensor, cfg: ModelConfig, *,
                        lens: Optional[Tensor] = None
                        ) -> Tuple[Tensor, A.AttnState]:
    """Like :func:`block_decode_window`, but with ``lens`` the linear
    family's attention continues its state through the chunk-parallel
    prefill forms (``attention_ingest_window``) instead of the
    recurrence; softmax keeps the per-step path. The state is updated
    in place."""
    if lens is None:
        return block_decode_window(kind, p, x, state, pos0, cfg)
    _require_attn(kind, cfg)
    h1 = L.apply_norm(cfg.norm, p["norm1"], x)
    att, st = A.attention_ingest_window(p["attn"], h1, state, pos0, cfg,
                                        lens=lens)
    return _mlp_residual(p, x + att, cfg), st
