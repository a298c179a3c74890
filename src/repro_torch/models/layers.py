"""Basic layers on plain tensors: norms, RoPE, MLP, initialisers (port of
``repro/models/layers.py``).

Parameters are nested dicts of tensors. Dense weights are stored
(d_in, d_out) and applied as ``x @ w``, the JAX package's layout, so
converted weights need no transpose. Initialisers draw from an explicit
``torch.Generator`` on the device the tensors are made on; ``lead`` is a
leading shape (the repeat axis of a stacked layer group).
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               lead: Tuple[int, ...] = (), dtype=torch.float32,
               scale: Optional[float] = None) -> Tensor:
    """Normal weights over sqrt(d_in), or times ``scale`` if given."""
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device)
    return (w / math.sqrt(d_in) if scale is None else w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, d: int, *,
               dtype=torch.float32) -> Tensor:
    w = torch.randn((vocab, d), generator=gen, device=gen.device)
    return (w * 0.02).to(dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm_params(d: int, *, lead: Tuple[int, ...] = (),
                   dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device)}


def rmsnorm(params: Params, x: Tensor, eps: float = 1e-6) -> Tensor:
    """RMS norm computed in fp32, returned in x's type."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * params["scale"].float()).to(x.dtype)


def apply_norm(kind: str, params: Params, x: Tensor) -> Tensor:
    if kind != "rmsnorm":
        raise NotImplementedError(f"norm {kind!r}: the port has rmsnorm only")
    return rmsnorm(params, x)


def groupnorm_heads(x: Tensor, scale: Tensor, bias: Tensor,
                    eps: float = 1e-5) -> Tensor:
    """Per-head groupnorm over (B, T, H, D) head outputs (RWKV style),
    computed in fp32 over the last dimension, returned in x's type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_cos_sin(positions: Tensor, head_dim: int, theta: float
                 ) -> Tuple[Tensor, Tensor]:
    """positions: (...,) int -> cos/sin of shape (..., head_dim/2), fp32."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32,
                             device=positions.device) / half
    # fp32 pow with a Python-scalar base: no host→device copy, which would
    # synchronise the stream once per layer
    freqs = torch.pow(theta, exponent)
    angles = positions.float()[..., None] * freqs
    return torch.cos(angles), torch.sin(angles)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------

def mlp_params(gen: torch.Generator, d_model: int, d_ff: int, act: str, *,
               lead: Tuple[int, ...] = (), dtype=torch.float32) -> Params:
    p = {
        "w_up": dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype),
        "w_down": dense_init(gen, d_ff, d_model, lead=lead, dtype=dtype),
    }
    if act == "swiglu":
        p["w_gate"] = dense_init(gen, d_model, d_ff, lead=lead, dtype=dtype)
    return p


def mlp(params: Params, x: Tensor, act: str) -> Tensor:
    up = x @ params["w_up"].to(x.dtype)
    if act == "swiglu":
        h = F.silu(x @ params["w_gate"].to(x.dtype)) * up
    else:
        h = F.gelu(up, approximate="tanh")   # jax.nn.gelu's default
    return h @ params["w_down"].to(x.dtype)
