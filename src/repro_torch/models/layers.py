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

from repro_torch.sharding import replicated_like

Tensor = torch.Tensor
Params = Dict[str, Tensor]


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def normal_matrices(gen: torch.Generator, shape: Tuple[int, ...],
                    scale: float, dtype) -> Tensor:
    """Normal weights times ``scale``, in ``dtype``, drawn one (rows, cols)
    matrix at a time: an fp32 draw of a whole stacked tensor (an MoE
    layer's experts, yi-34b's 60 × 7,168 × 20,480 w_up) would need twice
    its bf16 size again as transient memory. Under ``FakeTensorMode``
    (the dry run's shapes, no values) one empty tensor stands for them."""
    out = torch.empty(shape, dtype=dtype, device=gen.device)
    if torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.FAKE):
        return out
    for w in out.view(-1, *shape[-2:]):
        w.copy_(torch.randn(shape[-2:], generator=gen, device=gen.device)
                * scale)
    return out


def dense_init(gen: torch.Generator, d_in: int, d_out: int, *,
               lead: Tuple[int, ...] = (), dtype=torch.float32,
               scale: Optional[float] = None) -> Tensor:
    """Normal weights over sqrt(d_in), or times ``scale`` if given: fp32
    weights drawn in one go, weights of another type by
    ``normal_matrices``."""
    if dtype != torch.float32:
        return normal_matrices(gen, (*lead, d_in, d_out),
                               1.0 / math.sqrt(d_in) if scale is None
                               else scale, dtype)
    w = torch.randn((*lead, d_in, d_out), generator=gen, device=gen.device)
    return w / math.sqrt(d_in) if scale is None else w * scale


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


def layernorm_params(d: int, *, lead: Tuple[int, ...] = (),
                     dtype=torch.float32, device=None) -> Params:
    return {"scale": torch.ones((*lead, d), dtype=dtype, device=device),
            "bias": torch.zeros((*lead, d), dtype=dtype, device=device)}


def layernorm(params: Params, x: Tensor, eps: float = 1e-5) -> Tensor:
    """Layer norm (population variance) with scale and bias, computed in
    fp32, returned in x's type."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, unbiased=False, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    out = out * params["scale"].float() + params["bias"].float()
    return out.to(x.dtype)


def norm_params(kind: str, d: int, *, lead: Tuple[int, ...] = (),
                dtype=torch.float32, device=None) -> Params:
    make = rmsnorm_params if kind == "rmsnorm" else layernorm_params
    return make(d, lead=lead, dtype=dtype, device=device)


def apply_norm(kind: str, params: Params, x: Tensor) -> Tensor:
    return rmsnorm(params, x) if kind == "rmsnorm" else layernorm(params, x)


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


# ---------------------------------------------------------------------------
# depthwise causal conv (Mamba)
# ---------------------------------------------------------------------------

def causal_conv1d(x: Tensor, w: Tensor, cache: Optional[Tensor] = None
                  ) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv. x: (B, T, C); w: (K, C); cache: the K−1
    inputs before x, (B, K−1, C), zeros if None. Returns (y, new_cache)
    with y_t = Σ_j w[j] ⊙ xx[t + j] over xx = [cache | x], and new_cache
    the last K−1 inputs of xx, (B, K−1, C)."""
    k = w.shape[0]
    if cache is None:      # on a mesh a replicated DTensor, as x is one
        cache = replicated_like(torch.zeros(
            (x.shape[0], k - 1, x.shape[-1]), dtype=x.dtype,
            device=x.device), x)
    xx = torch.cat([cache.to(x.dtype), x], dim=1)
    new_cache = xx[:, -(k - 1):] if k > 1 else cache
    t = x.shape[1]
    y = torch.zeros_like(x)
    for j in range(k):
        y = y + xx[:, j:j + t] * w[j].to(x.dtype)
    return y, new_cache
