"""Classic softmax attention (paper §2), the baseline the paper measures
itself against (port of ``repro/core/softmax_attention.py``).

R(D, Q) = Hᵀ softmax(Hq): O(nk) per lookup and O(nk) memory. Also the
causal multi-head form and the complexity counters of the paper's
Table 1. Plain PyTorch, as in JAX (no kernel).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor


def softmax_lookup(h: Tensor, q: Tensor) -> Tensor:
    """R(D,Q) = Hᵀ softmax(Hq). h: (..., n, k); q: (..., k) or (..., m, k).
    The softmax and the read in fp32, the answer in h's type."""
    single = q.ndim == h.ndim - 1
    if single:
        q = q[..., None, :]
    scores = torch.einsum("...nk,...mk->...mn", h, q)
    probs = torch.softmax(scores.float(), dim=-1)
    out = torch.einsum("...mn,...nk->...mk", probs, h.float()).to(h.dtype)
    return out[..., 0, :] if single else out


def causal_softmax_attention(q: Tensor, k: Tensor, v: Tensor, *,
                             scale: Optional[float] = None,
                             bias: Optional[Tensor] = None) -> Tensor:
    """Causal softmax attention, (B, H, T, D) convention, fp32 softmax;
    the queries are the last T of the S keys. Returns (B, H, T, D) in
    v's type."""
    t, s = q.shape[2], k.shape[2]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("bhtd,bhsd->bhts", q, k).float() * scale
    if bias is not None:
        scores = scores + bias
    causal = torch.ones((t, s), dtype=torch.bool,
                        device=q.device).tril(diagonal=s - t)
    scores = torch.where(causal, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", probs.to(v.dtype), v)


def softmax_decode_step(k_cache: Tensor, v_cache: Tensor, cache_len,
                        q: Tensor, k_new: Tensor, v_new: Tensor, *,
                        scale: Optional[float] = None
                        ) -> Tuple[Tensor, Tensor, Tensor]:
    """One decode step against a KV cache (the O(n) lookup the paper's
    state read replaces). k_cache, v_cache: (B, H, S, D); cache_len: ()
    the current length (clamped to S − 1 for the write, as JAX's dynamic
    update clamps); q, k_new, v_new: (B, H, D). Returns (o, k_cache,
    v_cache): new caches, the arguments are not written."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    s = k_cache.shape[2]
    n = int(cache_len)
    row = min(max(n, 0), s - 1)
    k_cache, v_cache = k_cache.clone(), v_cache.clone()
    k_cache[:, :, row] = k_new.to(k_cache.dtype)
    v_cache[:, :, row] = v_new.to(v_cache.dtype)
    scores = torch.einsum("bhd,bhsd->bhs", q, k_cache).float() * scale
    valid = torch.arange(s, device=q.device) <= n
    scores = torch.where(valid[None, None, :], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    o = torch.einsum("bhs,bhsd->bhd", probs.to(v_cache.dtype), v_cache)
    return o, k_cache, v_cache


# ---------------------------------------------------------------------------
# Complexity accounting (paper Table 1)
# ---------------------------------------------------------------------------

def lookup_flops_softmax(n: int, k: int, m: int = 1) -> int:
    """Per-query softmax lookup: Hq (2nk) + softmax (~5n) + Hᵀp (2nk)."""
    return m * (2 * n * k + 5 * n + 2 * n * k)


def lookup_flops_linear(k: int, m: int = 1) -> int:
    """Per-query linear lookup Cq: 2k², independent of n (the claim)."""
    return m * 2 * k * k


def memory_softmax(n: int, k: int, bytes_per: int = 4) -> int:
    return n * k * bytes_per


def memory_linear(k: int, bytes_per: int = 4) -> int:
    return k * k * bytes_per
