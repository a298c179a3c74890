"""Causal linear attention in PyTorch (port of
``repro/core/linear_attention.py``: the forward forms, and
``causal_linear_attention`` with the paper's §3.3 backward).

The recurrence, per head, with untied projections q, k, v:

    S_t = S_{t-1} + k_t v_tᵀ ;   o_t = S_tᵀ q_t

and, under ``normalize``, o_t /= safe_denom(q_t · z_t) with
z_t = Σ_{s≤t} k_s. Every form here updates the state with (k_t, v_t)
first and then reads it with q_t.

Shapes follow the (batch, heads, seq, dim) convention. Accumulation is
in float32 whatever the input type; outputs come back in v's type.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Tensor = torch.Tensor

DEFAULT_CHUNK = 128


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def safe_denom(d: Tensor, eps: float = 1e-6) -> Tensor:
    """Sign-preserving clamp for the normaliser denominator:
    sign(d)·max(|d|, eps), with d == 0 mapped to +eps."""
    return torch.where(d >= 0, d.clamp(min=eps), d.clamp(max=-eps))


def causal_linear_attention_scan(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    initial_state: Optional[Tensor] = None,
    normalize: bool = False,
    eps: float = 1e-6,
) -> Tuple[Tensor, Tensor]:
    """Per-token recurrence. q, k: (B, H, T, Dk); v: (B, H, T, Dv).
    Returns (o: (B, H, T, Dv), S_T)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    acc = _acc_dtype(q.dtype)
    s = (torch.zeros((b, h, dk, dv), dtype=acc, device=q.device)
         if initial_state is None else initial_state.to(acc))
    z = torch.zeros((b, h, dk), dtype=acc, device=q.device)
    outs = []
    for i in range(t):
        q_t = q[:, :, i].to(acc)
        k_t = k[:, :, i].to(acc)
        s = s + torch.einsum("bhk,bhv->bhkv", k_t, v[:, :, i].to(acc))
        z = z + k_t
        o_t = torch.einsum("bhkv,bhk->bhv", s, q_t)
        if normalize:
            denom = torch.einsum("bhk,bhk->bh", z, q_t)
            o_t = o_t / safe_denom(denom, eps)[..., None]
        outs.append(o_t)
    return torch.stack(outs, dim=2).to(v.dtype), s


def _chunk(x: Tensor, chunk: int) -> Tensor:
    """(B,H,T,D) -> (B,H,N,C,D), zero-padding T to a chunk multiple.

    Zero-padded keys/values contribute nothing to state or outputs;
    padded query rows are sliced off by callers.
    """
    b, h, t, d = x.shape
    t_pad = -(-t // chunk) * chunk
    if t_pad != t:
        x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
    return x.reshape(b, h, t_pad // chunk, chunk, d)


def causal_linear_attention_chunked(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    chunk_size: int = DEFAULT_CHUNK,
    initial_state: Optional[Tensor] = None,
    initial_z: Optional[Tensor] = None,
    normalize: bool = False,
    eps: float = 1e-6,
) -> Tuple[Tensor, Tensor]:
    """Chunk-parallel causal linear attention:

        out_i = Q_i S_i + (Q_i K_iᵀ ⊙ M) V_i ;  S_{i+1} = S_i + K_iᵀ V_i

    ``initial_state`` / ``initial_z`` continue a previously encoded
    prefix (the state and the key-sum normaliser start from the carried
    values). Returns (o: (B, H, T, Dv) in v's type, final fp32 state).
    """
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    chunk_size = min(chunk_size, t)
    acc = _acc_dtype(q.dtype)

    qc = _chunk(q, chunk_size).to(acc)
    kc = _chunk(k, chunk_size).to(acc)
    vc = _chunk(v, chunk_size).to(acc)

    mask = torch.tril(torch.ones((chunk_size, chunk_size), dtype=acc,
                                 device=q.device))
    s = (torch.zeros((b, h, dk, dv), dtype=acc, device=q.device)
         if initial_state is None else initial_state.to(acc))
    z = (torch.zeros((b, h, dk), dtype=acc, device=q.device)
         if initial_z is None else initial_z.to(acc))

    outs = []
    for i in range(qc.shape[2]):
        q_i, k_i, v_i = qc[:, :, i], kc[:, :, i], vc[:, :, i]
        scores = torch.einsum("bhck,bhdk->bhcd", q_i, k_i) * mask
        intra = torch.einsum("bhcd,bhdv->bhcv", scores, v_i)
        inter = torch.einsum("bhck,bhkv->bhcv", q_i, s)
        o_i = intra + inter
        if normalize:
            # z_t = Σ_{s<=t} k_s: carry-in z + intra-chunk cumulative sum
            k_cum = torch.cumsum(k_i, dim=2) + z[:, :, None, :]
            denom = torch.einsum("bhck,bhck->bhc", q_i, k_cum)
            o_i = o_i / safe_denom(denom, eps)[..., None]
            z = k_cum[:, :, -1, :]
        s = s + torch.einsum("bhck,bhcv->bhkv", k_i, v_i)
        outs.append(o_i)
    o = torch.stack(outs, dim=2).reshape(b, h, -1, dv)[:, :, :t]
    return o.to(v.dtype), s


def causal_linear_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    chunk_size: int = DEFAULT_CHUNK,
    normalize: bool = False,
    eps: float = 1e-6,
    kernel: bool = True,
) -> Tensor:
    """Causal linear attention with the paper's memory-efficient backward
    (JAX ``causal_linear_attention``): the unnormalised core is an
    autograd function whose forward is B2 and whose backward is B3's
    recompute, keeping only (q, k, v); the optional normaliser is an fp32
    epilogue that autograd differentiates. ``kernel=False`` asks for the
    plain PyTorch versions on a CUDA tensor (CPU tensors always take
    them). q, k: (B, H, T, Dk); v: (B, H, T, Dv) → o in v's type."""
    # imported here: the kernel's plain version is this module's
    # causal_linear_attention_chunked
    from repro_torch.kernels.linear_attention import ops
    o = ops.linear_attention(q, k, v, chunk=chunk_size, kernel=kernel)
    if normalize:
        acc = _acc_dtype(q.dtype)
        k_cum = torch.cumsum(k.to(acc), dim=2)
        # a row-wise dot product: einsum would run it as a batched matmul
        # of B·H·T one-by-one products, slower than the attention itself
        denom = (q.to(acc) * k_cum).sum(dim=-1)
        o = (o.to(acc) / safe_denom(denom, eps)[..., None]).to(v.dtype)
    return o


def decode_step(
    state: Tensor,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    z: Optional[Tensor] = None,
    normalize: bool = False,
    eps: float = 1e-6,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """One autoregressive step: update the state with (k, v), answer q.

    state: (B,H,Dk,Dv); q,k: (B,H,Dk); v: (B,H,Dv). Returns
    (o: (B,H,Dv) in v's type, new_state, new_z); the inputs are not
    modified.
    """
    acc = state.dtype
    state = state + torch.einsum("bhk,bhv->bhkv", k.to(acc), v.to(acc))
    o = torch.einsum("bhkv,bhk->bhv", state, q.to(acc))
    new_z = None
    if normalize:
        if z is None:
            raise ValueError("normalize=True needs the key-sum normaliser z")
        new_z = z + k.to(acc)
        denom = torch.einsum("bhk,bhk->bh", new_z, q.to(acc))
        o = o / safe_denom(denom, eps)[..., None]
    return o.to(v.dtype), state, new_z
