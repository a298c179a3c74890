"""Gated linear attention in PyTorch (port of ``repro/core/gated.py``:
the paper's §4 family).

The paper's exact instance (α = β = 1, gated features f = σ(Wh+b) ⊙ h)
is ``paper_gate``; ``invert_update`` and ``reconstruct_states_backward``
are its §4 backward trick, recovering C_t from C_{t+1} by inverting the
update instead of storing the states.

Per head, with a_t = exp(g_t) and g_t ≤ 0 the log-decay:

    inclusive (GLA / SSD):  S_t = diag(a_t) S_{t-1} + k_t v_tᵀ ;  o_t = S_tᵀ q_t
    exclusive + u (RWKV-6): o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ q_t, then
                            S_t = diag(a_t) S_{t-1} + k_t v_tᵀ

``gla_scan`` is the per-token recurrence, ``chunked_gla`` the
chunk-parallel form used by prefill, ``gated_decode_step`` one decode
step, and ``gated_linear_attention`` the differentiable inclusive form
that training runs: B8 forward and B9's recompute backward (only q, k,
v and g are kept; the states are recomputed, never stored). Only the
chunked forms clamp the log-decay to [``min_log_decay``, 0]; the
recurrences use exp(g) as given, as the JAX package does.

The chunk form scales keys by exp(-b) with b the within-chunk cumulative
log-decay. With g at the clamp (-1) b reaches -chunk, and exp(-b)
overflows fp32 past about 88 tokens: in a 128-token chunk the late keys
are inf, the masked products 0 × inf are NaN, and every output of the
chunk is NaN (the carried state stays finite). The JAX reference behaves
the same way and the port's plain versions keep it; the CUDA kernels
behind ``gated_linear_attention`` rescale within 32-token tiles and
stay finite there. At the model's operating point (b_gate = 4,
g ≈ -0.002) b stays far inside the range.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

# zero-padding T to a chunk multiple: padded k/v/g rows are inert (the
# padded decay is exp(0) = 1, so the carried state is unchanged)
from repro_torch.core.linear_attention import _chunk

Tensor = torch.Tensor

DEFAULT_CHUNK = 128
MIN_LOG_DECAY = -1.0


# ---------------------------------------------------------------------------
# Paper §4 exact instance (α = β = 1, gated features)
# ---------------------------------------------------------------------------

def paper_gate(h: Tensor, w: Tensor, b: Tensor) -> Tensor:
    """f_t = sigmoid(W h_t + b) ⊙ h_t — the paper's gate."""
    return torch.sigmoid(h @ w.T + b) * h


def invert_update(c_next: Tensor, f: Tensor, alpha: float = 1.0,
                  beta: float = 1.0) -> Tensor:
    """Paper §4: C_t = (C_{t+1} − β f fᵀ) / α."""
    return (c_next - beta * torch.einsum("...k,...l->...kl", f, f)) / alpha


def reconstruct_states_backward(c_final: Tensor, f_seq: Tensor) -> Tensor:
    """Recover every intermediate C_t from the final C by inversion.

    f_seq: (..., n, k). Returns (n+1, ..., k, k) with [0] the zero
    initial state and [n] == c_final: the paper's storage-free backward.
    """
    f_rev = torch.movedim(f_seq, -2, 0).flip(0)
    cs, c = [], c_final
    for f_t in f_rev:
        cs.append(c)                        # C after t+1 updates
        c = invert_update(c, f_t)
    return torch.stack([torch.zeros_like(c_final)] + cs[::-1])


# ---------------------------------------------------------------------------
# Decay family
# ---------------------------------------------------------------------------

def gla_scan(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    log_decay: Tensor,
    *,
    initial_state: Optional[Tensor] = None,
    exclusive: bool = False,
    u: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-token gated recurrence (reference).

    q, k: (B,H,T,Dk); v: (B,H,T,Dv); log_decay: (B,H,T,Dk) or (B,H,T,1)
    for scalar per-head decay; u: (Dk,) or (H, Dk). Returns
    (o: (B,H,T,Dv) in v's type, S_T)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    s = (torch.zeros((b, h, dk, dv), dtype=acc, device=q.device)
         if initial_state is None else initial_state.to(acc))
    a = torch.exp(log_decay.expand(b, h, t, dk).to(acc))
    if exclusive:
        bonus = (torch.zeros((dk,), dtype=acc, device=q.device)
                 if u is None else u.to(acc))
        bonus = bonus.expand(h, dk)
    outs = []
    for i in range(t):
        q_t, k_t, v_t = q[:, :, i].to(acc), k[:, :, i].to(acc), \
            v[:, :, i].to(acc)
        kv = torch.einsum("bhk,bhv->bhkv", k_t, v_t)
        if exclusive:
            s_eff = s + torch.einsum("bhk,bhv->bhkv", bonus[None] * k_t, v_t)
            o_t = torch.einsum("bhkv,bhk->bhv", s_eff, q_t)
            s = a[:, :, i, :, None] * s + kv
        else:
            s = a[:, :, i, :, None] * s + kv
            o_t = torch.einsum("bhkv,bhk->bhv", s, q_t)
        outs.append(o_t)
    return torch.stack(outs, dim=2).to(v.dtype), s


def chunked_gla(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    log_decay: Tensor,
    *,
    chunk_size: int = DEFAULT_CHUNK,
    initial_state: Optional[Tensor] = None,
    exclusive: bool = False,
    u: Optional[Tensor] = None,
    min_log_decay: float = MIN_LOG_DECAY,
) -> Tuple[Tensor, Tensor]:
    """Chunk-parallel gated linear attention: ``gla_scan``'s semantics
    with the log-decay clamped to [min_log_decay, 0]. All inter-chunk
    communication is the fixed-size Dk×Dv state. Returns
    (o: (B,H,T,Dv) in v's type, final fp32 state)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c = min(chunk_size, t)
    acc = torch.promote_types(q.dtype, torch.float32)

    g = log_decay.expand(b, h, t, dk).to(acc).clamp(min_log_decay, 0.0)
    qc = _chunk(q, c).to(acc)
    kc = _chunk(k, c).to(acc)
    vc = _chunk(v, c).to(acc)
    gc = _chunk(g, c)

    mask = torch.tril(torch.ones((c, c), dtype=acc, device=q.device),
                      diagonal=-1 if exclusive else 0)
    s = (torch.zeros((b, h, dk, dv), dtype=acc, device=q.device)
         if initial_state is None else initial_state.to(acc))
    if exclusive and u is not None:
        ub = u.to(acc).expand(h, dk)
        eye = torch.eye(c, dtype=acc, device=q.device)

    outs = []
    for i in range(qc.shape[2]):
        q_i, k_i, v_i, g_i = qc[:, :, i], kc[:, :, i], vc[:, :, i], gc[:, :, i]
        bcum = torch.cumsum(g_i, dim=2)             # inclusive within-chunk
        btot = bcum[:, :, -1:, :]                   # (B,H,1,Dk)
        # exclusive: the query at t sees the state through t-1
        q_scale = torch.exp(bcum - g_i) if exclusive else torch.exp(bcum)
        q_hat = q_i * q_scale
        k_hat = k_i * torch.exp(-bcum)
        scores = torch.einsum("bhck,bhdk->bhcd", q_hat, k_hat) * mask
        if exclusive and u is not None:
            diag = torch.einsum("bhck,hk,bhck->bhc", q_i, ub, k_i)
            scores = scores + diag[..., None] * eye
        intra = torch.einsum("bhcd,bhdv->bhcv", scores, v_i)
        inter = torch.einsum("bhck,bhkv->bhcv", q_hat, s)
        outs.append(intra + inter)
        k_tail = k_i * torch.exp(btot - bcum)       # decay to chunk end
        s = torch.exp(btot[:, :, 0, :, None]) * s + torch.einsum(
            "bhck,bhcv->bhkv", k_tail, v_i)
    o = torch.stack(outs, dim=2).reshape(b, h, -1, dv)[:, :, :t]
    return o.to(v.dtype), s


def gated_decode_step(
    state: Tensor,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    log_decay: Tensor,
    *,
    exclusive: bool = False,
    u: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """One decode step of the gated mechanism: S ← diag(exp g) S + k vᵀ,
    then o = Sᵀq (inclusive), or o from S + diag(u) k vᵀ before the update
    (exclusive). state: (B,H,Dk,Dv); q, k: (B,H,Dk); v: (B,H,Dv);
    log_decay: (B,H,Dk) or (B,H,1). Returns (o: (B,H,Dv) in v's type,
    new_state); the inputs are not modified."""
    acc = state.dtype
    a = torch.exp(log_decay.expand(q.shape).to(acc))
    kv = torch.einsum("bhk,bhv->bhkv", k.to(acc), v.to(acc))
    if exclusive:
        bonus = (torch.zeros(q.shape[-1], dtype=acc, device=q.device)
                 if u is None else u.to(acc))
        bonus = bonus.expand(q.shape[1], q.shape[-1])       # (H, Dk)
        s_eff = state + bonus[None, :, :, None] * kv
        o = torch.einsum("bhkv,bhk->bhv", s_eff, q.to(acc))
        state = a[..., None] * state + kv
    else:
        state = a[..., None] * state + kv
        o = torch.einsum("bhkv,bhk->bhv", state, q.to(acc))
    return o.to(v.dtype), state


def gated_linear_attention(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    log_decay: Tensor,
    *,
    chunk_size: int = DEFAULT_CHUNK,
    min_log_decay: float = MIN_LOG_DECAY,
    kernel: bool = True,
) -> Tensor:
    """Inclusive decay-gated linear attention with the memory-efficient
    backward (JAX ``gated_linear_attention``, custom VJP ``_gla_core``):
    forward B8, backward B9's recompute, keeping only (q, k, v, g).
    ``kernel=False`` asks for the plain PyTorch versions on a CUDA tensor
    (CPU tensors always take them). q, k: (B, H, T, Dk); v: (B, H, T, Dv);
    log_decay: (B, H, T, Dk) or (B, H, T, 1) → o in v's type."""
    # imported here: the kernel's plain version is this module's
    # chunked_gla
    from repro_torch.kernels.gated_linear_attention import ops
    return ops.gated_linear_attention(q, k, v, log_decay, chunk=chunk_size,
                                      min_log_decay=min_log_decay,
                                      kernel=kernel)
