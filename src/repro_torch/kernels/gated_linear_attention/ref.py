"""Plain PyTorch versions of the gated (decay) linear-attention kernels
(port of ``repro/kernels/gated_linear_attention/ref.py``, plus the plain
forms of the Pallas functions of
``repro/kernels/gated_linear_attention/kernel.py``).

All functions take flat rows: q, k, g (BH, T, Dk), v and do (BH, T, Dv),
g the log-decay (≤ 0, fp32). They accumulate in float32:

- ``gated_linear_attention_ref``: the quadratic pairwise oracle. It
  forms exp(b_t − b_s) for every pair, masked ones included, so at a
  strong decay over a long T it overflows and gives NaN, as JAX's does;
- ``chunked_fwd_ref``: what B8 (``kernel.fwd``) emits, o and the final
  fp32 state, chunk by chunk with g clamped to [min_log_decay, 0];
  inclusive, or exclusive with the RWKV-6 bonus u;
- ``chunked_bwd_dq_ref`` / ``chunked_bwd_dkv_ref``: the bodies of
  ``_dq_kernel`` (forward sweep over S) and ``_dkv_kernel`` (reverse
  sweep over R), chunk by chunk, dq and dk in fp32, dv in v's type;
- ``dg_epilogue``: dg = reverse-cumsum(q⊙dq − k⊙dk), zero where the
  clamp was active (``kernel.bwd``'s plain epilogue); ``dg_from_qdq``
  the same from q⊙dq already formed;
- ``bwd_dq_ref`` / ``bwd_dkv_dg_ref``: B9's function split as its CUDA
  launches split it: the forward sweep returns dq in q's type and q⊙dq
  in fp32, the reverse sweep takes q⊙dq and returns dk, dv and dg;
- ``chunked_bwd_ref``: B9's function, the two above together;
- ``chunked_bwd_exclusive_ref``: the backward of the exclusive form with
  the bonus u (RWKV-6), which JAX takes by autodiff of ``chunked_gla``:
  B9's two sweeps with the strict mask and q scaled by e^{b_{t-1}}
  (``chunked_bwd_exclusive_dq_ref`` / ``chunked_bwd_exclusive_dkv_ref``),
  the bonus terms, dg by ``dg_exclusive`` and du; split as its CUDA
  launches split it by ``bwd_exclusive_dq_ref`` /
  ``bwd_exclusive_dkv_ref``.

The chunked forms scale by exp(±b) with b the cumulative log-decay from
the start of the chunk; with g at the clamp (−1) over a 128-token chunk
exp(−b) passes fp32's range and they give NaN where the Pallas bodies
do. The CUDA kernels (``csrc/gated_linear_attention.cu``) rescale
within tiles of at most 64 tokens and stay finite there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.gated import MIN_LOG_DECAY, chunked_gla

Tensor = torch.Tensor


def gated_linear_attention_ref(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    g: Tensor,
    *,
    exclusive: bool = False,
    u: Optional[Tensor] = None,
    initial_state: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Direct quadratic reference of the paper's eq. 4 decay family.

    inclusive: o_t = Σ_{s≤t} (q_t · (k_s ⊙ exp(b_t − b_s))) v_s
    exclusive: o_t = Σ_{s<t} (q_t · (k_s ⊙ exp(b_{t−1} − b_s))) v_s
                   + (q_t · (u ⊙ k_t)) v_t              (RWKV-6 bonus)
    state:     S = Σ_s (k_s ⊙ exp(b_T − b_s)) v_sᵀ (+ decayed S₀)

    Returns (o in v's type, S fp32). No clamp: g is used as given.
    """
    t = q.shape[1]
    acc = torch.float32
    qf, kf, vf, gf = (x.to(acc) for x in (q, k, v, g))
    b = torch.cumsum(gf, dim=1)                         # inclusive
    if exclusive:
        b_q = b - gf                                    # b_{t-1}
        mask = torch.tril(torch.ones((t, t), dtype=acc, device=q.device),
                          diagonal=-1)
    else:
        b_q = b
        mask = torch.tril(torch.ones((t, t), dtype=acc, device=q.device))
    # w[t,s,k] = exp(b_q[t,k] - b[s,k]): explicit (small T only: oracle)
    w = torch.exp(b_q[:, :, None, :] - b[:, None, :, :])
    scores = torch.einsum("btk,btsk,bsk->bts", qf, w, kf) * mask
    o = torch.einsum("bts,bsv->btv", scores, vf)
    if exclusive and u is not None:
        diag = torch.einsum("btk,k,btk->bt", qf, u.to(acc), kf)
        o = o + diag[..., None] * vf
    btot = b[:, -1:, :]
    k_tail = kf * torch.exp(btot - b)
    s = torch.einsum("btk,btv->bkv", k_tail, vf)
    if initial_state is not None:
        s0 = initial_state.to(acc)
        s = s + torch.exp(btot[:, 0, :])[..., None] * s0
        o = o + torch.einsum("btk,bkv->btv", qf * torch.exp(b_q), s0)
    return o.to(v.dtype), s


def _chunks(x: Tensor, chunk: int) -> Tensor:
    """(BH, T, D) -> (N, BH, C, D) in fp32; T must be a chunk multiple
    (the Pallas functions' contract)."""
    bh, t, d = x.shape
    return x.float().reshape(bh, t // chunk, chunk, d).transpose(0, 1)


def _unchunk(xc: Tensor, dtype: torch.dtype) -> Tensor:
    n, bh, c, d = xc.shape
    return xc.transpose(0, 1).reshape(bh, n * c, d).to(dtype)


def _decay(g: Tensor, chunk: int, min_log_decay: float):
    """The inclusive within-chunk cumulative sum b of the clamped g, in
    chunks (N, BH, C, Dk), and the chunk totals btot (N, BH, 1, Dk)."""
    bcum = torch.cumsum(_chunks(g, chunk).clamp(min_log_decay, 0.0), dim=2)
    return bcum, bcum[:, :, -1:, :]


def chunked_fwd_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor, *,
                    u: Optional[Tensor] = None, chunk: int = 128,
                    exclusive: bool = False,
                    min_log_decay: float = MIN_LOG_DECAY
                    ) -> Tuple[Tensor, Tensor]:
    """B8's function (``_fwd_kernel``): per chunk, with b the clamped
    cumulative log-decay from the chunk start, o = (Q̂ K̂ᵀ ⊙ M) V + Q̂ S
    (+ the diagonal u bonus, exclusive), S ← exp(btot) ⊙ S + K_tailᵀ V.
    u: (Dk,), or (H, Dk) with row r reading u[r % H]. Returns (o in v's
    type, final state (BH, Dk, Dv) fp32)."""
    if exclusive and u is None:
        u = torch.zeros(q.shape[-1], dtype=torch.float32, device=q.device)
    heads = u.shape[0] if exclusive and u.ndim == 2 else 1
    split = lambda x: x.reshape(-1, heads, *x.shape[1:])   # noqa: E731
    o, s = chunked_gla(split(q), split(k), split(v), split(g),
                       chunk_size=chunk, exclusive=exclusive, u=u,
                       min_log_decay=min_log_decay)
    return o.flatten(0, 1), s.flatten(0, 1)


def chunked_bwd_dq_ref(k: Tensor, v: Tensor, g: Tensor, do: Tensor, *,
                       chunk: int = 128,
                       min_log_decay: float = MIN_LOG_DECAY) -> Tensor:
    """``_dq_kernel``: dq_i = exp(b) ⊙ [(dO_i V_iᵀ ⊙ M) K̂_i + dO_i S_iᵀ],
    S recomputed chunk by chunk. dq fp32 (BH, T, Dk)."""
    kc, vc, doc = (_chunks(x, chunk) for x in (k, v, do))
    bcum, btot = _decay(g, chunk, min_log_decay)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                 device=k.device))
    s = torch.zeros((kc.shape[1], kc.shape[-1], vc.shape[-1]),
                    dtype=torch.float32, device=k.device)
    dqs = []
    for k_i, v_i, do_i, b_i, bt_i in zip(kc, vc, doc, bcum, btot):
        k_hat = k_i * torch.exp(-b_i)
        k_tail = k_i * torch.exp(bt_i - b_i)
        vdo = torch.einsum("btv,bsv->bts", do_i, v_i) * mask
        dq = torch.einsum("bts,bsk->btk", vdo, k_hat)
        dq = dq + torch.einsum("btv,bkv->btk", do_i, s)
        dqs.append(dq * torch.exp(b_i))
        s = (torch.exp(bt_i).transpose(1, 2) * s
             + torch.einsum("bck,bcv->bkv", k_tail, v_i))
    return _unchunk(torch.stack(dqs), torch.float32)


def chunked_bwd_dkv_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                        do: Tensor, *, chunk: int = 128,
                        min_log_decay: float = MIN_LOG_DECAY
                        ) -> Tuple[Tensor, Tensor]:
    """``_dkv_kernel``, the reverse sweep over R (later chunks' q̂ doᵀ,
    decayed to the end of the chunk):
    dk = exp(−b) ⊙ (V dOᵀ ⊙ Mᵀ) Q̂ + exp(btot − b) ⊙ (V Rᵀ),
    dv = (K̂ Q̂ᵀ ⊙ Mᵀ) dO + K_tail R. Returns (dk fp32, dv in v's type)."""
    qc, kc, vc, doc = (_chunks(x, chunk) for x in (q, k, v, do))
    bcum, btot = _decay(g, chunk, min_log_decay)
    n = qc.shape[0]
    mask_rev = torch.triu(torch.ones((chunk, chunk), dtype=torch.float32,
                                     device=q.device))
    r = torch.zeros((qc.shape[1], qc.shape[-1], vc.shape[-1]),
                    dtype=torch.float32, device=q.device)
    dks, dvs = [None] * n, [None] * n
    for i in reversed(range(n)):
        q_i, k_i, v_i, do_i = qc[i], kc[i], vc[i], doc[i]
        b_i, bt_i = bcum[i], btot[i]
        q_hat = q_i * torch.exp(b_i)
        k_hat = k_i * torch.exp(-b_i)
        k_tail = k_i * torch.exp(bt_i - b_i)
        dov = torch.einsum("btv,bsv->bts", v_i, do_i) * mask_rev
        dk_intra = torch.einsum("bts,bsk->btk", dov, q_hat) * torch.exp(-b_i)
        dk_inter = torch.einsum("btv,bkv->btk", v_i, r) * torch.exp(
            bt_i - b_i)
        dks[i] = dk_intra + dk_inter
        scores = torch.einsum("btk,bsk->bts", k_hat, q_hat) * mask_rev
        dvs[i] = (torch.einsum("bts,bsv->btv", scores, do_i)
                  + torch.einsum("btk,bkv->btv", k_tail, r))
        r = (torch.exp(bt_i).transpose(1, 2) * r
             + torch.einsum("bck,bcv->bkv", q_hat, do_i))
    return (_unchunk(torch.stack(dks), torch.float32),
            _unchunk(torch.stack(dvs), v.dtype))


def dg_from_qdq(qdq: Tensor, k: Tensor, g: Tensor, dk: Tensor, *,
                min_log_decay: float = MIN_LOG_DECAY) -> Tensor:
    """dg = reverse-cumsum over T of (q⊙dq − k⊙dk), zero where the clamp
    held g away from its value; q⊙dq given in fp32, dk fp32. dg in g's
    type."""
    diff = qdq - k.float() * dk
    dg = torch.flip(torch.cumsum(torch.flip(diff, dims=(1,)), dim=1),
                    dims=(1,))
    g32 = g.float()
    return (dg * ((g32 >= min_log_decay) & (g32 <= 0.0))).to(g.dtype)


def dg_epilogue(q: Tensor, k: Tensor, g: Tensor, dq: Tensor, dk: Tensor, *,
                min_log_decay: float = MIN_LOG_DECAY) -> Tensor:
    """dg = reverse-cumsum over T of (q⊙dq − k⊙dk) (the GLA gradient
    identity), zero where the clamp held g away from its value. fp32 dq
    and dk; dg in g's type."""
    return dg_from_qdq(q.float() * dq, k, g, dk,
                       min_log_decay=min_log_decay)


def bwd_dq_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor, *,
               chunk: int = 128, min_log_decay: float = MIN_LOG_DECAY
               ) -> Tuple[Tensor, Tensor]:
    """What B9's dq launch returns: (dq in q's type, q⊙dq in fp32), from
    ``chunked_bwd_dq_ref``'s fp32 dq."""
    dq = chunked_bwd_dq_ref(k, v, g, do, chunk=chunk,
                            min_log_decay=min_log_decay)
    return dq.to(q.dtype), q.float() * dq


def bwd_dkv_dg_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor,
                   qdq: Tensor, *, chunk: int = 128,
                   min_log_decay: float = MIN_LOG_DECAY
                   ) -> Tuple[Tensor, Tensor, Tensor]:
    """What B9's dk/dv launch returns given the dq launch's q⊙dq: (dk in
    k's type, dv in v's type, dg in g's type), dg = reverse-cumsum(q⊙dq −
    k⊙dk) masked, from ``chunked_bwd_dkv_ref``'s fp32 dk."""
    dk, dv = chunked_bwd_dkv_ref(q, k, v, g, do, chunk=chunk,
                                 min_log_decay=min_log_decay)
    dg = dg_from_qdq(qdq, k, g, dk, min_log_decay=min_log_decay)
    return dk.to(k.dtype), dv, dg


def chunked_bwd_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor,
                    *, chunk: int = 128, min_log_decay: float = MIN_LOG_DECAY
                    ) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """B9's function (``kernel.bwd``, inclusive form): the forward sweep
    for dq (and q⊙dq), then the reverse sweep for dk, dv and dg.
    Returns (dq, dk, dv, dg) in q's, k's, v's and g's types."""
    dq, qdq = bwd_dq_ref(q, k, v, g, do, chunk=chunk,
                         min_log_decay=min_log_decay)
    dk, dv, dg = bwd_dkv_dg_ref(q, k, v, g, do, qdq, chunk=chunk,
                                min_log_decay=min_log_decay)
    return dq, dk, dv, dg


# ---------------------------------------------------------------------------
# The exclusive form's backward (RWKV-6: o_t = (S_{t-1} + diag(u) k_t v_tᵀ)ᵀ
# q_t). With G the cumulative clamped log-decay, o_t's decay part is
# Σ_{s<t} (q_t ⊙ e^{G_{t-1} − G_s} · k_s) v_s, so
#   dq_t = Σ_{s<t} (do_t·v_s) e^{G_{t-1}−G_s} ⊙ k_s + (do_t·v_t) u⊙k_t
#   dk_s = Σ_{t>s} (do_t·v_s) e^{G_{t-1}−G_s} ⊙ q_t + (do_s·v_s) u⊙q_s
#   dv_s = Σ_{t>s} (q_t·(e^{G_{t-1}−G_s} ⊙ k_s)) do_t + (q_s·(u⊙k_s)) do_s
#   du   = Σ_t (do_t·v_t) q_t⊙k_t, summed over each head's rows
# and the clamped g_r enters the pairs s < r < t: with q⊙dq and k⊙dk the
# decay's shares alone,
#   dg_r = Σ_{t>r} q⊙dq_t − Σ_{s≥r} k⊙dk_s
#        = reverse-cumsum(q⊙dq − k⊙dk)_r − q⊙dq_r
# (B9's identity less the token's own q⊙dq), zero where the clamp held g.
# ---------------------------------------------------------------------------

def _u_rows(u: Tensor, bh: int) -> Tensor:
    """The bonus of each row, (BH, 1, Dk) fp32: u (Dk,) for every row, or
    (H, Dk) with row r reading u[r % H]."""
    u = u.float()
    if u.ndim == 1:
        return u.expand(bh, -1)[:, None]
    return u[torch.arange(bh, device=u.device) % u.shape[0]][:, None]


def _head_sum(du_rows: Tensor, u: Tensor) -> Tensor:
    """du_rows (BH, Dk) summed over the rows of each head into u's shape."""
    if u.ndim == 1:
        return du_rows.sum(0)
    return du_rows.reshape(-1, *u.shape).sum(0)


def _exclusive_decay(g: Tensor, chunk: int, min_log_decay: float):
    """The clamped within-chunk cumulative log-decay b, b_{t-1} (0 at a
    chunk's first token: the exclusive query's scale, JAX's bcum − g) and
    the chunk totals, in chunks (N, BH, C, Dk)."""
    gc = _chunks(g, chunk).clamp(min_log_decay, 0.0)
    bcum = torch.cumsum(gc, dim=2)
    return bcum, bcum - gc, bcum[:, :, -1:, :]


def chunked_bwd_exclusive_dq_ref(k: Tensor, v: Tensor, g: Tensor,
                                 do: Tensor, *, chunk: int = 128,
                                 min_log_decay: float = MIN_LOG_DECAY
                                 ) -> Tensor:
    """The decay's share of dq, chunk by chunk: e^{b_{t-1}} ⊙
    [(dO Vᵀ ⊙ M_strict) K̂ + dO Sᵀ], S recomputed. fp32 (BH, T, Dk)."""
    kc, vc, doc = (_chunks(x, chunk) for x in (k, v, do))
    bcum, bprev, btot = _exclusive_decay(g, chunk, min_log_decay)
    mask = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32,
                                 device=k.device), diagonal=-1)
    s = torch.zeros((kc.shape[1], kc.shape[-1], vc.shape[-1]),
                    dtype=torch.float32, device=k.device)
    dqs = []
    for k_i, v_i, do_i, b_i, bp_i, bt_i in zip(kc, vc, doc, bcum, bprev,
                                               btot):
        k_hat = k_i * torch.exp(-b_i)
        vdo = torch.einsum("btv,bsv->bts", do_i, v_i) * mask
        dq = torch.einsum("bts,bsk->btk", vdo, k_hat)
        dq = dq + torch.einsum("btv,bkv->btk", do_i, s)
        dqs.append(dq * torch.exp(bp_i))
        s = (torch.exp(bt_i).transpose(1, 2) * s
             + torch.einsum("bck,bcv->bkv", k_i * torch.exp(bt_i - b_i), v_i))
    return _unchunk(torch.stack(dqs), torch.float32)


def chunked_bwd_exclusive_dkv_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                                  do: Tensor, *, chunk: int = 128,
                                  min_log_decay: float = MIN_LOG_DECAY
                                  ) -> Tuple[Tensor, Tensor]:
    """The decay's shares of dk and dv, the reverse sweep over R (later
    chunks' Q̂ doᵀ with Q̂ = q e^{b_{t-1}}, decayed to the chunk's end):
    dk = e^{−b} ⊙ (V dOᵀ ⊙ Mᵀ_strict) Q̂ + e^{btot − b} ⊙ (V Rᵀ),
    dv = (K̂ Q̂ᵀ ⊙ Mᵀ_strict) dO + K_tail R. Both fp32."""
    qc, kc, vc, doc = (_chunks(x, chunk) for x in (q, k, v, do))
    bcum, bprev, btot = _exclusive_decay(g, chunk, min_log_decay)
    n = qc.shape[0]
    mask_rev = torch.triu(torch.ones((chunk, chunk), dtype=torch.float32,
                                     device=q.device), diagonal=1)
    r = torch.zeros((qc.shape[1], qc.shape[-1], vc.shape[-1]),
                    dtype=torch.float32, device=q.device)
    dks, dvs = [None] * n, [None] * n
    for i in reversed(range(n)):
        q_i, k_i, v_i, do_i = qc[i], kc[i], vc[i], doc[i]
        b_i, bt_i = bcum[i], btot[i]
        q_hat = q_i * torch.exp(bprev[i])
        k_hat = k_i * torch.exp(-b_i)
        k_tail = k_i * torch.exp(bt_i - b_i)
        dov = torch.einsum("btv,bsv->bts", v_i, do_i) * mask_rev
        dks[i] = (torch.einsum("bts,bsk->btk", dov, q_hat) * torch.exp(-b_i)
                  + torch.einsum("btv,bkv->btk", v_i, r)
                  * torch.exp(bt_i - b_i))
        scores = torch.einsum("btk,bsk->bts", k_hat, q_hat) * mask_rev
        dvs[i] = (torch.einsum("bts,bsv->btv", scores, do_i)
                  + torch.einsum("btk,bkv->btv", k_tail, r))
        r = (torch.exp(bt_i).transpose(1, 2) * r
             + torch.einsum("bck,bcv->bkv", q_hat, do_i))
    return (_unchunk(torch.stack(dks), torch.float32),
            _unchunk(torch.stack(dvs), torch.float32))


def dg_exclusive(qdq: Tensor, kdk: Tensor, g: Tensor, *,
                 min_log_decay: float = MIN_LOG_DECAY) -> Tensor:
    """dg_r = Σ_{t>r} q⊙dq_t − Σ_{s≥r} k⊙dk_s from the decay's shares
    q⊙dq and k⊙dk (fp32), zero where the clamp held g; in g's type."""
    diff = qdq - kdk
    dg = torch.flip(torch.cumsum(torch.flip(diff, dims=(1,)), dim=1),
                    dims=(1,)) - qdq
    g32 = g.float()
    return (dg * ((g32 >= min_log_decay) & (g32 <= 0.0))).to(g.dtype)


def bwd_exclusive_dq_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                         do: Tensor, u: Tensor, *, chunk: int = 128,
                         min_log_decay: float = MIN_LOG_DECAY
                         ) -> Tuple[Tensor, Tensor, Tensor]:
    """What the exclusive backward's dq launch returns: (dq with its
    bonus (do·v) u⊙k, in q's type; the decay's share of q⊙dq, fp32;
    du_rows = Σ_t (do·v) q⊙k per row, (BH, Dk) fp32)."""
    dq = chunked_bwd_exclusive_dq_ref(k, v, g, do, chunk=chunk,
                                      min_log_decay=min_log_decay)
    qf, kf = q.float(), k.float()
    dov = (do.float() * v.float()).sum(-1, keepdim=True)
    u_rows = _u_rows(u, q.shape[0])
    return ((dq + dov * u_rows * kf).to(q.dtype), qf * dq,
            (dov * qf * kf).sum(1))


def bwd_exclusive_dkv_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                          do: Tensor, u: Tensor, qdq: Tensor, *,
                          chunk: int = 128,
                          min_log_decay: float = MIN_LOG_DECAY
                          ) -> Tuple[Tensor, Tensor, Tensor]:
    """What the exclusive backward's dk/dv launch returns given the dq
    launch's q⊙dq: (dk with its bonus (do·v) u⊙q, in k's type; dv with
    (q·(u⊙k)) do, in v's type; dg by ``dg_exclusive``, in g's type)."""
    dk, dv = chunked_bwd_exclusive_dkv_ref(q, k, v, g, do, chunk=chunk,
                                           min_log_decay=min_log_decay)
    qf, kf, dof = q.float(), k.float(), do.float()
    u_rows = _u_rows(u, q.shape[0])
    dov = (dof * v.float()).sum(-1, keepdim=True)
    quk = (qf * u_rows * kf).sum(-1, keepdim=True)
    dg = dg_exclusive(qdq, kf * dk, g, min_log_decay=min_log_decay)
    return ((dk + dov * u_rows * qf).to(k.dtype),
            (dv + quk * dof).to(v.dtype), dg)


def chunked_bwd_exclusive_ref(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                              do: Tensor, u: Tensor, *, chunk: int = 128,
                              min_log_decay: float = MIN_LOG_DECAY
                              ) -> Tuple[Tensor, Tensor, Tensor, Tensor,
                                         Tensor]:
    """The exclusive form's backward with the bonus u ((Dk,), or (H, Dk)
    with row r reading u[r % H]): (dq, dk, dv, dg, du) in q's, k's, v's
    and g's types, du fp32 in u's shape."""
    dq, qdq, du_rows = bwd_exclusive_dq_ref(q, k, v, g, do, u, chunk=chunk,
                                            min_log_decay=min_log_decay)
    dk, dv, dg = bwd_exclusive_dkv_ref(q, k, v, g, do, u, qdq, chunk=chunk,
                                       min_log_decay=min_log_decay)
    return dq, dk, dv, dg, _head_sum(du_rows, u)
