"""Plain PyTorch versions of the chunked linear-attention kernels (port of
``repro/kernels/linear_attention/ref.py``, plus the plain forms of the
two Pallas functions of ``repro/kernels/linear_attention/kernel.py``).

All functions take flat (BH, T, D) rows, accumulate in float32 and
return outputs in their inputs' types:

- ``linear_attention_ref`` / ``linear_attention_grads_ref``: the
  quadratic direct form and its closed-form gradients (the oracles);
- ``chunked_fwd_ref``: what B2 (``kernel.fwd``) emits, o and the final
  fp32 state, chunk by chunk from a zero state, no normaliser (the
  core's ``causal_linear_attention_chunked`` on flat rows);
- ``chunked_bwd_ref``: the paper's §3.3 recompute backward, a port of
  ``_cla_bwd`` (``repro/core/linear_attention.py:276-354``): a forward
  sweep over S = Σ k vᵀ for dq (``chunked_bwd_dq_ref``), a reverse sweep
  over R = Σ q doᵀ for dk and dv (``chunked_bwd_dkv_ref``). It reads
  only q, k, v and do.

The CUDA kernels (``csrc/linear_attention.cu``) are held against the
chunked forms; the model's training path runs them for CPU tensors and
when the plain route is asked for explicitly.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.linear_attention import causal_linear_attention_chunked

Tensor = torch.Tensor


def _acc(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def linear_attention_ref(
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    initial_state: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """Causal linear attention, quadratic-time direct form.

    q, k: (BH, T, Dk); v: (BH, T, Dv). Returns (o: (BH, T, Dv) in v's
    type, s: (BH, Dk, Dv) fp32): o_t = Σ_{s≤t} (q_t·k_s) v_s (+ q_t S₀);
    S = S₀ + Σ_t k_t v_tᵀ.
    """
    t = q.shape[1]
    acc = _acc(q.dtype)
    qf, kf, vf = q.to(acc), k.to(acc), v.to(acc)
    mask = torch.tril(torch.ones((t, t), dtype=acc, device=q.device))
    scores = torch.einsum("btk,bsk->bts", qf, kf) * mask
    o = torch.einsum("bts,bsv->btv", scores, vf)
    s = torch.einsum("btk,btv->bkv", kf, vf)
    if initial_state is not None:
        s0 = initial_state.to(acc)
        o = o + torch.einsum("btk,bkv->btv", qf, s0)
        s = s0 + s
    return o.to(v.dtype), s


def linear_attention_grads_ref(q: Tensor, k: Tensor, v: Tensor, do: Tensor
                               ) -> Tuple[Tensor, Tensor, Tensor]:
    """Closed-form gradients of ``linear_attention_ref``'s o (paper §3.3
    generalised): (dq, dk, dv) in q's, k's and v's types."""
    t = q.shape[1]
    acc = _acc(q.dtype)
    qf, kf, vf, dof = (x.to(acc) for x in (q, k, v, do))
    mask = torch.tril(torch.ones((t, t), dtype=acc, device=q.device))
    mask_rev = torch.triu(torch.ones((t, t), dtype=acc, device=q.device))
    vdo = torch.einsum("bsv,btv->bts", vf, dof) * mask
    dq = torch.einsum("bts,bsk->btk", vdo, kf)
    dov = torch.einsum("bsv,btv->bts", dof, vf) * mask_rev
    dk = torch.einsum("bts,bsk->btk", dov, qf)
    qk = torch.einsum("bsk,btk->bts", qf, kf) * mask_rev
    dv = torch.einsum("bts,bsv->btv", qk, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _chunks(x: Tensor, chunk: int, acc: torch.dtype) -> Tensor:
    """(BH, T, D) -> (N, BH, C, D) in ``acc``, T zero-padded to a chunk
    multiple (padded rows add nothing to a state; their outputs are
    sliced off)."""
    bh, t, d = x.shape
    t_pad = -(-t // chunk) * chunk
    if t_pad != t:
        x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
    return x.to(acc).reshape(bh, t_pad // chunk, chunk, d).transpose(0, 1)


def _unchunk(xc: Tensor, t: int, dtype: torch.dtype) -> Tensor:
    n, bh, c, d = xc.shape
    return xc.transpose(0, 1).reshape(bh, n * c, d)[:, :t].to(dtype)


def chunked_fwd_ref(q: Tensor, k: Tensor, v: Tensor, *, chunk: int = 128
                    ) -> Tuple[Tensor, Tensor]:
    """B2's function: per chunk i, o_i = Q_i S_i + (Q_i K_iᵀ ⊙ M) V_i and
    S_{i+1} = S_i + K_iᵀ V_i from S_0 = 0 — the core's chunked form on
    flat rows. q, k: (BH, T, Dk); v: (BH, T, Dv). Returns (o in v's type,
    final state (BH, Dk, Dv) fp32)."""
    o, s = causal_linear_attention_chunked(q[:, None], k[:, None],
                                           v[:, None], chunk_size=chunk)
    return o[:, 0], s[:, 0]


def chunked_bwd_dq_ref(k: Tensor, v: Tensor, do: Tensor, *,
                       chunk: int = 128) -> Tensor:
    """B3's forward sweep: dq_i = (dO_i V_iᵀ ⊙ M) K_i + dO_i S_iᵀ with
    S_i = Σ_{j<i} K_jᵀ V_j recomputed chunk by chunk. dq in k's type (the
    kernels take q, k, v and do of one type)."""
    t = k.shape[1]
    c = min(chunk, t)
    acc = _acc(k.dtype)
    kc, vc, doc = (_chunks(x, c, acc) for x in (k, v, do))
    bh, dk_dim, dv_dim = kc.shape[1], kc.shape[-1], vc.shape[-1]
    mask = torch.tril(torch.ones((c, c), dtype=acc, device=k.device))
    s = torch.zeros((bh, dk_dim, dv_dim), dtype=acc, device=k.device)
    dqs = []
    for k_i, v_i, do_i in zip(kc, vc, doc):
        vdo = torch.einsum("bsv,bcv->bcs", v_i, do_i) * mask
        dqs.append(torch.einsum("bcs,bsk->bck", vdo, k_i)
                   + torch.einsum("bkv,bcv->bck", s, do_i))
        s = s + torch.einsum("bck,bcv->bkv", k_i, v_i)
    return _unchunk(torch.stack(dqs), t, k.dtype)


def chunked_bwd_dkv_ref(q: Tensor, k: Tensor, v: Tensor, do: Tensor, *,
                        chunk: int = 128) -> Tuple[Tensor, Tensor]:
    """B3's reverse sweep: dk_i = (V_i dO_iᵀ ⊙ Mᵀ) Q_i + V_i R_iᵀ and
    dv_i = (K_i Q_iᵀ ⊙ Mᵀ) dO_i + K_i R_i with R_i = Σ_{j>i} Q_jᵀ dO_j
    recomputed from the last chunk back. (dk, dv) in k's and v's types."""
    t = q.shape[1]
    c = min(chunk, t)
    acc = _acc(q.dtype)
    qc, kc, vc, doc = (_chunks(x, c, acc) for x in (q, k, v, do))
    n, bh, _, dk_dim = qc.shape
    dv_dim = vc.shape[-1]
    mask_rev = torch.triu(torch.ones((c, c), dtype=acc, device=q.device))
    r = torch.zeros((bh, dk_dim, dv_dim), dtype=acc, device=q.device)
    dks, dvs = [None] * n, [None] * n
    for i in reversed(range(n)):
        dov = torch.einsum("bsv,btv->bts", doc[i], vc[i]) * mask_rev
        dks[i] = (torch.einsum("bts,bsk->btk", dov, qc[i])
                  + torch.einsum("bkv,btv->btk", r, vc[i]))
        qk = torch.einsum("bsk,btk->bts", qc[i], kc[i]) * mask_rev
        dvs[i] = (torch.einsum("bts,bsv->btv", qk, doc[i])
                  + torch.einsum("bkv,btk->btv", r, kc[i]))
        r = r + torch.einsum("bck,bcv->bkv", qc[i], doc[i])
    return (_unchunk(torch.stack(dks), t, k.dtype),
            _unchunk(torch.stack(dvs), t, v.dtype))


def chunked_bwd_ref(q: Tensor, k: Tensor, v: Tensor, do: Tensor, *,
                    chunk: int = 128) -> Tuple[Tensor, Tensor, Tensor]:
    """The §3.3 recompute backward of ``chunked_fwd_ref``'s o (B3's
    function): the forward sweep for dq, the reverse sweep for dk and
    dv. Returns (dq, dk, dv) in q's, k's and v's types."""
    dq = chunked_bwd_dq_ref(k, v, do, chunk=chunk).to(q.dtype)
    return (dq, *chunked_bwd_dkv_ref(q, k, v, do, chunk=chunk))
