"""Causal softmax attention for the softmax backend (port of
``repro/models/xla_attention.py``).

- ``flash_attention``: training and prefill attention in the flat-head
  layout, K/V read by kv head. Its forward is the B10 kernel
  (``kernels/flash_attention``) for CUDA tensors and B10's plain version
  for CPU tensors or under ``kernel=False``. Under autograd it is a
  ``torch.autograd.Function``: the forward runs B10 with the log-sum-exp
  (``want_lse``) and keeps only (q, k, v, o, lse), O(T·D); the backward
  is JAX's ``_flash_bwd``, blockwise over the causally live (q-block,
  kv-block) pairs only, in plain PyTorch (JAX computes it in jnp: there
  is no Pallas backward to port).
- ``decode_attention``: one query per sequence against a KV cache, in
  plain PyTorch and fp32, as in JAX. This is the O(n)-per-token read the
  paper's linear mechanism replaces with an O(k²) state read.
- ``blocked_causal_attention`` and ``full_causal_attention``: JAX's
  plain forms, its test oracles (q in the (B, G, Hkv, T, D) layout).
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import ops as FA

Tensor = torch.Tensor

NEG_INF = -1e30


def _ceil_to(x: int, m: int) -> int:
    return -(-x // m) * m


def blocked_causal_attention(q: Tensor, k: Tensor, v: Tensor, *,
                             scale: Optional[float] = None,
                             q_block: int = 512, kv_block: int = 1024,
                             q_offset: Optional[int] = None,
                             kv_len=None) -> Tensor:
    """Causal softmax attention with GQA grouping, online over key
    blocks. q: (B, G, Hkv, T, D); k, v: (B, Hkv, S, D). Query i attends
    key j iff j ≤ i + q_offset (default S − T) and, with ``kv_len``,
    j < kv_len. Scores and sums in fp32; returns (B, G, Hkv, T, D) in v's
    type."""
    b, g, hkv, t, d = q.shape
    s = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    off = s - t if q_offset is None else q_offset
    bq, bkv = min(q_block, t), min(kv_block, s)
    t_pad, s_pad = _ceil_to(t, bq), _ceil_to(s, bkv)
    q = F.pad(q, (0, 0, 0, t_pad - t)).float() * scale
    k = F.pad(k, (0, 0, 0, s_pad - s)).float()
    v = F.pad(v, (0, 0, 0, s_pad - s)).float()
    valid_len = s if kv_len is None else kv_len
    out = []
    for iq in range(t_pad // bq):
        q_i = q[..., iq * bq:(iq + 1) * bq, :]
        m = torch.full((b, g, hkv, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, g, hkv, bq, 1), device=q.device)
        acc = torch.zeros((b, g, hkv, bq, d), device=q.device)
        rows = iq * bq + torch.arange(bq, device=q.device)[:, None] + off
        for jk in range(s_pad // bkv):
            k_j = k[:, :, jk * bkv:(jk + 1) * bkv]
            v_j = v[:, :, jk * bkv:(jk + 1) * bkv]
            scores = torch.einsum("bghtd,bhsd->bghts", q_i, k_j)
            cols = jk * bkv + torch.arange(bkv, device=q.device)[None, :]
            ok = (rows >= cols) & (cols < valid_len)
            scores = torch.where(ok, scores, NEG_INF)
            m_n = torch.maximum(m, scores.amax(-1, keepdim=True))
            p = torch.exp(scores - m_n)
            alpha = torch.exp(m - m_n)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bghts,bhsd->bghtd", p, v_j)
            m = m_n
        l = torch.where(l == 0.0, 1.0, l)
        out.append(acc / l)
    return torch.cat(out, dim=3)[..., :t, :].to(v.dtype)


def full_causal_attention(q: Tensor, k: Tensor, v: Tensor, *,
                          scale: Optional[float] = None,
                          q_offset: Optional[int] = None) -> Tensor:
    """The unblocked form (the (T, S) scores at once), the oracle of
    ``blocked_causal_attention``. Same layout and mask (NEG_INF)."""
    t, d = q.shape[3], q.shape[4]
    s = k.shape[2]
    if scale is None:
        scale = d ** -0.5
    off = s - t if q_offset is None else q_offset
    scores = torch.einsum("bghtd,bhsd->bghts", q.float() * scale, k.float())
    rows = torch.arange(t, device=q.device)[:, None] + off
    cols = torch.arange(s, device=q.device)[None, :]
    scores = torch.where(rows >= cols, scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bghts,bhsd->bghtd", p, v.float()).to(v.dtype)


def _causal_pairs(nq: int, nkv: int, block: int, off: int) -> np.ndarray:
    """(q-block, kv-block) pairs with any unmasked entry, in JAX's order:
    fully masked future blocks are never visited."""
    pairs = [(i, j) for i in range(nq) for j in range(nkv)
             if j * block <= i * block + block - 1 + off]
    return np.asarray(pairs, dtype=np.int64).reshape(-1, 2)


def _block_mask(i: int, j: int, block: int, off: int, s_real: int,
                device) -> Tensor:
    r = torch.arange(block, device=device)
    rows = i * block + r[:, None] + off
    cols = j * block + r[None, :]
    return (rows >= cols) & (cols < s_real)


def _flash_bwd(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
               do: Tensor, *, scale: float, block: int, off: int):
    """JAX's ``_flash_bwd`` in plain PyTorch. q, o, do: (B, H, T, D); k, v:
    (B, Hkv, S, D), q head h reading kv head h mod Hkv; lse (B, H, T)
    fp32. Blocks of ``block`` queries and keys (the padded T and S),
    only the causal pairs, in JAX's order; products of the input type's
    values accumulated in fp32 (JAX's preferred_element_type), q scaled
    in its own type, ds cast to k's type before the dq and dk products
    and p to do's type before dv. K/V are broadcast to the flat heads,
    and dk, dv summed over the G query groups in fp32 before the cast.
    Returns (dq, dk, dv) in q's, k's and v's types."""
    b, h, t, d = q.shape
    hkv, s = k.shape[1], k.shape[2]
    g = h // hkv
    bq = min(block, t)
    t_pad, s_pad = _ceil_to(t, bq), _ceil_to(s, bq)

    def flat(x):                     # (B, Hkv, S, D) → padded (B, H, S, D)
        x = x[:, None].expand(b, g, hkv, s, d).reshape(b, h, s, d)
        return F.pad(x, (0, 0, 0, s_pad - s))

    qp, dop = (F.pad(x, (0, 0, 0, t_pad - t)) for x in (q, do))
    kp, vp = flat(k), flat(v)
    delta = (do.float() * o.float()).sum(-1)
    lsep, deltap = (F.pad(x, (0, t_pad - t)) for x in (lse.float(), delta))
    q_scale = torch.tensor(scale, dtype=q.dtype, device=q.device)
    dq = torch.zeros((b, h, t_pad, d), dtype=torch.float32, device=q.device)
    dk = torch.zeros((b, h, s_pad, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for i, j in _causal_pairs(t_pad // bq, s_pad // bq, bq, off).tolist():
        qs, ks = slice(i * bq, (i + 1) * bq), slice(j * bq, (j + 1) * bq)
        q_i, do_i = qp[:, :, qs], dop[:, :, qs]
        k_j, v_j = kp[:, :, ks], vp[:, :, ks]
        scores = (q_i * q_scale).float() @ k_j.float().transpose(-1, -2)
        ok = _block_mask(i, j, bq, off, s, q.device)
        p = torch.where(ok, torch.exp(scores - lsep[:, :, qs, None]), 0.0)
        dp = do_i.float() @ v_j.float().transpose(-1, -2)
        ds = (p * (dp - deltap[:, :, qs, None]) * scale).to(k.dtype).float()
        dq[:, :, qs] += ds @ k_j.float()
        dk[:, :, ks] += ds.transpose(-1, -2) @ q_i.float()
        dv[:, :, ks] += (p.to(do.dtype).float().transpose(-1, -2)
                         @ do_i.float())
    dk, dv = (x[:, :, :s].reshape(b, g, hkv, s, d).sum(1) for x in (dk, dv))
    return (dq[:, :, :t].to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


class _FlashAttention(torch.autograd.Function):
    """B10 (with the log-sum-exp) forward, JAX's blockwise backward."""

    @staticmethod
    def forward(ctx, q, k, v, scale, q_offset, block, kernel):
        o, lse = FA.flash_attention(q, k, v, scale=scale, t_off=q_offset,
                                    kernel=kernel, want_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.scale = q.shape[-1] ** -0.5 if scale is None else scale
        ctx.off = k.shape[2] - q.shape[2] if q_offset is None else q_offset
        ctx.block = block
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, scale=ctx.scale,
                                block=ctx.block, off=ctx.off)
        return dq, dk, dv, None, None, None, None


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    scale: Optional[float] = None,
                    q_offset: Optional[int] = None, *, block: int = 512,
                    kernel: bool = True) -> Tensor:
    """Causal attention for training and prefill. q: (B, H, T, D); k, v:
    (B, Hkv, S, D) with H % Hkv == 0, q head h = g·Hkv + j reading kv
    head j (the port's (G, Hkv) flattening; no broadcast copy of K/V,
    where JAX's model broadcasts them to the flat head dim first). Query
    i attends key j iff j ≤ i + q_offset (default S − T: the queries are
    the last T of the S keys). B10 on CUDA tensors, its plain version on
    CPU tensors or under ``kernel=False``. Returns (B, H, T, D) in v's
    type.

    When autograd needs a gradient through it, the forward also keeps
    B10's log-sum-exp and the backward runs JAX's ``_flash_bwd`` over
    blocks of ``block`` (the model passes ``cfg.attn_block_q``). Without
    one, B10 runs as in prefill, with no lse."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        return _FlashAttention.apply(q, k, v, scale, q_offset, block, kernel)
    return FA.flash_attention(q, k, v, scale=scale, t_off=q_offset,
                              kernel=kernel)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_len: Union[int, Tensor], *,
                     scale: Optional[float] = None,
                     partial_sum=None) -> Tensor:
    """Single-token decode against a KV cache. q: (B, G, Hkv, D);
    k_cache, v_cache: (B, Hkv, S, D); cache_len: () number of valid cache
    entries, or (B,) per-sequence lengths. Scores, softmax and the
    product in fp32; returns (B, G, Hkv, D) in v_cache's type.
    ``partial_sum``: completes the scores in place when q and the cache
    hold one block of the head dim (a sum over the blocks)."""
    b, d = q.shape[0], q.shape[-1]
    s = k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bghd,bhsd->bghs", q.float() * scale,
                          k_cache.float())
    if partial_sum is not None:
        partial_sum(scores)
    cl = torch.as_tensor(cache_len, device=q.device).expand(b)
    valid = torch.arange(s, device=q.device)[None, :] < cl[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bghs,bhsd->bghd", p,
                        v_cache.float()).to(v_cache.dtype)
