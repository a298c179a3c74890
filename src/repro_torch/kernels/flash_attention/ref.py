"""Plain PyTorch versions of the causal flash-attention forward (port of
``repro/kernels/flash_attention/ref.py``, plus the plain form of the
Pallas ``fwd`` of ``repro/kernels/flash_attention/kernel.py``).

- ``flash_attention_fwd_ref``: B10's function on flat rows, in fp32,
  with the Pallas body's mask and its NEG_INF, K/V rows read by kv head.
  The CUDA kernel (``csrc/flash_attention.cu``) is held against it; the
  model runs it for CPU tensors and when the plain route is asked for
  explicitly.
- ``flash_attention_ref``: the JAX package's oracle as it is (causal
  with the queries the last T of the S keys, −inf masking, the
  probabilities cast to v's type before the product).
"""

from __future__ import annotations

from typing import Optional

import torch

Tensor = torch.Tensor

NEG_INF = -1e30          # the Pallas body's mask value (kernel.py:19)


def flash_attention_fwd_ref(q: Tensor, k: Tensor, v: Tensor, *,
                            scale: float, t_off: int, s_real: int,
                            kv_heads: Optional[int] = None,
                            want_lse: bool = False):
    """q: (B·H, T, D); k, v: (B·Hkv, S, D), q row b·H + h reading kv row
    b·Hkv + h mod Hkv (``kv_heads`` = Hkv; without it the rows are one to
    one). K and V are broadcast to the q rows here, as JAX's model
    broadcasts them before its flash. Query i attends key j iff
    j ≤ i + t_off and j < s_real. Scores q·k·scale, softmax and the
    product in fp32; the output in v's type. With ``want_lse`` returns
    (o, lse), lse (B·H, T) the fp32 log-sum-exp of each row's masked
    scores.

    Masked scores are NEG_INF, not −inf, as in the Pallas body. A row
    that sees some key gives exactly the masked softmax. A row that sees
    none gets the mean of v over all S keys, which is what the Pallas
    grid gives, since it visits every key tile (its l is the count of
    keys, not 0). The wrappers never produce such a row."""
    t, s = q.shape[1], k.shape[1]
    if kv_heads is not None and k.shape[0] != q.shape[0]:
        b = k.shape[0] // kv_heads
        g = q.shape[0] // (b * kv_heads)
        k, v = (x.reshape(b, 1, kv_heads, s, x.shape[2]).expand(
            b, g, kv_heads, s, x.shape[2]).reshape(q.shape[0], s, x.shape[2])
            for x in (k, v))
    scores = torch.einsum("btd,bsd->bts", q.float(), k.float()) * scale
    rows = torch.arange(t, device=q.device)[:, None] + t_off
    cols = torch.arange(s, device=q.device)[None, :]
    scores = torch.where((cols <= rows) & (cols < s_real), scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bts,bsd->btd", p, v.float()).to(v.dtype)
    return (o, torch.logsumexp(scores, dim=-1)) if want_lse else o


def flash_attention_ref(q: Tensor, k: Tensor, v: Tensor, *,
                        scale: Optional[float] = None) -> Tensor:
    """Causal softmax attention, JAX's oracle. q: (BH, T, D); k, v:
    (BH, S, D), T ≤ S, the queries the last T positions. Rows with no
    visible key (none when T ≤ S) would be NaN, as in JAX."""
    t, s = q.shape[1], k.shape[1]
    if scale is None:
        scale = q.shape[-1] ** -0.5
    scores = torch.einsum("btd,bsd->bts", q, k).float() * scale
    causal = torch.ones((t, s), dtype=torch.bool,
                        device=q.device).tril(diagonal=s - t)
    scores = torch.where(causal, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bts,bsd->btd", probs.to(v.dtype), v)
