"""Causal softmax attention for the softmax backend (port of
``repro/models/xla_attention.py``, the two functions its model calls).

- ``flash_attention``: prefill attention in the flat-head layout, K/V
  read by kv head, through the B10 kernel (``kernels/flash_attention``)
  for CUDA tensors.
  JAX computes the same function with its jnp pair-list flash forward;
  its custom VJP (``_flash_bwd``) is not ported, so this one is forward
  only.
- ``decode_attention``: one query per sequence against a KV cache, in
  plain PyTorch and fp32, as in JAX. This is the O(n)-per-token read the
  paper's linear mechanism replaces with an O(k²) state read.

JAX's ``blocked_causal_attention`` and ``full_causal_attention`` (test
oracles there) are not ported.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels.flash_attention import ops as FA

Tensor = torch.Tensor

NEG_INF = -1e30


def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                    scale: Optional[float] = None,
                    q_offset: Optional[int] = None, *,
                    kernel: bool = True) -> Tensor:
    """Causal attention for prefill. q: (B, H, T, D); k, v: (B, Hkv, S, D)
    with H % Hkv == 0, q head h = g·Hkv + j reading kv head j (the
    port's (G, Hkv) flattening; no broadcast copy of K/V, where JAX's
    model broadcasts them to the flat head dim first). Query i attends
    key j iff j ≤ i + q_offset (default S − T: the queries are the last
    T of the S keys). B10 on CUDA tensors, its plain version on
    CPU tensors or under ``kernel=False``. Returns (B, H, T, D) in v's
    type. Raises NotImplementedError when autograd would need a gradient
    through it: the softmax backward is not ported."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise NotImplementedError(
            "flash_attention is forward only: the softmax backward (JAX's "
            "_flash_bwd) is not ported")
    return FA.flash_attention(q, k, v, scale=scale, t_off=q_offset,
                              kernel=kernel)


def decode_attention(q: Tensor, k_cache: Tensor, v_cache: Tensor,
                     cache_len: Union[int, Tensor], *,
                     scale: Optional[float] = None) -> Tensor:
    """Single-token decode against a KV cache. q: (B, G, Hkv, D);
    k_cache, v_cache: (B, Hkv, S, D); cache_len: () number of valid cache
    entries, or (B,) per-sequence lengths. Scores, softmax and the
    product in fp32; returns (B, G, Hkv, D) in v_cache's type."""
    b, d = q.shape[0], q.shape[-1]
    s = k_cache.shape[2]
    if scale is None:
        scale = d ** -0.5
    scores = torch.einsum("bghd,bhsd->bghs", q.float() * scale,
                          k_cache.float())
    cl = torch.as_tensor(cache_len, device=q.device).expand(b)
    valid = torch.arange(s, device=q.device)[None, :] < cl[:, None]
    scores = torch.where(valid[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bghs,bhsd->bghd", p,
                        v_cache.float()).to(v_cache.dtype)
