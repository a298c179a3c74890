"""Plain PyTorch versions of the fast-lookup kernels (port of
``repro/kernels/lookup/ref.py``). The CPU path of ``ops.py`` and the
reference the CUDA kernels are held against on the card."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.linear_attention import safe_denom

Tensor = torch.Tensor


def mass_lookup_ref(c: Tensor, q: Tensor, z: Optional[Tensor] = None,
                    eps: float = 1e-6) -> Tensor:
    """R = C q for m queries. c: (N,K,K); q: (N,M,K) -> (N,M,K)."""
    qf = q.float()
    out = torch.einsum("nkl,nml->nmk", c.float(), qf)
    if z is not None:
        denom = torch.einsum("nk,nmk->nm", z.float(), qf)
        out = out / safe_denom(denom, eps)[..., None]
    return out.to(q.dtype)


def mass_lookup_indexed_ref(store: Tensor, rows: Tensor, q: Tensor,
                            z: Optional[Tensor] = None,
                            eps: float = 1e-6) -> Tensor:
    """Heterogeneous wave: row i answers its queries against
    ``store[rows[i]]``. store: (N,K,K); rows: (B,); q: (B,M,K) ->
    (B,M,K). ``z``: (N,K) optional key-sum normalisers, gathered by the
    same rows."""
    idx = rows.long()
    qf = q.float()
    out = torch.einsum("bkl,bml->bmk", store[idx].float(), qf)
    if z is not None:
        denom = torch.einsum("bk,bmk->bm", z[idx].float(), qf)
        out = out / safe_denom(denom, eps)[..., None]
    return out.to(q.dtype)


def decode_ref(s: Tensor, q: Tensor, k: Tensor, v: Tensor
               ) -> Tuple[Tensor, Tensor]:
    """Fused decode: S += k vᵀ; o = Sᵀ q. s: (N,Dk,Dv); q, k: (N,Dk);
    v: (N,Dv). Returns (o in v's type, the new state in s's type); ``s``
    itself is not written. The outer product is an elementwise product,
    one rounding per entry, as the CUDA kernel computes it."""
    sf = s.float() + k.float()[:, :, None] * v.float()[:, None, :]
    o = torch.einsum("nkv,nk->nv", sf, q.float())
    return o.to(v.dtype), sf.to(s.dtype)
