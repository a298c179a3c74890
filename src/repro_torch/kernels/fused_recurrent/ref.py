"""Plain PyTorch versions of the fused W-step decodes (port of
``repro/kernels/fused_recurrent/ref.py``).

W sequential single-token ``decode_step`` (linear) or
``gated_decode_step`` (gated) calls. With ``lens``, window step w of a
row with ``w >= lens`` keeps that row's state (and normaliser) bit for
bit and emits a zero output — the masked select wraps the identical
single-step computation, so a masked gated step neither decays nor
updates. These are the oracles the CUDA kernels are held against, and
the model's ``decode_kernel="reference"`` path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.gated import gated_decode_step
from repro_torch.core.linear_attention import decode_step

Tensor = torch.Tensor


def fused_recurrent_linear_ref(
    s: Tensor,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    *,
    z: Optional[Tensor] = None,
    normalize: bool = False,
    eps: float = 1e-6,
    lens: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor, Optional[Tensor]]:
    """s: (B, H, Dk, Dv); q, k: (B, H, W, Dk); v: (B, H, W, Dv);
    z: (B, H, Dk) or None; lens: (B,) per-row valid lengths or None.
    Returns new tensors (o: (B, H, W, Dv), s_new, z_new); the inputs are
    not modified."""
    outs = []
    for w in range(q.shape[2]):
        o, s_n, z_n = decode_step(s, q[:, :, w], k[:, :, w], v[:, :, w],
                                  z=z, normalize=normalize, eps=eps)
        if lens is not None:
            valid = (w < lens.to(torch.int32))[:, None]          # (B, 1)
            s_n = torch.where(valid[..., None, None], s_n, s)
            if z_n is not None:
                z_n = torch.where(valid[..., None], z_n, z)
            o = torch.where(valid[..., None], o, 0.0).to(o.dtype)
        s, z = s_n, z_n
        outs.append(o)
    return torch.stack(outs, dim=2), s, z


def fused_recurrent_gated_ref(
    s: Tensor,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    g: Tensor,
    *,
    lens: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """s: (B, H, Dk, Dv); q, k, g: (B, H, W, Dk); v: (B, H, W, Dv); g the
    log-decay (the state is scaled by exp(g) each step, no clamp);
    lens: (B,) per-row valid lengths or None. Returns new tensors
    (o: (B, H, W, Dv), s_new); the inputs are not modified."""
    if lens is None and q.shape[2] == 1:
        o, s_f = gated_decode_step(s, q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                   g[:, :, 0])
        return o[:, :, None], s_f
    outs = []
    for w in range(q.shape[2]):
        o, s_n = gated_decode_step(s, q[:, :, w], k[:, :, w], v[:, :, w],
                                   g[:, :, w])
        if lens is not None:
            valid = (w < lens.to(torch.int32))[:, None]          # (B, 1)
            s_n = torch.where(valid[..., None, None], s_n, s)
            o = torch.where(valid[..., None], o, 0.0).to(o.dtype)
        s = s_n
        outs.append(o)
    return torch.stack(outs, dim=2), s
