"""Plain PyTorch version of the fused W-step linear decode (port of
``repro/kernels/fused_recurrent/ref.py``).

W sequential single-token ``decode_step`` calls. With ``lens``, window
step w of a row with ``w >= lens`` keeps that row's state (and
normaliser) bit for bit and emits a zero output — the masked select
wraps the identical ``decode_step`` computation. This is the oracle the
CUDA kernel is held against, and the model's ``decode_kernel=
"reference"`` path.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

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
