"""Wrappers for the fused W-step linear decode (port of
``repro/kernels/fused_recurrent/ops.py``).

``decode_linear`` takes flat (N, …) rows and launches the CUDA kernel
``csrc/decode_linear.cu`` for CUDA tensors; for CPU tensors it runs the
plain PyTorch version (``ref.py``). There is no other route: a CUDA
tensor the kernel does not take raises. Either way ``s`` and ``z`` are
updated in place and returned.

``fused_recurrent_linear`` adds the (B, H, …) ↔ (B·H, …) reshapes and
broadcasts a per-batch ``lens`` over heads, as the JAX wrapper does.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.kernels.fused_recurrent.ref import fused_recurrent_linear_ref

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_linear.cu"
HEAD_DIMS = (16, 128)            # qwen3-0.6b smoke and full widths
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load_library(SOURCE)
    fn = lib.decode_linear
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check(s, q, k, v, z, normalize, lens) -> None:
    n, dk, dv = s.shape
    w = q.shape[1]
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"decode_linear: Dk=Dv in {HEAD_DIMS} only, got "
                         f"state {tuple(s.shape)}")
    if s.dtype != torch.float32:
        raise TypeError(f"decode_linear: state must be float32, got {s.dtype}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("decode_linear: q, k, v must share one type of "
                        f"{list(_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    want = {"q": (n, w, dk), "k": (n, w, dk), "v": (n, w, dv)}
    for name, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"decode_linear: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    tensors = [("s", s), ("q", q), ("k", k), ("v", v)]
    if normalize:
        if z.dtype != torch.float32 or tuple(z.shape) != (n, dk):
            raise ValueError(f"decode_linear: z must be float32 of shape "
                             f"{(n, dk)}, got {z.dtype} {tuple(z.shape)}")
        tensors.append(("z", z))
    if lens is not None:
        if lens.dtype != torch.int32 or tuple(lens.shape) != (n,):
            raise ValueError(f"decode_linear: lens must be int32 of shape "
                             f"{(n,)}, got {lens.dtype} {tuple(lens.shape)}")
        tensors.append(("lens", lens))
    for name, t in tensors:
        if t.device != s.device:
            raise ValueError(f"decode_linear: {name} is on {t.device}, "
                             f"the state on {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"decode_linear: {name} must be contiguous")


def decode_linear(
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
    """W fused decode steps over N flat rows.

    s: (N, Dk, Dv) fp32; q, k: (N, W, Dk); v: (N, W, Dv); z: (N, Dk) fp32
    (with ``normalize``); lens: (N,) int32 or None. Returns
    (o: (N, W, Dv) in v's type, s, z) with s and z updated in place;
    z is None without ``normalize``.
    """
    if normalize and z is None:
        raise ValueError("normalize=True needs the key-sum normaliser z")
    if s.device.type == "cpu":
        o, s_new, z_new = fused_recurrent_linear_ref(
            s[:, None], q[:, None], k[:, None], v[:, None],
            z=None if z is None else z[:, None], normalize=normalize,
            eps=eps, lens=lens)
        s.copy_(s_new[:, 0])
        if normalize:
            z.copy_(z_new[:, 0])
        return o[:, 0], s, z if normalize else None
    if s.device.type != "cuda":
        raise ValueError(f"decode_linear: no kernel for {s.device}")
    _check(s, q, k, v, z, normalize, lens)
    n, dk, _ = s.shape
    w = q.shape[1]
    o = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if n == 0 or w == 0:
        return o, s, z if normalize else None
    lib = load()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.decode_linear(
            s.data_ptr(), z.data_ptr() if normalize else None,
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            None if lens is None else lens.data_ptr(),
            n, w, dk, _DTYPES[q.dtype], int(normalize), eps, stream)
    if err:
        raise RuntimeError(f"decode_linear: kernel launch failed with CUDA "
                           f"error {err}")
    decode_linear.launches += 1
    return o, s, z if normalize else None


decode_linear.launches = 0


def fused_recurrent_linear(
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
    """W fused decode steps, plain linear recurrence.

    s: (B, H, Dk, Dv) fp32, contiguous; q, k: (B, H, W, Dk);
    v: (B, H, W, Dv); z: (B, H, Dk) fp32 or None; lens: (B,) per-row
    valid lengths or None. Returns (o: (B, H, W, Dv), s, z) with s and z
    updated in place — one kernel launch and one state round trip for
    the whole window on CUDA.
    """
    b, h, w, dk = q.shape
    dv = v.shape[-1]
    lens_bh = None
    if lens is not None:
        lens_bh = (lens.to(device=s.device, dtype=torch.int32)[:, None]
                   .expand(b, h).reshape(b * h))
    o, _, _ = decode_linear(
        s.view(b * h, dk, dv),
        q.reshape(b * h, w, dk).contiguous(),
        k.reshape(b * h, w, dk).contiguous(),
        v.reshape(b * h, w, dv).contiguous(),
        z=None if z is None else z.view(b * h, dk),
        normalize=normalize, eps=eps, lens=lens_bh)
    return o.view(b, h, w, dv), s, z if normalize else None
