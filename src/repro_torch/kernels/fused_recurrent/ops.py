"""Wrappers for the fused W-step decodes (port of
``repro/kernels/fused_recurrent/ops.py``).

``decode_linear`` (B1) and ``decode_gated`` (B7) take flat (N, …) rows
and launch their CUDA kernels, ``csrc/decode_linear.cu`` and
``csrc/decode_gated.cu``, for CUDA tensors; for CPU tensors they run the
plain PyTorch versions (``ref.py``). There is no other route: a CUDA
tensor the kernel does not take raises. Either way the state (and z) is
updated in place and returned.

``fused_recurrent_linear`` and ``fused_recurrent_gated`` add the
(B, H, …) ↔ (B·H, …) reshapes and broadcast a per-batch ``lens`` over
heads, as the JAX wrappers do.

``decode_linear_work`` and ``decode_gated_work`` give a launch's work,
(operations, bytes): each input read and each output written once, the
state and z both ways. Every call reports it to ``launch/hlo.py``; on a
fake tensor (``FakeTensorMode``: shapes, no storage) a wrapper checks
what the kernel checks, records its work and returns outputs of the
kernel's shapes, the state as given, without a launch or a count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch.hlo import is_fake, record_kernel
from repro_torch.kernels.fused_recurrent.ref import (
    fused_recurrent_gated_ref, fused_recurrent_linear_ref)

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "decode_linear.cu"
GATED_SOURCE = SOURCE.with_name("decode_gated.cu")
# qwen3-0.6b's smoke and full widths, musicgen-large's, phi3-mini-3.8b's,
# zamba2-7b's shared attention
HEAD_DIMS = (16, 64, 96, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load_library(SOURCE)
    fn = lib.decode_linear
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def load_gated() -> ctypes.CDLL:
    """Build (at first use) and load the gated kernel library."""
    lib = build.load_library(GATED_SOURCE)
    fn = lib.decode_gated
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_rows(kernel, s, q, k, v, lens, extra) -> None:
    """What both kernels take: an fp32 (N, D, D) state with D in
    HEAD_DIMS; q, k (N, W, D) and v (N, W, D) of one type; lens (N,)
    int32 or None; ``extra`` (name, tensor, shape) fp32 tensors. All on
    the state's device and contiguous."""
    n, dk, dv = s.shape
    w = q.shape[1]
    if dk != dv or dk not in HEAD_DIMS:
        raise ValueError(f"{kernel}: Dk=Dv in {HEAD_DIMS} only, got "
                         f"state {tuple(s.shape)}")
    if s.dtype != torch.float32:
        raise TypeError(f"{kernel}: state must be float32, got {s.dtype}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{kernel}: q, k, v must share one type of "
                        f"{list(_DTYPES)}, got {q.dtype}/{k.dtype}/{v.dtype}")
    want = {"q": (n, w, dk), "k": (n, w, dk), "v": (n, w, dv)}
    for name, t in (("q", q), ("k", k), ("v", v)):
        if tuple(t.shape) != want[name]:
            raise ValueError(f"{kernel}: {name} has shape "
                             f"{tuple(t.shape)}, expected {want[name]}")
    tensors = [("s", s), ("q", q), ("k", k), ("v", v)]
    for name, t, shape in extra:
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{kernel}: {name} must be float32 of shape "
                             f"{shape}, got {t.dtype} {tuple(t.shape)}")
        tensors.append((name, t))
    if lens is not None:
        if lens.dtype != torch.int32 or tuple(lens.shape) != (n,):
            raise ValueError(f"{kernel}: lens must be int32 of shape "
                             f"{(n,)}, got {lens.dtype} {tuple(lens.shape)}")
        tensors.append(("lens", lens))
    for name, t in tensors:
        if t.device != s.device:
            raise ValueError(f"{kernel}: {name} is on {t.device}, "
                             f"the state on {s.device}")
        if not t.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def decode_linear_work(s: Tensor, q: Tensor, k: Tensor, v: Tensor, *,
                       z: Optional[Tensor] = None, normalize: bool = False,
                       lens: Optional[Tensor] = None) -> Tuple[int, int]:
    """B1's work on flat rows: per row and step S += k vᵀ, o = Sᵀq (and
    z's update and the q·z denominator): 4·Dk·Dv + 4·Dk operations;
    s (and z) read and written, q, k, v (and lens) read, o written."""
    n, dk, dv = s.shape
    w = q.shape[1]
    zz = z if normalize else None
    return (n * w * (4 * dk * dv + 4 * dk),
            2 * _nbytes(s, zz) + _nbytes(q, k, v, lens) + _nbytes(v))


def decode_gated_work(s: Tensor, q: Tensor, k: Tensor, v: Tensor,
                      g: Tensor, *, lens: Optional[Tensor] = None
                      ) -> Tuple[int, int]:
    """B7's work on flat rows: per row and step e^g ⊙ S, k vᵀ, their sum
    and o = Sᵀq (5·Dk·Dv) and one exp a decay element (Dk); s read and
    written, q, k, v, g (and lens) read, o written."""
    n, dk, dv = s.shape
    w = q.shape[1]
    return (n * w * (5 * dk * dv + dk),
            2 * _nbytes(s) + _nbytes(q, k, v, g, lens) + _nbytes(v))


def _check(s, q, k, v, z, normalize, lens) -> None:
    n, dk, _ = s.shape
    _check_rows("decode_linear", s, q, k, v, lens,
                [("z", z, (n, dk))] if normalize else [])


def _check_gated(s, q, k, v, g, lens) -> None:
    """g is fp32 whatever q, k and v are: the model's log-decay."""
    _check_rows("decode_gated", s, q, k, v, lens,
                [("g", g, tuple(q.shape))])


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
    work = decode_linear_work(s, q, k, v, z=z, normalize=normalize,
                              lens=lens)
    if is_fake(s):
        _check(s, q, k, v, z, normalize, lens)
        record_kernel("decode_linear", work, "fake")
        return (torch.empty(v.shape, dtype=v.dtype, device=v.device), s,
                z if normalize else None)
    if s.device.type == "cpu":
        record_kernel("decode_linear", work, "plain")
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
    record_kernel("decode_linear", work, "kernel")
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
    o, _, _ = decode_linear(
        s.view(b * h, dk, dv),
        q.reshape(b * h, w, dk).contiguous(),
        k.reshape(b * h, w, dk).contiguous(),
        v.reshape(b * h, w, dv).contiguous(),
        z=None if z is None else z.view(b * h, dk),
        normalize=normalize, eps=eps, lens=_lens_bh(lens, s, b, h))
    return o.view(b, h, w, dv), s, z if normalize else None


def _lens_bh(lens: Optional[Tensor], s: Tensor, b: int, h: int
             ) -> Optional[Tensor]:
    """Per-batch lens (B,) → per-row (B·H,) int32 on the state's device."""
    if lens is None:
        return None
    return (lens.to(device=s.device, dtype=torch.int32)[:, None]
            .expand(b, h).reshape(b * h))


def decode_gated(
    s: Tensor,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    g: Tensor,
    *,
    lens: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """W fused decode steps of the gated recurrence (inclusive form) over
    N flat rows: S ← diag(exp g) S + k vᵀ, then o = Sᵀq.

    s: (N, Dk, Dv) fp32; q, k: (N, W, Dk); v: (N, W, Dv); g: (N, W, Dk)
    fp32 log-decay (used as given, no clamp); lens: (N,) int32 or None
    (masked steps neither decay nor update). Returns (o: (N, W, Dv) in
    v's type, s) with s updated in place.
    """
    work = decode_gated_work(s, q, k, v, g, lens=lens)
    if is_fake(s):
        _check_gated(s, q, k, v, g, lens)
        record_kernel("decode_gated", work, "fake")
        return torch.empty(v.shape, dtype=v.dtype, device=v.device), s
    if s.device.type == "cpu":
        record_kernel("decode_gated", work, "plain")
        o, s_new = fused_recurrent_gated_ref(
            s[:, None], q[:, None], k[:, None], v[:, None], g[:, None],
            lens=lens)
        s.copy_(s_new[:, 0])
        return o[:, 0], s
    if s.device.type != "cuda":
        raise ValueError(f"decode_gated: no kernel for {s.device}")
    _check_gated(s, q, k, v, g, lens)
    n, dk, _ = s.shape
    w = q.shape[1]
    o = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if n == 0 or w == 0:
        return o, s
    lib = load_gated()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        err = lib.decode_gated(
            s.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            g.data_ptr(), o.data_ptr(),
            None if lens is None else lens.data_ptr(),
            n, w, dk, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"decode_gated: kernel launch failed with CUDA "
                           f"error {err}")
    decode_gated.launches += 1
    record_kernel("decode_gated", work, "kernel")
    return o, s


decode_gated.launches = 0


def fused_recurrent_gated(
    s: Tensor,
    q: Tensor,
    k: Tensor,
    v: Tensor,
    g: Tensor,
    *,
    lens: Optional[Tensor] = None,
) -> Tuple[Tensor, Tensor]:
    """W fused decode steps, gated (decay) recurrence, inclusive form.

    s: (B, H, Dk, Dv) fp32, contiguous; q, k, g: (B, H, W, Dk);
    v: (B, H, W, Dv); g the log-decay (fp32 for the kernel); lens: (B,)
    per-row valid lengths or None. Returns (o: (B, H, W, Dv), s) with s
    updated in place — one kernel launch and one state round trip for the
    whole window on CUDA.
    """
    b, h, w, dk = q.shape
    dv = v.shape[-1]
    o, _ = decode_gated(
        s.view(b * h, dk, dv),
        q.reshape(b * h, w, dk).contiguous(),
        k.reshape(b * h, w, dk).contiguous(),
        v.reshape(b * h, w, dv).contiguous(),
        g.reshape(b * h, w, dk).contiguous(),
        lens=_lens_bh(lens, s, b, h))
    return o.view(b, h, w, dv), s
