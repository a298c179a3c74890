"""Wrappers for the causal flash-attention forward (port of
``repro/kernels/flash_attention/ops.py``).

``fwd`` (B10) takes flat rows q (BH, T, D) and k, v (BH, S, D), as the
Pallas ``fwd`` of ``kernel.py`` does. For CUDA tensors it launches the
kernel of ``csrc/flash_attention.cu``; for CPU tensors it runs the plain
PyTorch version (``ref.flash_attention_fwd_ref``). There is no other
route: a CUDA tensor the kernel does not take raises. ``kernel=False``
asks for the plain version explicitly on any device (tests and
``chip_smoke.py`` compare the two routes that way).

``flash_attention`` adds the (B, H, T, D) ↔ (BH, T, D) reshapes and the
tile padding of the JAX wrapper. Forward only, as in JAX: the Pallas
kernel has no backward.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
HEAD_DIMS = (16, 64, 128)   # qwen3-0.6b smoke and full widths, JAX's tests
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 128                  # the JAX wrapper's cq = ckv, for its padding


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load_library(SOURCE)
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    """What the kernel takes: contiguous rows of one type in ``_DTYPES``
    on one CUDA device, D in HEAD_DIMS, k and v of one shape."""
    if q.ndim != 3 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: (BH, T, D) rows with D in "
                         f"{HEAD_DIMS} only, got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd: inputs must be one of "
                        f"{list(_DTYPES)}, got {q.dtype}")
    bh, _, d = q.shape
    for name, x in (("k", k), ("v", v)):
        if x.ndim != 3 or (x.shape[0], x.shape[2]) != (bh, d) or \
                x.shape != k.shape or x.dtype != q.dtype:
            raise ValueError(f"flash_attention_fwd: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {q.dtype} "
                             f"({bh}, S, {d})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {x.device}"
                             f", not {q.device}")
        if not x.is_contiguous():
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"contiguous")


def _on_cpu(x: Tensor) -> bool:
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {x.device}")
    return False


def fwd(q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None,
        t_off: Optional[int] = None, s_real: Optional[int] = None,
        kernel: bool = True) -> Tensor:
    """B10. q: (BH, T, D); k, v: (BH, S, D). Query i attends key j iff
    j ≤ i + t_off and j < s_real (defaults S − T and S: the queries are
    the last T of the S keys). Scores times ``scale`` (default D^-½),
    fp32 math; returns (BH, T, D) in v's type.

    Requires t_off ≥ 0 and 1 ≤ s_real ≤ S, so that key 0 is visible to
    every query. The kernel stops at the last key tile a query can see,
    where the Pallas grid visits every tile; the two agree exactly when
    every query sees a key in the first tile (the CUDA source's header
    says why). Out of that domain, a query with no visible key gets the
    mean of v under the Pallas grid and would differ here. The JAX
    wrapper never leaves it: it passes t_off = S − T ≥ 0 and s_real = S.
    """
    bh, t, d = q.shape
    s = k.shape[1]
    scale = d ** -0.5 if scale is None else float(scale)
    t_off = s - t if t_off is None else int(t_off)
    s_real = s if s_real is None else int(s_real)
    if t_off < 0 or not 1 <= s_real <= s:
        raise ValueError(f"flash_attention_fwd: needs t_off >= 0 and "
                         f"1 <= s_real <= S={s}, got t_off={t_off}, "
                         f"s_real={s_real}")
    if not kernel or _on_cpu(q):
        return flash_attention_fwd_ref(q, k, v, scale=scale, t_off=t_off,
                                       s_real=s_real)
    _check(q, k, v)
    o = torch.empty_like(q)
    if bh == 0 or t == 0:
        return o
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh, t, s,
            d, t_off, s_real, scale, _DTYPES[q.dtype],
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with "
                           f"CUDA error {err}")
    fwd.launches += 1
    return o


fwd.launches = 0


def _rows(x: Tensor, n_pad: int) -> Tensor:
    """(B, H, N, D) → contiguous (B·H, N_pad, D), zero-padded in N."""
    b, h, n, d = x.shape
    x = x.reshape(b * h, n, d)
    if n_pad != n:
        x = F.pad(x, (0, 0, 0, n_pad - n))
    return x.contiguous()


def _padded(n: int) -> int:
    """The JAX wrapper's rule: the tile drops to N when N is not a
    multiple of it and shorter; N is padded to a multiple of the tile."""
    c = min(TILE, n) if n % TILE else TILE
    return -(-n // c) * c


def flash_attention(q: Tensor, k: Tensor, v: Tensor, *,
                    scale: Optional[float] = None,
                    t_off: Optional[int] = None,
                    kernel: bool = True) -> Tensor:
    """Causal softmax attention. q: (B, H, T, D); k, v: (B, H, S, D).
    T and S are padded as the JAX wrapper pads them (its default tiles
    of 128) and the real lengths passed on (t_off = S − T unless given,
    s_real = S), so padded keys stay masked and padded queries are
    sliced off. Returns (B, H, T, D) in v's type."""
    b, h, t, d = q.shape
    s = k.shape[2]
    t_pad, s_pad = _padded(t), _padded(s)
    o = fwd(_rows(q, t_pad), _rows(k, s_pad), _rows(v, s_pad), scale=scale,
            t_off=s - t if t_off is None else t_off, s_real=s, kernel=kernel)
    return o[:, :t].reshape(b, h, t, d)
