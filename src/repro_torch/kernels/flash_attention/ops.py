"""Wrappers for the causal flash-attention forward (port of
``repro/kernels/flash_attention/ops.py``).

``fwd`` (B10) takes flat rows q (B·H, T, D) and k, v (B·Hkv, S, D), with
the heads of the port's (G, Hkv) flattening h = g·Hkv + j: q row b·H + h
reads kv row b·Hkv + h mod Hkv, so grouped-query attention needs no
broadcast copy of K and V (``kv_heads``; Hkv = H is the Pallas ``fwd``'s
one-to-one call). For CUDA tensors it launches the kernel of
``csrc/flash_attention.cu`` (bf16 on the tensor cores, fp32 on the CUDA
cores); for CPU tensors it runs the plain PyTorch version
(``ref.flash_attention_fwd_ref``). There is no other route: a CUDA tensor
the kernel does not take raises. ``kernel=False`` asks for the plain
version explicitly on any device (tests and ``chip_smoke.py`` compare the
two routes that way).

``want_lse=True`` also returns each query's log-sum-exp m + log l in
fp32, (B·H, T), written by the kernel from the registers that normalise
o (the plain version computes it from the masked scores): it is what
JAX's ``_flash_fwd_impl`` saves for the softmax backward
(``models/xla_attention.py``). Without it the kernel gets a null
pointer and runs as it always did.

``flash_attention`` adds the (B, H, T, D) ↔ (B·H, T, D) reshapes and the
tile padding of the JAX wrapper, with k, v of H or Hkv heads, and slices
the lse back from the padded rows. Forward only, as in JAX: the Pallas
kernel has no backward.

``fwd_work`` gives a launch's work, (operations, bytes): q·k and p·v,
4·D operations, for each (query, key) pair a query can see; q, k, v read
and o (and the lse) written once. Every call reports it to
``launch/hlo.py``; on a fake tensor (``FakeTensorMode``) ``fwd`` checks
what the kernel checks (alignment aside: a fake tensor has no address),
records its work and returns outputs of the kernel's shapes without a
launch or a count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels.flash_attention.ref import flash_attention_fwd_ref
from repro_torch.launch.hlo import is_fake, record_kernel

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
# qwen3-0.6b's smoke and full widths, musicgen-large's (and JAX's tests'),
# phi3-mini-3.8b's, zamba2-7b's shared attention
HEAD_DIMS = (16, 64, 96, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
TILE = 128                  # the JAX wrapper's cq = ckv, for its padding


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load_library(SOURCE)
    lib.flash_attention_fwd.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 8 + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
                             ctypes.c_void_p]
    lib.flash_attention_fwd.restype = ctypes.c_int
    return lib


def _heads(q: Tensor, k: Tensor, kv_heads: Optional[int]) -> Tuple[int, int]:
    """(H, Hkv) of the flattening for q's B·H and k's B·Hkv rows; (1, 1)
    when the rows are one to one and ``kv_heads`` is not given. Raises
    on rows that do not divide."""
    rq, rk = q.shape[0], k.shape[0]
    if kv_heads is None:
        if rq != rk:
            raise ValueError(f"flash_attention_fwd: q has {rq} rows and k "
                             f"{rk}; grouped rows need kv_heads")
        return 1, 1
    hkv = int(kv_heads)
    b = rk // hkv if hkv >= 1 else 0
    h = rq // b if b else hkv
    if hkv < 1 or rk % hkv or b * h != rq or h % hkv:
        raise ValueError(f"flash_attention_fwd: {rq} q rows and {rk} kv "
                         f"rows are not B·H and B·Hkv with H a multiple of"
                         f" kv_heads={kv_heads}")
    return h, hkv


def _check(q: Tensor, k: Tensor, v: Tensor) -> None:
    """What the kernel takes: contiguous 16-byte aligned rows of one type
    in ``_DTYPES`` on one CUDA device, D in HEAD_DIMS, k and v of one
    shape."""
    if q.ndim != 3 or q.shape[-1] not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: (BH, T, D) rows with D in "
                         f"{HEAD_DIMS} only, got {tuple(q.shape)}")
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_attention_fwd: inputs must be one of "
                        f"{list(_DTYPES)}, got {q.dtype}")
    d = q.shape[2]
    for name, x in (("k", k), ("v", v)):
        if x.ndim != 3 or x.shape[2] != d or x.shape != k.shape or \
                x.dtype != q.dtype:
            raise ValueError(f"flash_attention_fwd: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {q.dtype} "
                             f"(rows, S, {d})")
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device != q.device:
            raise ValueError(f"flash_attention_fwd: {name} is on {x.device}"
                             f", not {q.device}")
        if not x.is_contiguous() or (not is_fake(x) and x.data_ptr() % 16):
            raise ValueError(f"flash_attention_fwd: {name} must be "
                             f"contiguous and 16-byte aligned")


def fwd_work(q: Tensor, k: Tensor, v: Tensor, *, t_off: int, s_real: int,
             want_lse: bool = False) -> Tuple[int, int]:
    """B10's work: 4·D operations for each visible pair (key j ≤ i +
    t_off and j < s_real for query i, in every q row); q, k, v read, o
    (and the fp32 lse) written."""
    bh, t, d = q.shape
    # Σ_i min(i + t_off + 1, s_real): the rows up to the clamp, then s_real
    n_open = max(0, min(t, s_real - t_off))
    pairs = n_open * (t_off + 1) + n_open * (n_open - 1) // 2 \
        + (t - n_open) * s_real
    n_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, q))
    return bh * pairs * 4 * d, n_bytes + (bh * t * 4 if want_lse else 0)


def _on_cpu(x: Tensor) -> bool:
    if is_fake(x):          # shapes only: the kernel's route, no launch
        return False
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"flash attention: no kernel for {x.device}")
    return False


def fwd(q: Tensor, k: Tensor, v: Tensor, *, scale: Optional[float] = None,
        t_off: Optional[int] = None, s_real: Optional[int] = None,
        kv_heads: Optional[int] = None, kernel: bool = True,
        want_lse: bool = False):
    """B10. q: (B·H, T, D); k, v: (B·Hkv, S, D), q row b·H + h reading kv
    row b·Hkv + h mod Hkv (``kv_heads`` = Hkv; without it the rows are one
    to one). Query i attends key j iff j ≤ i + t_off and j < s_real
    (defaults S − T and S: the queries are the last T of the S keys).
    Scores times ``scale`` (default D^-½); returns (B·H, T, D) in v's
    type, and with ``want_lse`` the pair (o, lse), lse (B·H, T) fp32 the
    log-sum-exp of each query's scaled scores. The plain version and the
    fp32 kernel compute in fp32; the bf16 kernel rounds P to bf16 before
    P·V, as JAX's oracle does.

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
    heads, kv = _heads(q, k, kv_heads)
    work = fwd_work(q, k, v, t_off=t_off, s_real=s_real, want_lse=want_lse)
    if not kernel or _on_cpu(q):
        record_kernel("flash_attention_fwd", work, "plain")
        return flash_attention_fwd_ref(q, k, v, scale=scale, t_off=t_off,
                                       s_real=s_real, kv_heads=kv_heads,
                                       want_lse=want_lse)
    _check(q, k, v)
    o = torch.empty_like(q)
    lse = (torch.empty((bh, t), dtype=torch.float32, device=q.device)
           if want_lse else None)
    out = (o, lse) if want_lse else o
    if is_fake(q):
        record_kernel("flash_attention_fwd", work, "fake")
        return out
    if bh == 0 or t == 0:
        return out
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), bh,
            heads, kv, t, s, d, t_off, s_real, scale, _DTYPES[q.dtype],
            None if lse is None else lse.data_ptr(),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"flash_attention_fwd: kernel launch failed with "
                           f"CUDA error {err}")
    fwd.launches += 1
    record_kernel("flash_attention_fwd", work, "kernel")
    return out


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
                    kernel: bool = True, want_lse: bool = False):
    """Causal softmax attention. q: (B, H, T, D); k, v: (B, Hkv, S, D)
    with H % Hkv == 0, q head h reading kv head h mod Hkv (Hkv = H: one
    to one). T and S are padded as the JAX wrapper pads them (its default
    tiles of 128) and the real lengths passed on (t_off = S − T unless
    given, s_real = S), so padded keys stay masked and padded queries are
    sliced off. Returns (B, H, T, D) in v's type, and with ``want_lse``
    the pair (o, lse), lse (B, H, T) fp32."""
    b, h, t, d = q.shape
    s = k.shape[2]
    t_pad, s_pad = _padded(t), _padded(s)
    out = fwd(_rows(q, t_pad), _rows(k, s_pad), _rows(v, s_pad),
              scale=scale, t_off=s - t if t_off is None else t_off, s_real=s,
              kv_heads=k.shape[1], kernel=kernel, want_lse=want_lse)
    if not want_lse:
        return out[:, :t].reshape(b, h, t, d)
    o, lse = out
    return o[:, :t].reshape(b, h, t, d), lse[:, :t].reshape(b, h, t)
