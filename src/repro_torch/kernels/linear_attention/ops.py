"""Wrappers for the chunked linear-attention kernels (port of
``repro/kernels/linear_attention/ops.py``).

``fwd`` (B2) and ``bwd`` (B3: ``bwd_dq`` and ``bwd_dkv``) take flat
(BH, T, D) rows with T a multiple of the chunk, as the Pallas functions
of ``kernel.py`` do. For CUDA tensors they launch the kernels of
``csrc/linear_attention.cu`` (bf16 on the tensor cores, fp32 on FMAs);
for CPU tensors they run the plain PyTorch versions (``ref.py``). There
is no other route: a CUDA tensor the kernel does not take raises.
``kernel=False`` asks for the plain version explicitly on any device
(tests and ``chip_smoke.py`` compare the two routes that way).

``linear_attention`` adds the (B, H, T, D) ↔ (BH, T, D) reshapes and the
chunk padding rule of the JAX wrapper, around a ``torch.autograd.Function``
that stands in for its custom VJP: forward B2, backward B3, and only
(q, k, v) saved — no state, the paper's §3.3 memory argument.
``linear_attention_with_state`` is the forward-only variant that also
returns the final state.

``fwd_work``, ``bwd_dq_work``, ``bwd_dkv_work`` and ``bwd_work`` give
the work, (operations, bytes), of each launch and of the backward as a
function: each input read and each output written once; 2·T·D² a row
for each product with the D × D state, two for B2 and dq, three for
dk/dv, five for the backward. Every call reports its launches' work to
``launch/hlo.py``; on a fake tensor (``FakeTensorMode``) a wrapper checks
what the kernel checks, records its work and returns outputs of the
kernel's shapes without a launch or a count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch.hlo import is_fake, record_kernel
from repro_torch.kernels.linear_attention.ref import (
    chunked_bwd_ref, chunked_fwd_ref)

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "linear_attention.cu"
# qwen3-0.6b's smoke and full widths, musicgen-large's and RWKV-6's 64,
# phi3-mini-3.8b's 96, zamba2-7b's 112
HEAD_DIMS = (16, 64, 96, 112, 128)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load_library(SOURCE)
    lib.linear_attention_fwd.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.linear_attention_bwd_dq.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.linear_attention_bwd_dkv.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    for fn in (lib.linear_attention_fwd, lib.linear_attention_bwd_dq,
               lib.linear_attention_bwd_dkv):
        fn.restype = ctypes.c_int
    return lib


def _check(kernel: str, chunk: int, **tensors: Tensor) -> None:
    """What the kernels take: contiguous (BH, T, D) rows of one type in
    ``_DTYPES`` on one CUDA device, D in HEAD_DIMS, T a multiple of
    ``chunk`` (the Pallas functions' contract)."""
    first = next(iter(tensors.values()))
    bh, t, d = first.shape if first.ndim == 3 else (None,) * 3
    if d not in HEAD_DIMS:
        raise ValueError(f"{kernel}: (BH, T, D) rows with D in {HEAD_DIMS} "
                         f"only, got {tuple(first.shape)}")
    if first.dtype not in _DTYPES:
        raise TypeError(f"{kernel}: inputs must be one of {list(_DTYPES)}, "
                        f"got {first.dtype}")
    if t % chunk:
        raise ValueError(f"{kernel}: T={t} is not a multiple of the chunk "
                         f"{chunk}")
    for name, x in tensors.items():
        if tuple(x.shape) != (bh, t, d) or x.dtype != first.dtype:
            raise ValueError(f"{kernel}: {name} is {x.dtype} "
                             f"{tuple(x.shape)}, expected {first.dtype} "
                             f"{(bh, t, d)}")
        if x.device != first.device:
            raise ValueError(f"{kernel}: {name} is on {x.device}, not "
                             f"{first.device}")
        if not x.is_contiguous():
            raise ValueError(f"{kernel}: {name} must be contiguous")


def _nbytes(*ts: Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _products(x: Tensor, n: int) -> int:
    """n products of T rank-one updates or reads of each row's D × D
    state: 2·T·D² operations each."""
    bh, t, d = x.shape
    return n * bh * t * 2 * d * d


def fwd_work(q: Tensor, k: Tensor, v: Tensor) -> Tuple[int, int]:
    """B2: S += k vᵀ and q S a token; q, k, v read, o and the fp32 state
    written."""
    bh, _, d = q.shape
    return _products(q, 2), _nbytes(q, k, v, v) + bh * d * d * 4


def bwd_dq_work(k: Tensor, v: Tensor, do: Tensor) -> Tuple[int, int]:
    """B3's dq launch: k, v, do read, dq written."""
    return _products(k, 2), _nbytes(k, v, do, k)


def bwd_dkv_work(q: Tensor, k: Tensor, v: Tensor, do: Tensor
                 ) -> Tuple[int, int]:
    """B3's dk/dv launch (R += q doᵀ, v R, k R): q, k, v, do read, dk and
    dv written."""
    return _products(q, 3), _nbytes(q, k, v, do, k, v)


def bwd_work(q: Tensor, k: Tensor, v: Tensor, do: Tensor
             ) -> Tuple[int, int]:
    """B3 as a function: q, k, v, do read once, dq, dk, dv written."""
    return _products(q, 5), _nbytes(q, k, v, do, q, k, v)


def _on_cpu(x: Tensor) -> bool:
    if is_fake(x):          # shapes only: the kernel's route, no launch
        return False
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"linear attention: no kernel for {x.device}")
    return False


def _raise_on(kernel: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{kernel}: kernel launch failed with CUDA error "
                           f"{err}")


def _stream(x: Tensor) -> int:
    return torch.cuda.current_stream(x.device).cuda_stream


def fwd(q: Tensor, k: Tensor, v: Tensor, *, chunk: int = 128,
        kernel: bool = True) -> Tuple[Tensor, Tensor]:
    """B2. q, k, v: (BH, T, D), T % chunk == 0. Returns (o: (BH, T, D)
    in v's type, s: (BH, D, D) fp32 final state)."""
    if not kernel or _on_cpu(q):
        record_kernel("linear_attention_fwd", fwd_work(q, k, v), "plain")
        return chunked_fwd_ref(q, k, v, chunk=chunk)
    _check("linear_attention_fwd", chunk, q=q, k=k, v=v)
    bh, t, d = q.shape
    o = torch.empty_like(v)
    s = torch.empty((bh, d, d), dtype=torch.float32, device=q.device)
    if is_fake(q):
        record_kernel("linear_attention_fwd", fwd_work(q, k, v), "fake")
        return o, s
    if bh == 0 or t == 0:
        return o, s.zero_()
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.linear_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            s.data_ptr(), bh, t, d, _DTYPES[q.dtype], _stream(q))
    _raise_on("linear_attention_fwd", err)
    fwd.launches += 1
    record_kernel("linear_attention_fwd", fwd_work(q, k, v), "kernel")
    return o, s


fwd.launches = 0


def bwd_dq(k: Tensor, v: Tensor, do: Tensor, *, chunk: int = 128) -> Tensor:
    """B3's forward sweep on CUDA rows: dq = (dO Vᵀ ⊙ M) K + dO Sᵀ."""
    _check("linear_attention_bwd_dq", chunk, k=k, v=v, do=do)
    bh, t, d = k.shape
    dq = torch.empty_like(k)
    if is_fake(k):
        record_kernel("linear_attention_bwd_dq", bwd_dq_work(k, v, do),
                      "fake")
        return dq
    if bh == 0 or t == 0:
        return dq
    lib = load()
    with torch.cuda.device(k.device):
        err = lib.linear_attention_bwd_dq(
            k.data_ptr(), v.data_ptr(), do.data_ptr(), dq.data_ptr(), bh, t,
            d, _DTYPES[k.dtype], _stream(k))
    _raise_on("linear_attention_bwd_dq", err)
    bwd_dq.launches += 1
    record_kernel("linear_attention_bwd_dq", bwd_dq_work(k, v, do),
                  "kernel")
    return dq


bwd_dq.launches = 0


def bwd_dkv(q: Tensor, k: Tensor, v: Tensor, do: Tensor, *,
            chunk: int = 128) -> Tuple[Tensor, Tensor]:
    """B3's reverse sweep on CUDA rows: dk = (V dOᵀ ⊙ Mᵀ) Q + V Rᵀ and
    dv = (K Qᵀ ⊙ Mᵀ) dO + K R, R = Σ_{later} q doᵀ, in one launch."""
    _check("linear_attention_bwd_dkv", chunk, q=q, k=k, v=v, do=do)
    bh, t, d = q.shape
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    if is_fake(q):
        record_kernel("linear_attention_bwd_dkv", bwd_dkv_work(q, k, v, do),
                      "fake")
        return dk, dv
    if bh == 0 or t == 0:
        return dk, dv
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.linear_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bh, t, d, _DTYPES[q.dtype],
            _stream(q))
    _raise_on("linear_attention_bwd_dkv", err)
    bwd_dkv.launches += 1
    record_kernel("linear_attention_bwd_dkv", bwd_dkv_work(q, k, v, do),
                  "kernel")
    return dk, dv


bwd_dkv.launches = 0


def bwd(q: Tensor, k: Tensor, v: Tensor, do: Tensor, *, chunk: int = 128,
        kernel: bool = True) -> Tuple[Tensor, Tensor, Tensor]:
    """B3, the §3.3 recompute backward: (dq, dk, dv) from q, k, v and do
    alone, (BH, T, D) each, in q's, k's and v's types."""
    if not kernel or _on_cpu(q):
        record_kernel("linear_attention_bwd_dq", bwd_dq_work(k, v, do),
                      "plain")
        record_kernel("linear_attention_bwd_dkv", bwd_dkv_work(q, k, v, do),
                      "plain")
        return chunked_bwd_ref(q, k, v, do, chunk=chunk)
    dq = bwd_dq(k, v, do, chunk=chunk)
    dk, dv = bwd_dkv(q, k, v, do, chunk=chunk)
    return dq, dk, dv


class _LinearAttention(torch.autograd.Function):
    """The custom VJP of the JAX wrapper: forward B2, backward B3, and
    only (q, k, v) kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, chunk, kernel):
        o, _ = fwd(q, k, v, chunk=chunk, kernel=kernel)
        ctx.save_for_backward(q, k, v)
        ctx.chunk, ctx.kernel = chunk, kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = bwd(q, k, v, do.contiguous(), chunk=ctx.chunk,
                         kernel=ctx.kernel)
        return dq, dk, dv, None, None


def _rows(x: Tensor, t_pad: int) -> Tensor:
    """(B, H, T, D) → contiguous (B·H, T_pad, D), zero-padded in T."""
    b, h, t, d = x.shape
    x = x.reshape(b * h, t, d)
    if t_pad != t:
        x = torch.nn.functional.pad(x, (0, 0, 0, t_pad - t))
    return x.contiguous()


def _chunk_and_pad(t: int, chunk: int) -> Tuple[int, int]:
    """The JAX wrapper's rule: the chunk drops to T when T is not a
    multiple of it and shorter; T is padded to a multiple of the chunk."""
    c = min(chunk, t) if t % chunk else chunk
    return c, -(-t // c) * c


def linear_attention(q: Tensor, k: Tensor, v: Tensor, *, chunk: int = 128,
                     kernel: bool = True) -> Tensor:
    """Causal linear attention o_t = Σ_{s≤t} (q_t·k_s) v_s. q, k:
    (B, H, T, Dk); v: (B, H, T, Dv). Differentiable: the backward is B3's
    recompute (no stored intermediate states, paper §3.3)."""
    b, h, t, _ = q.shape
    dv = v.shape[-1]
    c, t_pad = _chunk_and_pad(t, chunk)
    o = _LinearAttention.apply(_rows(q, t_pad), _rows(k, t_pad),
                               _rows(v, t_pad), c, kernel)
    return o[:, :t].reshape(b, h, t, dv)


def linear_attention_with_state(q: Tensor, k: Tensor, v: Tensor, *,
                                chunk: int = 128, kernel: bool = True
                                ) -> Tuple[Tensor, Tensor]:
    """Forward-only variant that also returns the final (B, H, Dk, Dv)
    fp32 state (the paper's fixed-size representation)."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c, t_pad = _chunk_and_pad(t, chunk)
    o, s = fwd(_rows(q, t_pad), _rows(k, t_pad), _rows(v, t_pad), chunk=c,
               kernel=kernel)
    return o[:, :t].reshape(b, h, t, dv), s.reshape(b, h, dk, dv)
