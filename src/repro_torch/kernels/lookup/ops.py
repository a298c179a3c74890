"""Wrappers for the fast-lookup kernels (port of
``repro/kernels/lookup/ops.py``).

``mass_lookup`` (B5), ``mass_lookup_indexed`` (B4) and ``fused_decode``
(B6) launch the CUDA kernels of ``csrc/lookup.cu`` for CUDA tensors and
run the plain PyTorch versions (``ref.py``) for CPU tensors. There is no
other route: a CUDA tensor the kernel does not take raises. Each wrapper
counts its kernel launches in a plain integer attribute ``launches``.

B4 and B5 take two routes inside the one kernel call, by K: even K the
bulk route (each state copied into shared memory by bulk asynchronous
copies, which need the store 16-byte aligned, and the queries 16-byte
aligned for K % 4 == 0 and 8-byte otherwise: ``_check_aligned``), odd K
the direct-load route. B6 takes two kernels, by shape (``decode_route``):
a state of Dk·Dv % 4 == 0 and at most ``DECODE_RESIDENT`` floats the bulk
route (the state copied into shared memory and back by bulk asynchronous
copies, which need it 16-byte aligned), any other the direct route.

``mass_lookup_work``, ``mass_lookup_indexed_work`` and
``fused_decode_work`` give a launch's work, (operations, bytes): each
input read and each output written once (B4 reads the states of the
distinct rows of its wave); 2·K² operations a query against a K × K
state, 4·Dk·Dv for B6's update and read. Every call reports it to
``launch/hlo.py``; on a fake tensor (``FakeTensorMode``) a wrapper checks
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
from repro_torch.launch.hlo import is_fake, record_kernel
from repro_torch.kernels.lookup.ref import (
    decode_ref, mass_lookup_indexed_ref, mass_lookup_ref,
)

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "lookup.cu"
MAX_K = 256                     # the kernels' largest K, Dk and Dv
_DECODE_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
DECODE_RESIDENT = 48 * 1024     # B6's largest state on the bulk route
                                # (kDecodeResident in csrc/lookup.cu)


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load_library(SOURCE)
    lib.mass_lookup.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.mass_lookup.restype = ctypes.c_int
    lib.lookup_decode.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.lookup_decode.restype = ctypes.c_int
    return lib


def _check_tensors(name: str, **tensors: Tensor) -> None:
    """One device for all, each contiguous."""
    dev = next(iter(tensors.values())).device
    for arg, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name}: {arg} is on {t.device}, not {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {arg} must be contiguous")


def _nbytes(*ts: Optional[Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def mass_lookup_work(c: Tensor, q: Tensor) -> Tuple[int, int]:
    """B5: every state and query read, the answers (q's shape) written."""
    n, m, k = q.shape
    return 2 * n * m * k * k, _nbytes(c, q, q)


def mass_lookup_indexed_work(store: Tensor, rows: Tensor, q: Tensor
                             ) -> Tuple[int, int]:
    """B4: the states of the wave's distinct rows (all B of them on a
    fake tensor, which holds no data), the rows and queries read, the
    answers written."""
    b, m, k = q.shape
    distinct = (rows.numel() if is_fake(rows)
                else int(torch.unique(rows).numel()))
    state = k * k * store.element_size()
    return 2 * b * m * k * k, distinct * state + _nbytes(rows, q, q)


def fused_decode_work(s: Tensor, q: Tensor, k: Tensor, v: Tensor
                      ) -> Tuple[int, int]:
    """B6: the state read and written, q, k, v read, o written."""
    n, dk, dv = s.shape
    return 4 * n * dk * dv, 2 * _nbytes(s) + _nbytes(q, k, v, v)


def _check_lookup(name: str, c: Tensor, q: Tensor,
                  rows: Optional[Tensor] = None) -> None:
    """What B4 (with ``rows``) and B5 take: fp32 (N, K, K) states with
    K <= 256, fp32 (B, M, K) queries, int32 (B,) rows (B = N for B5)."""
    tensors = {"c": c, "q": q}
    if rows is not None:
        tensors["rows"] = rows
    _check_tensors(name, **tensors)
    if c.ndim != 3 or c.shape[1] != c.shape[2] or not 1 <= c.shape[1] <= MAX_K:
        raise ValueError(f"{name}: states must be (N, K, K) with K <= "
                         f"{MAX_K}, got {tuple(c.shape)}")
    if c.dtype != torch.float32 or q.dtype != torch.float32:
        raise TypeError(f"{name}: states and queries must be float32, got "
                        f"{c.dtype}/{q.dtype}")
    b = c.shape[0] if rows is None else q.shape[0]
    k = c.shape[1]
    if q.ndim != 3 or q.shape[0] != b or q.shape[2] != k:
        raise ValueError(f"{name}: queries must be ({b}, M, {k}), got "
                         f"{tuple(q.shape)}")
    if rows is not None and (rows.dtype != torch.int32
                             or tuple(rows.shape) != (b,)):
        raise ValueError(f"{name}: rows must be int32 of shape {(b,)}, got "
                         f"{rows.dtype} {tuple(rows.shape)}")


def _check_aligned(name: str, c: Tensor, q: Tensor) -> None:
    """The bulk route's alignment (even K): the states' copies start on
    16-byte boundaries, and the queries are read 16 bytes at a time where
    K % 4 == 0, 8 otherwise. A view at another offset raises; nothing is
    copied or rerouted."""
    k = c.shape[-1]
    if k % 2:
        return
    if c.data_ptr() % 16:
        raise ValueError(f"{name}: the states must start on a 16-byte "
                         f"boundary for even K, at {c.data_ptr():#x}")
    q_align = 16 if k % 4 == 0 else 8
    if q.data_ptr() % q_align:
        raise ValueError(f"{name}: the queries must start on a {q_align}-"
                         f"byte boundary for K = {k}, at {q.data_ptr():#x}")


def _check_decode(s: Tensor, q: Tensor, k: Tensor, v: Tensor) -> None:
    """What B6 takes: an fp32 (N, Dk, Dv) state with Dk, Dv <= 256 and
    q, k: (N, Dk), v: (N, Dv) of one type, fp32 or bf16."""
    _check_tensors("fused_decode", s=s, q=q, k=k, v=v)
    if s.ndim != 3 or not (1 <= s.shape[1] <= MAX_K
                           and 1 <= s.shape[2] <= MAX_K):
        raise ValueError(f"fused_decode: the state must be (N, Dk, Dv) "
                         f"with Dk, Dv <= {MAX_K}, got {tuple(s.shape)}")
    if s.dtype != torch.float32:
        raise TypeError(f"fused_decode: state must be float32, got {s.dtype}")
    if q.dtype not in _DECODE_DTYPES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise TypeError("fused_decode: q, k, v must share one type of "
                        f"{list(_DECODE_DTYPES)}, got "
                        f"{q.dtype}/{k.dtype}/{v.dtype}")
    n, dk, dv = s.shape
    for name, t, want in (("q", q, (n, dk)), ("k", k, (n, dk)),
                          ("v", v, (n, dv))):
        if tuple(t.shape) != want:
            raise ValueError(f"fused_decode: {name} has shape "
                             f"{tuple(t.shape)}, expected {want}")


def decode_route(dk: int, dv: int) -> str:
    """B6's kernel for (Dk, Dv) states, as ``lookup_decode`` picks it
    (``decode_bulk_route`` in ``csrc/lookup.cu``):
    ``"bulk"`` where a state is a whole number of 16-byte units (Dk·Dv %
    4 == 0) and fits in a block's shared memory, else ``"direct"``."""
    return ("bulk" if dk * dv % 4 == 0 and dk * dv <= DECODE_RESIDENT
            else "direct")


def _check_decode_aligned(s: Tensor) -> None:
    """The bulk route's alignment: its copies of each state start on
    16-byte boundaries. A view at another offset raises; nothing is
    copied or rerouted."""
    if decode_route(s.shape[1], s.shape[2]) == "bulk" and s.data_ptr() % 16:
        raise ValueError(f"fused_decode: the state must start on a 16-byte "
                         f"boundary for Dk·Dv % 4 == 0, at "
                         f"{s.data_ptr():#x}")


def _need_cuda(name: str, t: Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {t.device}")


def _run(name: str, err: int) -> None:
    if err:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")


def _launch_lookup(lib, c: Tensor, rows: Optional[Tensor], q: Tensor
                   ) -> Tensor:
    b, m, k = q.shape
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _run("mass_lookup", lib.mass_lookup(
            c.data_ptr(), None if rows is None else rows.data_ptr(),
            q.data_ptr(), o.data_ptr(), c.shape[0], b, m, k, stream))
    return o


def mass_lookup(c: Tensor, q: Tensor) -> Tensor:
    """Answer q: (N, M, K) against document states c: (N, K, K):
    o[n] = q[n] c[n]ᵀ, one launch."""
    work = mass_lookup_work(c, q)
    if is_fake(c):
        _check_lookup("mass_lookup", c, q)
        record_kernel("mass_lookup", work, "fake")
        return torch.empty_like(q)
    if c.device.type == "cpu":
        record_kernel("mass_lookup", work, "plain")
        return mass_lookup_ref(c, q)
    _need_cuda("mass_lookup", c)
    _check_lookup("mass_lookup", c, q)
    _check_aligned("mass_lookup", c, q)
    if q.numel() == 0:
        return torch.empty_like(q)
    o = _launch_lookup(load(), c, None, q)
    mass_lookup.launches += 1
    record_kernel("mass_lookup", work, "kernel")
    return o


mass_lookup.launches = 0


def mass_lookup_indexed(store: Tensor, rows: Tensor, q: Tensor, *,
                        block_m: Optional[int] = None) -> Tensor:
    """Answer a heterogeneous query wave in ONE launch: ``q``: (B, M, K)
    with per-row document indices ``rows``: (B,) int32 into the resident
    ``store``: (N, K, K), o[b] = q[b] store[rows[b]]ᵀ. Pads M up to a
    ``block_m`` multiple (padded query rows read the same state and are
    sliced off), as the JAX wrapper does. On the card a row index outside
    the store gives NaN answers for that row; for even K the store must
    start on a 16-byte boundary (``_check_aligned``)."""
    m = q.shape[1]
    if block_m is not None and m % block_m:
        q = F.pad(q, (0, 0, 0, -m % block_m))
    def work():
        return mass_lookup_indexed_work(store, rows, q)
    if is_fake(store):
        _check_lookup("mass_lookup_indexed", store, q, rows)
        record_kernel("mass_lookup_indexed", work, "fake")
        o = torch.empty_like(q)
        return o if o.shape[1] == m else o[:, :m]
    if store.device.type == "cpu":
        record_kernel("mass_lookup_indexed", work, "plain")
        return mass_lookup_indexed_ref(store, rows, q)[:, :m]
    _need_cuda("mass_lookup_indexed", store)
    _check_lookup("mass_lookup_indexed", store, q, rows)
    _check_aligned("mass_lookup_indexed", store, q)
    if q.numel() == 0:
        return torch.empty_like(q)[:, :m]
    o = _launch_lookup(load(), store, rows, q)
    mass_lookup_indexed.launches += 1
    record_kernel("mass_lookup_indexed", work, "kernel")
    return o[:, :m]


mass_lookup_indexed.launches = 0


def fused_decode(s: Tensor, q: Tensor, k: Tensor, v: Tensor
                 ) -> Tuple[Tensor, Tensor]:
    """One fused O(k²) decode step: S += k vᵀ; o = Sᵀ q.

    s: (N, Dk, Dv) fp32; q, k: (N, Dk); v: (N, Dv). Returns (o: (N, Dv)
    in v's type, s) with ``s`` updated in place, where the Pallas kernel
    aliases its input state to its output. On the card, a state of
    Dk·Dv % 4 == 0 (the bulk route, ``decode_route``) must start on a
    16-byte boundary: a view at another offset raises ValueError."""
    work = fused_decode_work(s, q, k, v)
    if is_fake(s):
        _check_decode(s, q, k, v)
        record_kernel("fused_decode", work, "fake")
        return torch.empty_like(v), s
    if s.device.type == "cpu":
        record_kernel("fused_decode", work, "plain")
        o, s_new = decode_ref(s, q, k, v)
        s.copy_(s_new)
        return o, s
    _need_cuda("fused_decode", s)
    _check_decode(s, q, k, v)
    _check_decode_aligned(s)
    n, dk, dv = s.shape
    o = torch.empty_like(v)
    if n == 0:
        return o, s
    lib = load()
    with torch.cuda.device(s.device):
        stream = torch.cuda.current_stream(s.device).cuda_stream
        _run("fused_decode", lib.lookup_decode(
            s.data_ptr(), q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), n, dk, dv, _DECODE_DTYPES[q.dtype], stream))
    fused_decode.launches += 1
    record_kernel("fused_decode", work, "kernel")
    return o, s


fused_decode.launches = 0
