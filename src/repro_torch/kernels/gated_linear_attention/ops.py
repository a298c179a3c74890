"""Wrappers for the chunked gated linear-attention kernels (port of
``repro/kernels/gated_linear_attention/ops.py``).

``fwd`` (B8) and ``bwd`` (B9: ``bwd_dq``, then ``bwd_dkv``) take flat
rows: q, k, g (BH, T, Dk), v (BH, T, Dv), with T a multiple of the chunk,
as the Pallas functions of ``kernel.py`` do. For CUDA tensors they launch
the kernels of ``csrc/gated_linear_attention.cu``; for CPU tensors they
run the plain PyTorch versions (``ref.py``). There is no other route: a
CUDA tensor the kernel does not take raises. ``kernel=False`` asks for
the plain version explicitly on any device (tests and ``chip_smoke.py``
compare the two routes that way).

In bf16, B8 and B9 run on the tensor cores; in fp32, on FMAs. B9's two
launches split its function as ``ref.bwd_dq_ref`` and
``ref.bwd_dkv_dg_ref`` do: the dq launch also returns q⊙dq in fp32, and
the dk/dv launch takes it and returns dg as well. In bf16 both write
every output in its final type, so ``bwd`` runs no PyTorch epilogue or
cast; in fp32 the FMA kernels write dq, dk and dv, and the wrappers form
q⊙dq and dg in PyTorch.

The kernels rescale within tiles (64 tokens in bf16, 32 in fp32),
whatever the chunk; so with g at its clamp (−1) over a long chunk they
stay finite where the chunk-wide plain versions (and JAX) give NaN;
elsewhere the two agree to rounding. A CUDA call refuses a
``min_log_decay`` below its type's ``DECAY_LIMIT`` (the CPU route, JAX's
semantics, takes any).

``gated_linear_attention`` adds the broadcast of the log-decay to q's
shape, the (B, H, T, D) ↔ (BH, T, D) reshapes and the JAX wrapper's
chunk padding rule around a ``torch.autograd.Function`` that stands in
for its custom VJP: forward B8, backward B9, and only (q, k, v, g) saved.
``rwkv6_attention`` is the exclusive form with the bonus u, around
``_RWKV6Attention``: forward B8's exclusive route (one launch, the
RWKV-6 prefill when no gradient is wanted) and backward
``bwd_exclusive`` (``bwd_exclusive_dq``, then ``bwd_exclusive_dkv``: B9's
design with the strict mask, q scaled by e^{b_{t-1}}, the bonus terms,
the exclusive dg and du; no Pallas original, JAX differentiates
``chunked_gla`` by autodiff). ``ssd_attention`` is the forward-only
inclusive form with its final state (the Mamba-2 SSD prefill).

The ``*_work`` functions give the work, (operations, bytes), of each
launch and of each backward as a function: each input read and each
output written once (g, q⊙dq and dg in fp32, u and du beside); 2·T·D² a
row for each product with the D × D state (two forward and for dq,
three for dk/dv, five for a backward) plus one exp a decay element
(three with the exclusive forward's bonus). Every call reports its
launches' work to ``launch/hlo.py``; on a fake tensor
(``FakeTensorMode``) a wrapper checks what the kernel checks, records
its work and returns outputs of the kernel's shapes without a launch or
a count.
"""

from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional, Tuple

import torch

from repro_torch.kernels import build
from repro_torch.launch.hlo import is_fake, record_kernel
from repro_torch.kernels.gated_linear_attention import ref
from repro_torch.kernels.gated_linear_attention.ref import (
    MIN_LOG_DECAY, chunked_bwd_exclusive_ref, chunked_bwd_ref,
    chunked_fwd_ref)
from repro_torch.kernels.linear_attention.ops import (  # noqa: F401
    _DTYPES, HEAD_DIMS, _chunk_and_pad, _check, _on_cpu, _raise_on, _rows,
    _stream)

Tensor = torch.Tensor

SOURCE = Path(__file__).resolve().parent / "csrc" / "gated_linear_attention.cu"

# The lowest ``min_log_decay`` a CUDA call takes, per input type.
# - bf16: −1.25, set by overflow. A 64-token tile scales an operand by up
#   to e^{64·1.25} = e^80 (K̂ = k e^{-b}) and sums 64 such products in
#   fp32, whose largest exponent is 88.72: e^8.7 ≈ 6,000 is left for the
#   operands' magnitudes and the tile's sum.
# - fp32: −1.5, set by dg's accuracy; by overflow alone its 32-token tiles
#   would take −2.5. dg is the reverse cumsum of q⊙dq − k⊙dk, whose terms
#   stay near max|q⊙dq| while dg shrinks as the decay strengthens, so the
#   identity amplifies the rounding of dq and dk by κ = max|q⊙dq| /
#   max|dg| (2.8 at −1.5, 4.7 at −2.0, 7.8 at −2.5 on the inputs of
#   scripts/gla_fp32_dg_drift.py). JAX's Pallas bwd and the plain version
#   carry at most 9.2e-7·κ there (tests/test_torch_gated_train.py,
#   test_fp32_dg_error_is_rounding_amplified_by_the_identity); the FMA
#   route, whose dq and dk round about twice as much, 1.3-1.8e-6·κ: 5.2e-6
#   of max|dg| at −1.5, 6.8e-6 at −2.0, 1.04e-5 at −2.5, past the route's
#   1e-5 of gla_scan (PERF.md §6). −1.5 leaves a margin of about 2 for
#   inputs of larger κ.
DECAY_LIMIT = {torch.bfloat16: -1.25, torch.float32: -1.5}


def _nbytes(*ts: Optional[Tensor]) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def _ops(q: Tensor, products: int, exps: int = 1) -> int:
    """``products`` passes of 2·T·D² a row against the D × D state, and
    ``exps`` operations a decay element."""
    bh, t, d = q.shape
    return products * bh * t * 2 * d * d + exps * bh * t * d


def fwd_work(q: Tensor, k: Tensor, v: Tensor, g: Tensor, *,
             u: Optional[Tensor] = None, exclusive: bool = False
             ) -> Tuple[int, int]:
    """B8: q, k, v, g (and u) read, o and the fp32 state written."""
    bh, _, d = q.shape
    return (_ops(q, 2, 3 if exclusive else 1),
            _nbytes(q, k, v, v, g, u if exclusive else None) + bh * d * d * 4)


def bwd_dq_work(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor
                ) -> Tuple[int, int]:
    """B9's dq launch: q, k, v, g, do read, dq and q⊙dq (fp32) written."""
    return _ops(q, 2), _nbytes(q, k, v, do, q, g, g)


def bwd_dkv_work(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor
                 ) -> Tuple[int, int]:
    """B9's dk/dv launch: q, k, v, g, do, q⊙dq read, dk, dv, dg written."""
    return _ops(q, 3), _nbytes(q, k, v, do, k, v, g, g, g)


def bwd_work(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor
             ) -> Tuple[int, int]:
    """B9 as a function: q, k, v, g, do read once, dq, dk, dv, dg
    written."""
    return _ops(q, 5), _nbytes(q, k, v, do, q, k, v, g, g)


def bwd_exclusive_dq_work(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                          do: Tensor, u: Tensor) -> Tuple[int, int]:
    """The exclusive backward's dq launch: B9's, with u read and du per
    row (fp32 (BH, D)) written."""
    bh, _, d = q.shape
    return _ops(q, 2), _nbytes(q, k, v, do, q, g, g, u) + bh * d * 4


def bwd_exclusive_dkv_work(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                           do: Tensor, u: Tensor) -> Tuple[int, int]:
    """The exclusive backward's dk/dv launch: B9's, with u read."""
    return _ops(q, 3), _nbytes(q, k, v, do, k, v, g, g, g, u)


def bwd_exclusive_work(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                       do: Tensor, u: Tensor) -> Tuple[int, int]:
    """The exclusive backward as a function: B9's, u read, du written."""
    return _ops(q, 5), _nbytes(q, k, v, do, q, k, v, g, g, u, u)


def load() -> ctypes.CDLL:
    """Build (at first use) and load the kernel library."""
    lib = build.load_library(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.gated_linear_attention_fwd.argtypes = [ptr] * 7 + [i32] * 6 + [
        f32, ptr]
    lib.gated_linear_attention_bwd_dq.argtypes = [ptr] * 7 + [i32] * 4 + [
        f32, ptr]
    lib.gated_linear_attention_bwd_dkv.argtypes = [ptr] * 9 + [i32] * 4 + [
        f32, ptr]
    lib.gated_linear_attention_bwd_exclusive_dq.argtypes = [ptr] * 9 + [
        i32] * 5 + [f32, ptr]
    lib.gated_linear_attention_bwd_exclusive_dkv.argtypes = [ptr] * 10 + [
        i32] * 5 + [f32, ptr]
    for fn in (lib.gated_linear_attention_fwd,
               lib.gated_linear_attention_bwd_dq,
               lib.gated_linear_attention_bwd_dkv,
               lib.gated_linear_attention_bwd_exclusive_dq,
               lib.gated_linear_attention_bwd_exclusive_dkv):
        fn.restype = ctypes.c_int
    return lib


def _check_gated(kernel: str, chunk: int, g: Tensor, min_log_decay: float,
                 **tensors: Tensor) -> None:
    """What the kernels take: B2/B3's rows (contiguous (BH, T, D) of one
    type, D in their HEAD_DIMS, so Dk = Dv, on one CUDA device, T a
    multiple of ``chunk``), a contiguous fp32 log-decay g of the same
    shape, and a ``min_log_decay`` no lower than the type's
    ``DECAY_LIMIT``."""
    _check(kernel, chunk, **tensors)
    first = next(iter(tensors.values()))
    if g.shape != first.shape or g.dtype != torch.float32 or \
            g.device != first.device or not g.is_contiguous():
        raise ValueError(f"{kernel}: g is {g.dtype} {tuple(g.shape)} on "
                         f"{g.device}, expected a contiguous float32 "
                         f"{tuple(first.shape)} on {first.device}")
    limit = DECAY_LIMIT[first.dtype]
    if not min_log_decay >= limit:
        raise ValueError(f"{kernel}: min_log_decay {min_log_decay} is below "
                         f"the {first.dtype} route's limit {limit}")


def _check_qdq(kernel: str, qdq: Tensor, q: Tensor) -> None:
    """The dk/dv launches' q⊙dq: contiguous fp32 of q's shape and
    device."""
    if qdq.shape != q.shape or qdq.dtype != torch.float32 or \
            qdq.device != q.device or not qdq.is_contiguous():
        raise ValueError(f"{kernel}: q⊙dq is {qdq.dtype} "
                         f"{tuple(qdq.shape)} on {qdq.device}, expected a "
                         f"contiguous float32 {tuple(q.shape)} on {q.device}")


def _u_heads(kernel: str, u: Tensor, bh: int, d: int,
             device: torch.device) -> int:
    """The exclusive form's bonus as the kernels take it: a contiguous
    fp32 (Dk,) tensor for every row, or (H, Dk) per head with H dividing
    the BH rows (row r reads u[r % H]), on the rows' device. Returns H (1
    for (Dk,))."""
    heads = u.shape[0] if u.ndim == 2 else 1
    if u.shape[-1:] != (d,) or u.ndim > 2 or heads < 1 or bh % heads or \
            u.dtype != torch.float32 or u.device != device or \
            not u.is_contiguous():
        raise ValueError(f"{kernel}: u must be a contiguous fp32 ({d},) or "
                         f"(H, {d}) tensor with H dividing {bh} rows, on "
                         f"{device}; got {u.dtype} {tuple(u.shape)} on "
                         f"{u.device}")
    return heads


def fwd(q: Tensor, k: Tensor, v: Tensor, g: Tensor, *,
        u: Optional[Tensor] = None, chunk: int = 128,
        exclusive: bool = False, min_log_decay: float = MIN_LOG_DECAY,
        kernel: bool = True) -> Tuple[Tensor, Tensor]:
    """B8. q, k, g: (BH, T, Dk); v: (BH, T, Dv); g fp32; u: the exclusive
    form's bonus, (Dk,) for every row or (H, Dk) per head with H dividing
    BH (row r reads u[r % H]: rows batch-major, heads minor, as
    ``_rows`` flattens (B, H)), fp32, or None. Returns (o: (BH, T, Dv) in
    v's type, s: (BH, Dk, Dv) fp32 final state)."""
    work = fwd_work(q, k, v, g, u=u, exclusive=exclusive)
    if not kernel or _on_cpu(q):
        record_kernel("gated_linear_attention_fwd", work, "plain")
        return chunked_fwd_ref(q, k, v, g, u=u, chunk=chunk,
                               exclusive=exclusive,
                               min_log_decay=min_log_decay)
    _check_gated("gated_linear_attention_fwd", chunk, g, min_log_decay,
                 q=q, k=k, v=v)
    bh, t, d = q.shape
    u_heads = 1
    if exclusive:
        u = (torch.zeros(d, dtype=torch.float32, device=q.device)
             if u is None else u)
        u_heads = _u_heads("gated_linear_attention_fwd", u, bh, d, q.device)
    o = torch.empty_like(v)
    s = torch.empty((bh, d, d), dtype=torch.float32, device=q.device)
    if is_fake(q):
        record_kernel("gated_linear_attention_fwd", work, "fake")
        return o, s
    if bh == 0 or t == 0:
        return o, s.zero_()
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.gated_linear_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            u.data_ptr() if exclusive else None, o.data_ptr(), s.data_ptr(),
            bh, t, d, _DTYPES[q.dtype], int(exclusive), u_heads,
            min_log_decay, _stream(q))
    _raise_on("gated_linear_attention_fwd", err)
    fwd.launches += 1
    record_kernel("gated_linear_attention_fwd", work, "kernel")
    return o, s


fwd.launches = 0


def bwd_dq(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor, *,
           chunk: int = 128, min_log_decay: float = MIN_LOG_DECAY
           ) -> Tuple[Tensor, Tensor]:
    """B9's forward sweep on CUDA rows: (dq in q's type, q⊙dq fp32), with
    dq = exp(b) ⊙ [(dO Vᵀ ⊙ M) K̂ + dO Sᵀ] (``ref.bwd_dq_ref``). bf16: one
    launch writes both (q⊙dq as Q̂ ⊙ dq e^{-b}, Q̂ rounded as the dk/dv
    launch rounds it); fp32: the launch writes dq and q⊙dq is formed
    here."""
    _check_gated("gated_linear_attention_bwd_dq", chunk, g, min_log_decay,
                 q=q, k=k, v=v, do=do)
    bh, t, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    dq = torch.empty_like(q)
    qdq = torch.empty((bh, t, d), dtype=torch.float32, device=q.device) \
        if bf16 else None
    work = bwd_dq_work(q, k, v, g, do)
    if is_fake(q):
        record_kernel("gated_linear_attention_bwd_dq", work, "fake")
        return dq, qdq if bf16 else torch.empty_like(g)
    if bh == 0 or t == 0:
        return dq, qdq if bf16 else q * dq
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.gated_linear_attention_bwd_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            do.data_ptr(), dq.data_ptr(), qdq.data_ptr() if bf16 else None,
            bh, t, d, _DTYPES[q.dtype], min_log_decay, _stream(q))
    _raise_on("gated_linear_attention_bwd_dq", err)
    bwd_dq.launches += 1
    record_kernel("gated_linear_attention_bwd_dq", work, "kernel")
    return dq, qdq if bf16 else q * dq


bwd_dq.launches = 0


def bwd_dkv(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor,
            qdq: Tensor, *, chunk: int = 128,
            min_log_decay: float = MIN_LOG_DECAY
            ) -> Tuple[Tensor, Tensor, Tensor]:
    """B9's reverse sweep on CUDA rows, one launch: (dk in k's type, dv in
    v's type, dg fp32) from R = Σ_{later} q̂ doᵀ recomputed from the end
    and the dq launch's q⊙dq (``ref.bwd_dkv_dg_ref``). bf16: the launch
    writes all three; fp32: it writes dk and dv, and dg is formed here."""
    _check_gated("gated_linear_attention_bwd_dkv", chunk, g, min_log_decay,
                 q=q, k=k, v=v, do=do)
    _check_qdq("gated_linear_attention_bwd_dkv", qdq, q)
    bh, t, d = q.shape
    bf16 = q.dtype == torch.bfloat16
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dg = torch.empty_like(g)
    work = bwd_dkv_work(q, k, v, g, do)
    if is_fake(q):
        record_kernel("gated_linear_attention_bwd_dkv", work, "fake")
        return dk, dv, dg
    if bh == 0 or t == 0:
        return dk, dv, dg
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.gated_linear_attention_bwd_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            do.data_ptr(), qdq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
            dg.data_ptr() if bf16 else None, bh, t, d, _DTYPES[q.dtype],
            min_log_decay, _stream(q))
    _raise_on("gated_linear_attention_bwd_dkv", err)
    bwd_dkv.launches += 1
    record_kernel("gated_linear_attention_bwd_dkv", work, "kernel")
    if not bf16:
        dg = ref.dg_from_qdq(qdq, k, g, dk, min_log_decay=min_log_decay)
    return dk, dv, dg


bwd_dkv.launches = 0


def bwd(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor, *,
        chunk: int = 128, min_log_decay: float = MIN_LOG_DECAY,
        kernel: bool = True) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """B9, the inclusive form's recompute backward: (dq, dk, dv, dg) from
    q, k, v, g and do alone, in q's, k's, v's and g's types. On CUDA the
    dq launch, then the dk/dv launch, which also forms dg from the first's
    q⊙dq (JAX runs that epilogue outside the pallas_call)."""
    if not kernel or _on_cpu(q):
        record_kernel("gated_linear_attention_bwd_dq",
                      bwd_dq_work(q, k, v, g, do), "plain")
        record_kernel("gated_linear_attention_bwd_dkv",
                      bwd_dkv_work(q, k, v, g, do), "plain")
        return chunked_bwd_ref(q, k, v, g, do, chunk=chunk,
                               min_log_decay=min_log_decay)
    dq, qdq = bwd_dq(q, k, v, g, do, chunk=chunk,
                     min_log_decay=min_log_decay)
    dk, dv, dg = bwd_dkv(q, k, v, g, do, qdq, chunk=chunk,
                         min_log_decay=min_log_decay)
    return dq, dk, dv, dg


def bwd_exclusive_dq(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                     do: Tensor, u: Tensor, *, chunk: int = 128,
                     min_log_decay: float = MIN_LOG_DECAY
                     ) -> Tuple[Tensor, Tensor, Tensor]:
    """The exclusive backward's forward sweep on CUDA rows:
    (dq in q's type, the decay's share of q⊙dq fp32, du_rows (BH, Dk)
    fp32), as ``ref.bwd_exclusive_dq_ref``. bf16: one launch writes all
    three; fp32: the launch writes dq (its bonus included) and q⊙dq and
    du_rows are formed here."""
    _check_gated("gated_linear_attention_bwd_exclusive_dq", chunk, g,
                 min_log_decay, q=q, k=k, v=v, do=do)
    bh, t, d = q.shape
    u_heads = _u_heads("gated_linear_attention_bwd_exclusive_dq", u, bh, d,
                       q.device)
    bf16 = q.dtype == torch.bfloat16
    dq = torch.empty_like(q)
    qdq = torch.empty((bh, t, d), dtype=torch.float32, device=q.device)
    du_rows = torch.zeros((bh, d), dtype=torch.float32, device=q.device)
    work = bwd_exclusive_dq_work(q, k, v, g, do, u)
    if is_fake(q):
        record_kernel("gated_linear_attention_bwd_exclusive_dq", work,
                      "fake")
        return dq, qdq, du_rows
    if bh == 0 or t == 0:
        return dq, qdq, du_rows
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.gated_linear_attention_bwd_exclusive_dq(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            do.data_ptr(), u.data_ptr(), dq.data_ptr(),
            qdq.data_ptr() if bf16 else None,
            du_rows.data_ptr() if bf16 else None, bh, t, d,
            _DTYPES[q.dtype], u_heads, min_log_decay, _stream(q))
    _raise_on("gated_linear_attention_bwd_exclusive_dq", err)
    bwd_exclusive_dq.launches += 1
    record_kernel("gated_linear_attention_bwd_exclusive_dq", work, "kernel")
    if not bf16:
        dov = (do * v).sum(-1, keepdim=True)
        qdq = q * dq - dov * q * ref._u_rows(u, bh) * k
        du_rows = (dov * q * k).sum(1)
    return dq, qdq, du_rows


bwd_exclusive_dq.launches = 0


def bwd_exclusive_dkv(q: Tensor, k: Tensor, v: Tensor, g: Tensor,
                      do: Tensor, u: Tensor, qdq: Tensor, *,
                      chunk: int = 128, min_log_decay: float = MIN_LOG_DECAY
                      ) -> Tuple[Tensor, Tensor, Tensor]:
    """The exclusive backward's reverse sweep on CUDA rows, one launch:
    (dk in k's type, dv in v's type, dg fp32) from the dq launch's q⊙dq,
    as ``ref.bwd_exclusive_dkv_ref``. bf16: the launch writes all three;
    fp32: it writes dk and dv (their bonuses included), and dg is formed
    here from the decay's share of k⊙dk."""
    _check_gated("gated_linear_attention_bwd_exclusive_dkv", chunk, g,
                 min_log_decay, q=q, k=k, v=v, do=do)
    _check_qdq("gated_linear_attention_bwd_exclusive_dkv", qdq, q)
    bh, t, d = q.shape
    u_heads = _u_heads("gated_linear_attention_bwd_exclusive_dkv", u, bh, d,
                       q.device)
    bf16 = q.dtype == torch.bfloat16
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    dg = torch.empty_like(g)
    work = bwd_exclusive_dkv_work(q, k, v, g, do, u)
    if is_fake(q):
        record_kernel("gated_linear_attention_bwd_exclusive_dkv", work,
                      "fake")
        return dk, dv, dg
    if bh == 0 or t == 0:
        return dk, dv, dg
    lib = load()
    with torch.cuda.device(q.device):
        err = lib.gated_linear_attention_bwd_exclusive_dkv(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(),
            do.data_ptr(), u.data_ptr(), qdq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), dg.data_ptr() if bf16 else None, bh, t, d,
            _DTYPES[q.dtype], u_heads, min_log_decay, _stream(q))
    _raise_on("gated_linear_attention_bwd_exclusive_dkv", err)
    bwd_exclusive_dkv.launches += 1
    record_kernel("gated_linear_attention_bwd_exclusive_dkv", work,
                  "kernel")
    if not bf16:
        dov = (do * v).sum(-1, keepdim=True)
        kdk = k * dk - dov * q * ref._u_rows(u, bh) * k
        dg = ref.dg_exclusive(qdq, kdk, g, min_log_decay=min_log_decay)
    return dk, dv, dg


bwd_exclusive_dkv.launches = 0


def bwd_exclusive(q: Tensor, k: Tensor, v: Tensor, g: Tensor, do: Tensor,
                  u: Tensor, *, chunk: int = 128,
                  min_log_decay: float = MIN_LOG_DECAY, kernel: bool = True
                  ) -> Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]:
    """The backward of B8's exclusive form with the bonus u ((Dk,), or
    (H, Dk) per head): (dq, dk, dv, dg, du) in q's, k's, v's and g's
    types and du fp32 in u's shape, from q, k, v, g, u and do alone. On
    CUDA the dq launch (with du per row, summed here over each head's
    rows), then the dk/dv launch, which forms dg."""
    if not kernel or _on_cpu(q):
        record_kernel("gated_linear_attention_bwd_exclusive_dq",
                      bwd_exclusive_dq_work(q, k, v, g, do, u), "plain")
        record_kernel("gated_linear_attention_bwd_exclusive_dkv",
                      bwd_exclusive_dkv_work(q, k, v, g, do, u), "plain")
        return chunked_bwd_exclusive_ref(q, k, v, g, do, u, chunk=chunk,
                                         min_log_decay=min_log_decay)
    dq, qdq, du_rows = bwd_exclusive_dq(q, k, v, g, do, u, chunk=chunk,
                                        min_log_decay=min_log_decay)
    dk, dv, dg = bwd_exclusive_dkv(q, k, v, g, do, u, qdq, chunk=chunk,
                                   min_log_decay=min_log_decay)
    return dq, dk, dv, dg, ref._head_sum(du_rows, u)


class _GatedLinearAttention(torch.autograd.Function):
    """The custom VJP of the JAX wrapper: forward B8, backward B9, and
    only (q, k, v, g) kept for the backward."""

    @staticmethod
    def forward(ctx, q, k, v, g, chunk, min_log_decay, kernel):
        o, _ = fwd(q, k, v, g, chunk=chunk, min_log_decay=min_log_decay,
                   kernel=kernel)
        ctx.save_for_backward(q, k, v, g)
        ctx.chunk, ctx.min_log_decay, ctx.kernel = chunk, min_log_decay, \
            kernel
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, g = ctx.saved_tensors
        dq, dk, dv, dg = bwd(q, k, v, g, do.contiguous(), chunk=ctx.chunk,
                             min_log_decay=ctx.min_log_decay,
                             kernel=ctx.kernel)
        return dq, dk, dv, dg, None, None, None


def _flat_inputs(q: Tensor, k: Tensor, v: Tensor, log_decay: Tensor,
                 chunk: int):
    """The JAX wrapper's preparation: g broadcast to q's shape in fp32,
    (B, H, T, D) → (B·H, T_pad, D) rows, zero-padded (log-decay 0 at the
    padded positions, so they decay nothing)."""
    t = q.shape[2]
    c, t_pad = _chunk_and_pad(t, chunk)
    g = log_decay.to(torch.float32).expand(q.shape)
    return c, [_rows(x, t_pad) for x in (q, k, v, g)]


def gated_linear_attention(q: Tensor, k: Tensor, v: Tensor,
                           log_decay: Tensor, *, chunk: int = 128,
                           min_log_decay: float = MIN_LOG_DECAY,
                           kernel: bool = True) -> Tensor:
    """Inclusive decay-gated causal linear attention, differentiable.
    q, k: (B, H, T, Dk); v: (B, H, T, Dv); log_decay broadcastable to q
    ((B, H, T, 1) for a per-head decay, whose dg autograd sums back over
    Dk). The backward is B9's recompute (no stored states). Returns o in
    v's type."""
    b, h, t, _ = q.shape
    dv = v.shape[-1]
    c, rows = _flat_inputs(q, k, v, log_decay, chunk)
    o = _GatedLinearAttention.apply(*rows, c, min_log_decay, kernel)
    return o[:, :t].reshape(b, h, t, dv)


class _RWKV6Attention(torch.autograd.Function):
    """The exclusive form with the bonus u under autograd: forward B8's
    exclusive route, backward ``bwd_exclusive``, only (q, k, v, g, u)
    kept. The final state is an output without a gradient."""

    @staticmethod
    def forward(ctx, q, k, v, g, u, chunk, min_log_decay, kernel):
        o, s = fwd(q, k, v, g, u=u, chunk=chunk, exclusive=True,
                   min_log_decay=min_log_decay, kernel=kernel)
        ctx.save_for_backward(q, k, v, g, u)
        ctx.chunk, ctx.min_log_decay, ctx.kernel = chunk, min_log_decay, \
            kernel
        ctx.mark_non_differentiable(s)
        return o, s

    @staticmethod
    def backward(ctx, do, _ds):
        q, k, v, g, u = ctx.saved_tensors
        grads = bwd_exclusive(q, k, v, g, do.contiguous(), u,
                              chunk=ctx.chunk,
                              min_log_decay=ctx.min_log_decay,
                              kernel=ctx.kernel)
        return (*grads, None, None, None)


def rwkv6_attention(q: Tensor, k: Tensor, v: Tensor, log_decay: Tensor,
                    u: Tensor, *, chunk: int = 128,
                    min_log_decay: float = MIN_LOG_DECAY,
                    kernel: bool = True) -> Tuple[Tensor, Tensor]:
    """RWKV-6 convention (exclusive + bonus u: (Dk,), or (H, Dk) per head
    as the RWKV-6 model keeps it): returns (o: (B, H, T, Dv) in v's type,
    final state (B, H, Dk, Dv) fp32, which carries no gradient). On a
    CUDA tensor one B8 launch covers every head; where a gradient is
    wanted the exclusive backward (two launches) follows in the backward
    pass."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c, rows = _flat_inputs(q, k, v, log_decay, chunk)
    o, s = _RWKV6Attention.apply(*rows, u.to(torch.float32).contiguous(),
                                 c, min_log_decay, kernel)
    return o[:, :t].reshape(b, h, t, dv), s.reshape(b, h, dk, dv)


def ssd_attention(q: Tensor, k: Tensor, v: Tensor, log_decay: Tensor, *,
                  chunk: int = 128, min_log_decay: float = MIN_LOG_DECAY,
                  kernel: bool = True) -> Tuple[Tensor, Tensor]:
    """The inclusive form with its final state, forward only (the Mamba-2
    SSD prefill, JAX's ``chunked_gla``): q, k (B, H, T, Dk), which may be
    views broadcast over H (Mamba-2's C and B); v (B, H, T, Dv);
    log_decay broadcastable to q, (B, H, T, 1) for one decay a head,
    expanded to (B·H, T, Dk) in fp32. Returns (o: (B, H, T, Dv) in v's
    type, final state (B, H, Dk, Dv) fp32). On a CUDA tensor one B8
    launch covers every head."""
    b, h, t, dk = q.shape
    dv = v.shape[-1]
    c, rows = _flat_inputs(q, k, v, log_decay, chunk)
    o, s = fwd(*rows, chunk=c, min_log_decay=min_log_decay, kernel=kernel)
    return o[:, :t].reshape(b, h, t, dv), s.reshape(b, h, dk, dv)
