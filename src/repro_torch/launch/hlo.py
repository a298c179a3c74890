"""Per-device accounting of one traced step: dot FLOPs, HBM bytes,
collectives and memory (port of ``repro/launch/hlo.py``).

JAX compiles a step and parses the partitioned HLO text. The port runs
eagerly, so there is no HLO: ``analyze_step`` walks the aten ops of one
call instead, under a ``TorchDispatchMode``, on fake tensors (the dry
run: ``FakeTensorMode``, no storage) or on real ones. The module keeps
its JAX name so that the port mirrors the JAX package module for module.
No trip counts are needed: eager execution visits every layer, every
microbatch and every chunk.

JAX's rules, class by class (``_MAJOR_READ_WRITE`` and
``_MAJOR_RESULT_ONLY``, the "major" bytes model), over aten ops:

=============================================  ==========================
aten op                                        counted
=============================================  ==========================
mm, addmm, bmm, baddbmm, convolution,          dot FLOPs (torch's
_scaled_dot_product_* and the flash /          ``flop_counter`` formulas);
efficient attention ops (``dot``,              operands read, result
``convolution``)                               written
embedding, index, index_select, gather         operands read, result
(``gather``); scatter, scatter_add,            written
index_add, index_put, index_copy,
masked_scatter (``scatter``); copy_,
clone, _to_copy (``copy``)
sum, mean, amax, amin, max, min, var, std,     the data operand read and
prod, norm, logsumexp, argmax, argmin,         the result written
cumsum, cumprod (``reduce``,
``reduce-window``)
sort, topk (``sort``)                          the result written
_c10d_functional collectives                   result in and out (2×);
                                               a ``CollectiveOp`` each
every other op (elementwise, views,            0: fused into a consumer
reshapes, cat, pads, casts in place)           on the card, as XLA fuses
=============================================  ==========================

Bool results are skipped, as JAX skips ``pred`` tensors. ``score_bytes``
are the bytes of attention score blocks (float, trailing dims equal and
≥ 256; JAX's ``_is_score_block``) and of attention accumulators written
into (fp32, dims[-2] ≥ 256; ``_is_attn_accum``): a fused kernel keeps
them on chip.

Collectives: ``_c10d_functional`` ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` (each with its group's size), and point-to-point
sends as ``collective-permute``. Inside DTensor's redistribution
(``redistribute_local_tensor``) only the collectives (and the memory)
count: the local copies that lay out a gathered block are not model
work; DTensor's sharding propagation, which runs each op on fake tensors
of the global shapes, counts for nothing.

The hand-written kernels are ``ctypes`` launches, which the dispatch
mode cannot see. So each wrapper reports its work (``work()`` in each
``kernels/*/ops.py``: each input read and each output written once;
PERF.md §6's operation counts) through ``record_kernel`` on every call,
with its route: ``kernel`` (launched), ``fake`` (a fake tensor: the
wrapper returns outputs of the kernel's shapes and launches nothing) or
``plain`` (the plain PyTorch version ran, whose aten ops are counted as
any others; its reported work is kept for the record only).

Memory (the counterpart of ``memory_analysis()``): ``argument_bytes``,
the storages the call was given; the peak of the storages created in the
call and alive (``live_peak_bytes``); ``output_bytes``, the storages of
what it returns, ``alias_bytes`` those among them that were arguments
(parameters and moments updated in place, a decode state), and
``temp_bytes`` the peak less the new outputs, so that argument + temp +
output − alias is the call's peak.

Per-collective wire bytes use ring-algorithm payloads with group size S:

    all-reduce         2 · bytes · (S−1)/S     (reduce-scatter + all-gather)
    all-gather         bytes · (S−1)/S         (bytes = gathered result)
    reduce-scatter     bytes_result · (S−1)
    all-to-all         bytes · (S−1)/S
    collective-permute bytes
"""

from __future__ import annotations

import contextlib
import dataclasses
import sys
import weakref
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor

_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "send": "collective-permute", "isend": "collective-permute",
}
_READ_WRITE = {
    "embedding", "index", "index_select", "gather", "take",
    "scatter", "scatter_", "scatter_add", "scatter_add_", "scatter_reduce",
    "index_add", "index_add_", "index_put", "index_put_", "index_copy",
    "index_copy_", "masked_scatter", "_unsafe_index_put", "copy", "copy_",
    "clone", "_to_copy",
}
_REDUCE = {
    "sum", "mean", "amax", "amin", "max", "min", "var", "std", "prod",
    "norm", "linalg_vector_norm", "logsumexp", "argmax", "argmin",
    "cumsum", "cumprod", "var_mean", "std_mean",
}
_SORT = {"sort", "topk"}


def _tensors(x) -> List[torch.Tensor]:
    out = []
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for v in x:
            out.extend(_tensors(v))
    elif isinstance(x, dict):
        for v in x.values():
            out.extend(_tensors(v))
    return out


def _nbytes(t: torch.Tensor) -> int:
    """The bytes of ``t``'s distinct elements: a dim broadcast with stride
    0 (an expanded weight or state) is read once, however matmul folds
    it (real and fake tensors may fold it differently)."""
    n = t.element_size()
    for size, stride in zip(t.shape, t.stride()):
        if stride:
            n *= size
    return n


def _is_score_block(t: torch.Tensor) -> bool:
    """Float tensor with equal trailing dims ≥ 256 — an attention score
    block, kept on chip by a fused kernel."""
    if t.dtype not in (torch.float32, torch.bfloat16) or t.ndim < 2:
        return False
    return t.shape[-1] == t.shape[-2] and t.shape[-1] >= 256


def _is_attn_accum(t: torch.Tensor) -> bool:
    """fp32 (…, block ≥ 256, d) accumulators written into (the blockwise
    attention's acc, dq, dk, dv); decode KV caches are bf16 and state
    matrices have dims[-2] ≤ 128, so neither matches."""
    return t.dtype == torch.float32 and t.ndim >= 3 and t.shape[-2] >= 256


@dataclasses.dataclass
class CollectiveOp:
    kind: str
    result_bytes: int
    group_size: int
    computation: str
    multiplicity: int = 1

    @property
    def wire_bytes(self) -> float:
        s = max(self.group_size, 1)
        frac = (s - 1) / s if s > 1 else 0.0
        if self.kind == "all-reduce":
            return 2.0 * self.result_bytes * frac
        if self.kind == "all-gather":
            return self.result_bytes * frac
        if self.kind == "reduce-scatter":
            return float(self.result_bytes) * (s - 1)
        if self.kind == "all-to-all":
            return self.result_bytes * frac
        return float(self.result_bytes)


@dataclasses.dataclass
class KernelCall:
    """One call of a hand-written kernel's wrapper and its work."""
    name: str
    flops: float
    bytes: float
    route: str          # "kernel" | "fake" | "plain"


@dataclasses.dataclass
class ModuleAnalysis:
    """Per-device totals of one step."""
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0
    # bytes of attention score blocks (trailing dims equal, ≥ 256) that a
    # fused kernel keeps on chip; the memory term is reported with and
    # without them
    score_bytes: float = 0.0
    collectives: List[CollectiveOp] = dataclasses.field(default_factory=list)

    @property
    def collective_wire_bytes(self) -> float:
        return sum(o.wire_bytes * o.multiplicity for o in self.collectives)

    @property
    def collective_payload_bytes(self) -> float:
        return sum(o.result_bytes * o.multiplicity for o in self.collectives)

    def collective_by_kind(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        for o in self.collectives:
            out[o.kind] = out.get(o.kind, 0.0) + \
                o.wire_bytes * o.multiplicity
        return out

    def collective_count(self) -> int:
        return sum(o.multiplicity for o in self.collectives)


@dataclasses.dataclass
class StepAnalysis(ModuleAnalysis):
    """A traced step: the aten totals, the hand-written kernels' work and
    the memory of the call."""
    kernels: List[KernelCall] = dataclasses.field(default_factory=list)
    argument_bytes: int = 0
    output_bytes: int = 0
    alias_bytes: int = 0
    live_peak_bytes: int = 0
    temp_bytes: int = 0

    @property
    def kernel_flops(self) -> float:
        return sum(k.flops for k in self.kernels if k.route != "plain")

    @property
    def kernel_bytes(self) -> float:
        return sum(k.bytes for k in self.kernels if k.route != "plain")

    @property
    def flops(self) -> float:
        """Dot FLOPs plus the launched (or fake) kernels' operations."""
        return self.dot_flops + self.kernel_flops

    @property
    def bytes(self) -> float:
        """Major bytes plus the launched (or fake) kernels' bytes."""
        return self.hbm_bytes + self.kernel_bytes

    @property
    def peak_bytes(self) -> int:
        return (self.argument_bytes + self.temp_bytes + self.output_bytes
                - self.alias_bytes)

    def kernel_counts(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for k in self.kernels:
            out[k.name] = out.get(k.name, 0) + 1
        return out


# ---------------------------------------------------------------------------
# the kernels' reports
# ---------------------------------------------------------------------------

# the analyses open: one list for the process, since autograd runs a
# backward's kernels on its own device threads
_ACTIVE: List["StepAnalysis"] = []


def _open() -> List[StepAnalysis]:
    return _ACTIVE


def record_kernel(name: str, work, route: str) -> None:
    """A kernel wrapper's report of one call: ``work`` = (FLOPs, bytes),
    or a function giving them (called only under an analysis: a count
    that reads the data costs nothing otherwise), ``route`` "kernel",
    "fake" or "plain". Nothing happens outside ``analyze_step``."""
    stack = _open()
    if not stack:
        return
    flops, n_bytes = work() if callable(work) else work
    for a in stack:
        a.kernels.append(KernelCall(name, float(flops), float(n_bytes),
                                    route))


def is_fake(t) -> bool:
    """True for a ``FakeTensor`` (shapes and types, no storage)."""
    return isinstance(t, FakeTensor)


# ---------------------------------------------------------------------------
# the dispatch mode
# ---------------------------------------------------------------------------

def _group_size(name) -> int:
    from torch.distributed import distributed_c10d as c10d
    try:
        return c10d._resolve_process_group(name).size()
    except Exception:
        return c10d._get_group_size_by_name(name)


def _local(t: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return t._local_tensor if isinstance(t, DTensor) else t


def _storages(x) -> List[Any]:
    out = []
    for t in _tensors(x):
        t = _local(t)
        try:
            out.append(t.untyped_storage())
        except (RuntimeError, NotImplementedError):
            pass
    return out


@contextlib.contextmanager
def _dtensor_flags(state: Dict[str, int]):
    """Mark the ops DTensor runs for itself: ``redistributing`` inside
    ``redistribute_local_tensor`` (wherever a module binds it), where
    only the collectives and the memory count; ``propagating`` inside
    ``ShardingPropagator``'s propagation methods, which run the op on
    fake tensors of the global shapes to infer the output's, and count
    for nothing."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    patched = []

    def wrap(owner, name, fn, key):
        def wrapped(*a, **kw):
            state[key] += 1
            try:
                return fn(*a, **kw)
            finally:
                state[key] -= 1
        setattr(owner, name, wrapped)
        patched.append((owner, name, fn))

    for mod_name, mod in list(sys.modules.items()):
        if mod is not None and mod_name.startswith("torch.distributed.tensor"):
            fn = mod.__dict__.get("redistribute_local_tensor")
            if callable(fn):
                wrap(mod, "redistribute_local_tensor", fn, "redistributing")
    for name, fn in list(vars(ShardingPropagator).items()):
        if name.lstrip("_").startswith("propagate") and callable(fn) \
                and not isinstance(fn, (staticmethod, classmethod)):
            wrap(ShardingPropagator, name, fn, "propagating")
    try:
        yield
    finally:
        for owner, name, fn in reversed(patched):
            setattr(owner, name, fn)


class _Mode(torch.utils._python_dispatch.TorchDispatchMode):
    def __init__(self, an: StepAnalysis, redistributing: Dict[str, int]):
        super().__init__()
        self.an = an
        self.redistributing = redistributing
        self.known = torch.utils.weak.WeakIdKeyDictionary()
        self.live = 0
        self.created: List[Tuple[weakref.ref, int]] = []

    def register_arguments(self, args) -> int:
        total = 0
        for st in _storages(args):
            if st not in self.known:
                self.known[st] = "argument"
                total += st.nbytes()
        return total

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for st in _storages(out):
            if st in self.known:
                continue
            n = st.nbytes()
            self.known[st] = "created"
            self.created.append((weakref.ref(st), n))
            self.live += n
            self.an.live_peak_bytes = max(self.an.live_peak_bytes,
                                          self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.redistributing["propagating"]:
            return out
        self._track(out)
        self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out) -> None:
        from torch.utils.flop_counter import flop_registry
        an = self.an
        packet = func.overloadpacket
        name = packet.__name__
        ns = func.namespace
        results = _tensors(out)
        if ns in ("_c10d_functional", "c10d") and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            if kind == "collective-permute":
                res = _tensors(args)[:1]
                size = 2
            else:
                res = results[:1]
                gname = args[-1] if name != "all_to_all_single" \
                    else args[3]
                size = _group_size(gname)
            nb = sum(_nbytes(t) for t in res)
            an.collectives.append(CollectiveOp(kind, nb, size, name))
            an.hbm_bytes += 2.0 * nb
            return
        if self.redistributing["redistributing"]:
            return
        if packet in flop_registry:
            an.dot_flops += float(flop_registry[packet](
                *args, **kwargs, out_val=out))
            self._read_write(args, results)
            return
        if results and all(t.dtype == torch.bool for t in results):
            return
        if name in _READ_WRITE:
            if name == "copy_":       # a write into a slice: its source
                src = _tensors(args)[1:2]
                b = 2.0 * sum(_nbytes(t) for t in src)
                an.hbm_bytes += b
                if src and (_is_score_block(src[0])
                            or _is_attn_accum(src[0])):
                    an.score_bytes += b
                return
            self._read_write(args, results)
        elif name in _REDUCE:
            data = _tensors(args)[:1]
            b = sum(_nbytes(t) for t in results + data)
            an.hbm_bytes += b
            an.score_bytes += sum(_nbytes(t) for t in results + data
                                  if _is_score_block(t))
        elif name in _SORT:
            an.hbm_bytes += sum(_nbytes(t) for t in results)

    def _read_write(self, args, results) -> None:
        ts = results + [t for t in _tensors(args) if t.dtype != torch.bool]
        self.an.hbm_bytes += sum(_nbytes(t) for t in ts)
        self.an.score_bytes += sum(_nbytes(t) for t in ts
                                   if _is_score_block(t))


def analyze_step(fn: Callable, *args, **kwargs) -> Tuple[Any, StepAnalysis]:
    """Run ``fn(*args, **kwargs)`` once under the accounting mode and
    return (its result, the ``StepAnalysis``). Under ``FakeTensorMode``
    enter that mode first: this one must see each op before it."""
    an = StepAnalysis()
    redistributing = {"redistributing": 0, "propagating": 0}
    mode = _Mode(an, redistributing)
    an.argument_bytes = mode.register_arguments((args, kwargs))
    _open().append(an)
    try:
        with _dtensor_flags(redistributing), mode:
            out = fn(*args, **kwargs)
    finally:
        _open().remove(an)
    arg_ids = {id(st) for st in _storages((args, kwargs))}
    seen = set()
    for st in _storages(out):
        if id(st) in seen:
            continue
        seen.add(id(st))
        an.output_bytes += st.nbytes()
        if id(st) in arg_ids:
            an.alias_bytes += st.nbytes()
    new_out = an.output_bytes - an.alias_bytes
    an.temp_bytes = max(an.live_peak_bytes - new_out, 0)
    return out, an
