"""Memory-serving lookup engine, the paper's encode-once / look-up-many
workload (port of ``repro/serving/lookup_engine.py``).

* **Ingest once.** Documents arrive as token sequences and are encoded by
  the paper's GRU encoder in bucket-padded varlen waves: one call encodes
  a wave of documents of different lengths, compresses each to its
  fixed-size state and writes the states into the resident store. Each
  row's length mask keeps the padded tail out of its Σ h hᵀ (the GRU is
  causal, so the padding cannot reach a valid step).
* **Pin thousands resident.** The store is one stacked ``(N, k, k)``
  tensor on the device (plus ``(N, k)`` normalisers when enabled) whose
  capacity doubles: admitting memory number 10,000 is an O(k²) row
  write. Every memory has the same shape whatever its document's length:
  that is the paper's fixed-size-representation claim, and it is what
  lets a query wave mix documents.
* **Serve heterogeneous query waves.** Queued queries against arbitrary
  memories are flattened into ONE launch of the ``mass_lookup_indexed``
  CUDA kernel (``kernels/lookup``): each wave row names its own memory.
  Wave shapes are padded to power-of-2 buckets.

A :class:`LookupBackend` owns the memory layout and the engine stays a
scheduler: bounded admission queue with ``reject_new`` / ``evict_lowest``
shedding, priority order, and a :class:`LookupStats` counter block.
:class:`SoftmaxLookupBackend` is the paper's honest baseline behind the
same scheduler: it keeps every document's full ``(n, k)`` hidden states
resident and rescans them per query.

Where the JAX engine returns a new store from a jitted program, this one
writes the store's rows in place (``index_copy_``).

Durability: ``save_checkpoint`` / ``restore_checkpoint`` / ``recover``
write and read the whole engine (the store as the ``{"store": ...}``
tree, the rest in ``extra``) in JAX's format, so either package restores
the other's; :class:`HedgedLookup` runs replicas of the engine behind
one queue and duplicates a request still unanswered ``hedge_after``
ticks later to a second replica, the first answer winning.
"""

from __future__ import annotations

import collections
import dataclasses
import json
from typing import Any, Deque, Dict, List, Optional, Tuple, Type, Union

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.linear_attention import safe_denom
from repro_torch.core.state import DocumentState, gram
from repro_torch.device import resolve_device
from repro_torch.kernels.lookup import ops as lookup_ops
from repro_torch.qa.gru import gru_scan
from repro_torch.serving.lifecycle import (
    SHED_POLICIES, STATUS_CANCELLED, STATUS_OK, STATUS_SHED,
)

Tensor = torch.Tensor
Store = Dict[str, Tensor]


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (bucket widths for padded admission)."""
    return 1 << (int(n) - 1).bit_length()


def _itemsize(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


# ---------------------------------------------------------------------------
# the backend seam: engine = scheduler, backend = memory layout
# ---------------------------------------------------------------------------

class LookupBackend:
    """Memory-layout seam of the lookup engine.

    A backend owns the resident store's layout (``init_store``,
    ``grow_store``, ``write_rows``), the compression of varlen hidden
    states into per-document payloads (``compress``) and the batched
    heterogeneous ``lookup_wave``. ``fixed_size_memory`` says whether a
    document's resident bytes are O(k²) whatever its length (the paper's
    property; False for the softmax baseline); ``memory_bytes(n_tokens)``
    gives those bytes for one document.
    """

    name: str = "base"
    fixed_size_memory: bool = True

    def __init__(self, k: int, *, normalize: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None):
        self.k = k
        self.normalize = normalize
        self.dtype = dtype
        self.device = resolve_device(device)

    def memory_bytes(self, n_tokens: int) -> int:
        raise NotImplementedError

    def init_store(self, capacity: int) -> Store:
        raise NotImplementedError

    def grow_store(self, store: Store, capacity: int, n_cap: int) -> Store:
        raise NotImplementedError

    def compress(self, h: Tensor, mask: Tensor) -> Store:
        """Varlen hidden states (B, W, k) and validity mask (B, W) -> the
        per-row payload that ``write_rows`` writes."""
        raise NotImplementedError

    def payload_from_hidden(self, h: Tensor) -> Store:
        """Batch-1 payload from one document's exact-length hidden states."""
        ones = torch.ones(h.shape[:-1], dtype=h.dtype, device=h.device)
        return self.compress(h[None], ones[None])

    def write_rows(self, store: Store, rows: Tensor, payload: Store) -> None:
        """Write a wave of payload rows into ``store``, in place."""
        raise NotImplementedError

    def lookup_wave(self, store: Store, rows: Tensor, q: Tensor) -> Tensor:
        """Answer q: (B, M, k) with per-row memory indices rows: (B,)."""
        raise NotImplementedError


LOOKUP_BACKENDS: Dict[str, Type[LookupBackend]] = {}


def register_lookup_backend(cls: Type[LookupBackend]
                            ) -> Type[LookupBackend]:
    if cls.name in LOOKUP_BACKENDS:
        raise ValueError(f"duplicate lookup backend {cls.name!r}")
    LOOKUP_BACKENDS[cls.name] = cls
    return cls


def get_lookup_backend(name: str) -> Type[LookupBackend]:
    if name not in LOOKUP_BACKENDS:
        raise KeyError(f"unknown lookup backend {name!r}; registered: "
                       f"{list(LOOKUP_BACKENDS)}")
    return LOOKUP_BACKENDS[name]


@register_lookup_backend
class LinearLookupBackend(LookupBackend):
    """The paper's fixed-size memory: one k×k state per document.

    ``lookup_wave`` goes through ``ops.mass_lookup_indexed``, which
    launches the B4 CUDA kernel for CUDA tensors (its plain version for
    CPU tensors), and divides by the normaliser after it.
    ``use_kernel=False`` asks for the plain gather-einsum instead; only
    the tests and ``chip_smoke.py``'s comparison pass it.
    """

    name = "linear"
    fixed_size_memory = True

    def __init__(self, k: int, *, normalize: bool = False,
                 dtype: torch.dtype = torch.float32,
                 device: Optional[torch.device] = None, block_m: int = 128,
                 use_kernel: Optional[bool] = None):
        super().__init__(k, normalize=normalize, dtype=dtype, device=device)
        self.block_m = block_m
        self.use_kernel = True if use_kernel is None else use_kernel

    def memory_bytes(self, n_tokens: int) -> int:
        n = self.k * self.k * _itemsize(self.dtype)
        if self.normalize:
            n += self.k * _itemsize(self.dtype)
        return n

    def init_store(self, capacity: int) -> Store:
        zeros = lambda *shape: torch.zeros(shape, dtype=self.dtype,
                                           device=self.device)
        store = {"c": zeros(capacity, self.k, self.k)}
        if self.normalize:
            store["z"] = zeros(capacity, self.k)
        return store

    def grow_store(self, store: Store, capacity: int, n_cap: int) -> Store:
        del n_cap  # fixed-size memories have no token axis to grow
        pad = capacity - store["c"].shape[0]
        return {k: F.pad(v, (0, 0) * (v.ndim - 1) + (0, pad))
                for k, v in store.items()}

    def compress(self, h: Tensor, mask: Tensor) -> Store:
        hm = h * mask[..., None].to(h.dtype)
        payload = {"c": gram(hm)}
        if self.normalize:
            payload["z"] = hm.sum(dim=1)
        return payload

    def write_rows(self, store: Store, rows: Tensor, payload: Store) -> None:
        for key in store:
            store[key].index_copy_(0, rows.long(),
                                   payload[key].to(store[key].dtype))

    def lookup_wave(self, store: Store, rows: Tensor, q: Tensor) -> Tensor:
        if self.use_kernel:
            block_m = min(self.block_m, q.shape[1])
            out = lookup_ops.mass_lookup_indexed(store["c"], rows, q,
                                                 block_m=block_m)
        else:
            out = torch.einsum("bkl,bml->bmk", store["c"][rows.long()], q)
        if self.normalize:
            denom = torch.einsum("bk,bmk->bm", store["z"][rows.long()], q)
            out = out / safe_denom(denom)[..., None]
        return out


@register_lookup_backend
class SoftmaxLookupBackend(LookupBackend):
    """The honest baseline: softmax attention over the full hidden-state
    matrix, R(D, Q) = Hᵀ softmax(H Qᵀ) (paper §2.1). Resident bytes and
    per-query work are O(n·k) in document length: the store's token axis
    grows to the longest document served. Plain PyTorch, as in JAX."""

    name = "softmax"
    fixed_size_memory = False

    def memory_bytes(self, n_tokens: int) -> int:
        return n_tokens * self.k * _itemsize(self.dtype)

    def init_store(self, capacity: int) -> Store:
        return {"h": torch.zeros((capacity, 1, self.k), dtype=self.dtype,
                                 device=self.device),
                "len": torch.zeros((capacity,), dtype=torch.int32,
                                   device=self.device)}

    def grow_store(self, store: Store, capacity: int, n_cap: int) -> Store:
        pad_rows = capacity - store["h"].shape[0]
        pad_n = n_cap - store["h"].shape[1]
        return {"h": F.pad(store["h"], (0, 0, 0, pad_n, 0, pad_rows)),
                "len": F.pad(store["len"], (0, pad_rows))}

    def compress(self, h: Tensor, mask: Tensor) -> Store:
        return {"h": h * mask[..., None].to(h.dtype),
                "len": mask.to(torch.int32).sum(dim=1, dtype=torch.int32)}

    def write_rows(self, store: Store, rows: Tensor, payload: Store) -> None:
        n_cap = store["h"].shape[1]
        h = payload["h"].to(store["h"].dtype)
        h = F.pad(h, (0, 0, 0, n_cap - h.shape[1]))
        store["h"].index_copy_(0, rows.long(), h)
        store["len"].index_copy_(0, rows.long(),
                                 payload["len"].to(torch.int32))

    def lookup_wave(self, store: Store, rows: Tensor, q: Tensor) -> Tensor:
        idx = rows.long()
        h = store["h"][idx]                              # (B, n_cap, k)
        lens = store["len"][idx]
        scores = torch.einsum("bnk,bmk->bmn", h, q).float()
        valid = (torch.arange(h.shape[1], device=h.device)[None, :]
                 < lens[:, None])[:, None, :]
        scores = scores.masked_fill(~valid, float("-inf"))
        probs = torch.softmax(scores, dim=-1)
        out = torch.einsum("bmn,bnk->bmk", probs, h.float())
        return out.to(q.dtype)


# ---------------------------------------------------------------------------
# requests / results / stats
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LookupRequest:
    """M queries against one resident memory. ``priority`` orders waves
    (higher first, FIFO within a priority) and arms ``evict_lowest``
    shedding."""
    uid: int
    doc_id: str
    queries: np.ndarray            # (M, k)
    priority: int = 0


@dataclasses.dataclass
class LookupResult:
    uid: int
    doc_id: str
    answers: Optional[np.ndarray]  # (M, k); None when shed or cancelled
    status: str = STATUS_OK        # ok | shed | cancelled
    wave: int = -1                 # wave that served it (-1 = none)


@dataclasses.dataclass
class LookupStats:
    """Counters of the memory-serving mode (the JAX engine's, field for
    field; a "jit miss" here counts a new (bucket, capacity) shape)."""
    backend: str = ""
    # ingest
    documents: int = 0            # resident memories
    pinned: int = 0               # admitted pre-encoded (no encode wave)
    ingest_waves: int = 0         # varlen batched encode waves
    ingest_dispatches: int = 0    # ingest calls (== waves)
    encode_jit_misses: int = 0    # distinct ingest shapes
    store_grows: int = 0          # capacity doublings
    resident_state_bytes: int = 0  # logical bytes of all resident memories
    # serving
    requests: int = 0             # lookup requests answered
    queries: int = 0              # individual query vectors answered
    waves: int = 0                # query waves executed
    lookup_dispatches: int = 0    # lookup_wave calls (== waves)
    lookup_jit_misses: int = 0    # distinct wave shapes
    multi_memory_waves: int = 0   # waves mixing >1 distinct memory
    shed: int = 0                 # bounded-queue rejections
    cancelled: int = 0            # queued requests cancelled

    @property
    def queries_per_wave(self) -> float:
        return self.queries / self.waves if self.waves else 0.0

    def to_dict(self) -> Dict:
        d = dataclasses.asdict(self)
        d["queries_per_wave"] = self.queries_per_wave
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

class LookupEngine:
    """Memory serving: ingest documents once, pin their fixed-size states
    resident, answer heterogeneous query waves.

    ``encoder`` is the paper's document encoder, a dict with ``embed``
    (V, d) token embeddings and ``gru`` (``qa.gru.gru_params``) on
    ``device``; it may be None for stores fed only through :meth:`pin` /
    :meth:`ingest_hidden`. ``backend`` picks the memory layout:
    ``"linear"`` (k×k states through the B4 kernel) or ``"softmax"`` (the
    full hidden-state baseline). ``use_kernel=False`` (linear only) asks
    for the plain gather-einsum instead of the kernel.

    ``max_queue`` bounds the query queue and ``shed_policy`` picks the
    overload victim (``"reject_new"`` sheds the arrival,
    ``"evict_lowest"`` the newest strictly-lower-priority queued request);
    every submitted request resolves to a :class:`LookupResult`, shed ones
    included. Ingest waves pad documents to power-of-2 widths and query
    waves pad (rows, queries per row) to power-of-2 buckets.

    ``device`` is CUDA unless the caller asks for another.
    """

    def __init__(self, encoder: Optional[Dict[str, Any]] = None, *,
                 k: Optional[int] = None,
                 backend: str = "linear",
                 normalize: bool = False,
                 dtype: torch.dtype = torch.float32,
                 capacity: int = 64,
                 wave_size: int = 64,
                 ingest_wave: int = 64,
                 max_queue: Optional[int] = None,
                 shed_policy: str = "reject_new",
                 use_kernel: Optional[bool] = None,
                 device: Optional[Union[str, torch.device]] = None):
        if encoder is None and k is None:
            raise ValueError("need an encoder or an explicit k")
        self.device = resolve_device(device)
        if encoder is not None:
            enc_k = encoder["gru"]["w_h"].shape[0]
            if k is not None and k != enc_k:
                raise ValueError(f"k={k} != encoder hidden size {enc_k}")
            k = enc_k
            if encoder["embed"].device.type != self.device.type:
                raise ValueError(f"encoder is on {encoder['embed'].device}, "
                                 f"the engine on {self.device}")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy {shed_policy!r} not in "
                             f"{SHED_POLICIES}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.encoder = encoder
        self.k = k
        extra = {} if use_kernel is None else {"use_kernel": use_kernel}
        self.backend = get_lookup_backend(backend)(
            k, normalize=normalize, dtype=dtype, device=self.device, **extra)
        self.normalize = normalize
        self.wave_size = max(1, wave_size)
        self.ingest_wave = max(1, ingest_wave)
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype

        self._capacity = _pow2_ceil(max(2, capacity))
        self._n_cap = 1                       # softmax token-axis bucket
        self.store = self.backend.init_store(self._capacity)
        self._row_of: Dict[str, int] = {}
        self._len_of: Dict[str, int] = {}
        self._pending: List[Tuple[str, np.ndarray]] = []
        # queued requests by priority, each FIFO (= uid order): the JAX
        # engine's sort by (-priority, uid) without re-sorting per wave
        self._queue: Dict[int, Deque[LookupRequest]] = {}
        self._n_queued = 0
        self._results: Dict[int, LookupResult] = {}
        self._next_uid = 0
        self._seen_shapes: set = set()
        self.stats = LookupStats(backend=self.backend.name)

    # -- bookkeeping ---------------------------------------------------

    def __len__(self) -> int:
        return len(self._row_of)

    def __contains__(self, doc_id: str) -> bool:
        return doc_id in self._row_of

    def rows(self) -> Dict[str, int]:
        return dict(self._row_of)

    def _tensor(self, a: np.ndarray) -> Tensor:
        return torch.from_numpy(a).to(self.device)

    def _miss(self, kind: str, *shape) -> bool:
        key = (kind,) + shape
        if key in self._seen_shapes:
            return False
        self._seen_shapes.add(key)
        return True

    def _assign_row(self, doc_id: str, n_tokens: int) -> int:
        row = self._row_of.get(doc_id)
        if row is None:
            row = len(self._row_of)
            self._row_of[doc_id] = row
            self.stats.documents += 1
        else:
            self.stats.resident_state_bytes -= self.backend.memory_bytes(
                self._len_of[doc_id])
        self._len_of[doc_id] = n_tokens
        self.stats.resident_state_bytes += self.backend.memory_bytes(
            n_tokens)
        return row

    def _ensure_capacity(self, n_rows: int, n_tokens: int) -> None:
        cap = self._capacity
        while n_rows > cap:
            cap *= 2
        n_cap = self._n_cap
        if not self.backend.fixed_size_memory:
            n_cap = max(n_cap, _pow2_ceil(max(1, n_tokens)))
        if cap != self._capacity or n_cap != self._n_cap:
            self.store = self.backend.grow_store(self.store, cap, n_cap)
            self._capacity, self._n_cap = cap, n_cap
            self.stats.store_grows += 1

    # -- ingest --------------------------------------------------------

    def ingest(self, doc_id: str, tokens) -> None:
        """Queue a document (token ids) for the next varlen batched
        encode wave. Requires an encoder."""
        if self.encoder is None:
            raise ValueError("ingest(tokens) needs an encoder; use "
                             "pin()/ingest_hidden() on encoder-less "
                             "engines")
        tokens = np.asarray(tokens, np.int32).reshape(-1)
        if tokens.size == 0:
            raise ValueError(f"document {doc_id!r} is empty")
        self._pending.append((doc_id, tokens))

    def _ingest_wave(self, tokens: Tensor, lens: Tensor, rows: Tensor
                     ) -> None:
        """Encode, compress and write one padded wave into the store."""
        x = self.encoder["embed"][tokens.long()]
        hs, _ = gru_scan(self.encoder["gru"], x)
        mask = (torch.arange(tokens.shape[1], device=self.device)[None, :]
                < lens[:, None])
        self.backend.write_rows(self.store, rows,
                                self.backend.compress(hs, mask))

    def flush(self) -> None:
        """Encode every pending document, in waves of at most
        ``ingest_wave`` documents, each one bucket-padded call that
        encodes, compresses and writes into the resident store."""
        # One write wave must not carry duplicate rows of live documents:
        # keep only the LAST queued payload per doc id before cutting
        # waves.
        if len({d for d, _ in self._pending}) != len(self._pending):
            self._pending = list(dict(self._pending).items())
        while self._pending:
            batch = self._pending[:self.ingest_wave]
            self._pending = self._pending[self.ingest_wave:]
            lens = np.asarray([t.size for _, t in batch], np.int32)
            width = _pow2_ceil(int(lens.max()))
            b_bucket = _pow2_ceil(len(batch))
            tokens = np.zeros((b_bucket, width), np.int32)
            rows = np.zeros((b_bucket,), np.int32)
            lens_pad = np.zeros((b_bucket,), np.int32)
            for i, (doc_id, toks) in enumerate(batch):
                tokens[i, :toks.size] = toks
                lens_pad[i] = toks.size
                rows[i] = self._assign_row(doc_id, int(toks.size))
            # Padded bucket rows write a zero payload somewhere; that
            # somewhere must never be a live row. max(batch rows) + 1 is
            # NOT safe: re-ingesting existing documents can leave higher
            # rows resident. Rows are assigned densely, so len(_row_of)
            # is always the first free row: the sacrificial scratch row.
            scratch = len(self._row_of)
            rows[len(batch):] = scratch
            self._ensure_capacity(scratch + 1, int(lens.max()))
            if self._miss("ingest", b_bucket, width, self._capacity,
                          self._n_cap):
                self.stats.encode_jit_misses += 1
            self._ingest_wave(self._tensor(tokens), self._tensor(lens_pad),
                              self._tensor(rows))
            self.stats.ingest_waves += 1
            self.stats.ingest_dispatches += 1

    def ingest_hidden(self, doc_id: str, h) -> None:
        """Admit one document directly from its (n, k) hidden states
        (compressed on the device; no encoder needed)."""
        h = torch.as_tensor(h, dtype=self.backend.dtype, device=self.device)
        if h.ndim != 2 or h.shape[1] != self.k:
            raise ValueError(f"hidden states must be (n, k={self.k}), got "
                             f"{tuple(h.shape)}")
        row = self._assign_row(doc_id, h.shape[0])
        self._ensure_capacity(len(self._row_of), h.shape[0])
        self.backend.write_rows(self.store, self._rows_tensor(row),
                                self.backend.payload_from_hidden(h))
        self.stats.pinned += 1

    def _rows_tensor(self, row: int) -> Tensor:
        return torch.tensor([row], dtype=torch.int32, device=self.device)

    def pin(self, doc_id: str, state: DocumentState) -> None:
        """Pin a pre-encoded fixed-size memory resident (linear backend
        only: the softmax baseline cannot serve from a compressed state;
        that asymmetry is the paper's point)."""
        if not self.backend.fixed_size_memory:
            raise ValueError(
                f"backend {self.backend.name!r} has no fixed-size memory "
                f"to pin; ingest the document's hidden states instead")
        if self.normalize and state.z is None:
            raise ValueError(f"pin({doc_id!r}): engine normalizes but "
                             f"the state has no z")
        if state.k != self.k:
            raise ValueError(f"pin({doc_id!r}): state k={state.k}, engine "
                             f"k={self.k}")
        row = self._assign_row(doc_id, state.n_tokens)
        self._ensure_capacity(len(self._row_of), state.n_tokens)
        payload = {"c": state.c[None].to(self.device)}
        if self.normalize:
            payload["z"] = state.z[None].to(self.device)
        self.backend.write_rows(self.store, self._rows_tensor(row), payload)
        self.stats.pinned += 1

    # -- query scheduling ----------------------------------------------

    def submit(self, doc_id: str, queries, priority: int = 0) -> int:
        """Queue M queries against one resident (or pending) memory;
        returns the request uid. A full bounded queue sheds per
        ``shed_policy``: the shed request resolves at once with
        ``status="shed"``."""
        if doc_id not in self._row_of and doc_id not in {
                d for d, _ in self._pending}:
            raise KeyError(f"unknown document {doc_id!r}: ingest or pin "
                           f"it before submitting queries")
        q = np.asarray(queries, self._np_dtype)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[1] != self.k:
            raise ValueError(f"queries must be (k,) or (M, k={self.k}); "
                             f"got {np.asarray(queries).shape}")
        uid = self._next_uid
        self._next_uid += 1
        req = LookupRequest(uid=uid, doc_id=doc_id, queries=q,
                            priority=priority)
        if self.max_queue is not None and self._n_queued >= self.max_queue:
            victim = self._pick_shed_victim(req)
            self._shed(victim)
            if victim is req:
                return uid
        self._queue.setdefault(priority, collections.deque()).append(req)
        self._n_queued += 1
        return uid

    def _pick_shed_victim(self, incoming: LookupRequest) -> LookupRequest:
        if self.shed_policy == "reject_new":
            return incoming
        # the lowest priority's newest request (largest uid)
        lowest = min(self._queue)
        victim = self._queue[lowest][-1]
        if victim.priority < incoming.priority:
            self._queue[lowest].pop()
            self._drop_empty(lowest)
            self._n_queued -= 1
            return victim
        return incoming

    def _drop_empty(self, priority: int) -> None:
        if not self._queue[priority]:
            del self._queue[priority]

    def _shed(self, req: LookupRequest) -> None:
        self.stats.shed += 1
        self._results[req.uid] = LookupResult(
            uid=req.uid, doc_id=req.doc_id, answers=None,
            status=STATUS_SHED)

    def cancel(self, uid: int) -> bool:
        """Cancel a QUEUED request: it resolves at once with
        ``status="cancelled"`` and never joins a wave. Returns False if the
        uid is unknown or already served (waves are synchronous, so there
        is no in-flight window)."""
        for priority, reqs in self._queue.items():
            for r in reqs:
                if r.uid == uid:
                    reqs.remove(r)
                    self._drop_empty(priority)
                    self._n_queued -= 1
                    self.stats.cancelled += 1
                    self._results[uid] = LookupResult(
                        uid=uid, doc_id=r.doc_id, answers=None,
                        status=STATUS_CANCELLED)
                    return True
        return False

    def queue_depth(self) -> int:
        return self._n_queued

    def has_work(self) -> bool:
        return bool(self._n_queued or self._pending)

    def _pop_wave(self) -> List[LookupRequest]:
        """The ≤ ``wave_size`` queued requests first by (-priority, uid)."""
        wave: List[LookupRequest] = []
        for priority in sorted(self._queue, reverse=True):
            reqs = self._queue[priority]
            while reqs and len(wave) < self.wave_size:
                wave.append(reqs.popleft())
            self._drop_empty(priority)
            if len(wave) == self.wave_size:
                break
        self._n_queued -= len(wave)
        return wave

    def step(self) -> bool:
        """Serve ONE query wave: flush pending ingests, pop the ≤
        ``wave_size`` highest-priority queued requests, flatten them into
        one bucket-padded (B, M, k) batch with per-row memory indices, and
        answer it with one ``lookup_wave`` call (one B4 launch on the
        linear backend)."""
        if self._pending:
            self.flush()
        if not self._n_queued:
            return self.has_work()
        wave = self._pop_wave()
        b_bucket = _pow2_ceil(len(wave))
        m_bucket = _pow2_ceil(max(r.queries.shape[0] for r in wave))
        q = np.zeros((b_bucket, m_bucket, self.k), self._np_dtype)
        rows = np.zeros((b_bucket,), np.int32)
        for i, r in enumerate(wave):
            q[i, :r.queries.shape[0]] = r.queries
            rows[i] = self._row_of[r.doc_id]
        if self._miss("wave", b_bucket, m_bucket, self._capacity,
                      self._n_cap):
            self.stats.lookup_jit_misses += 1
        out = self.backend.lookup_wave(self.store, self._tensor(rows),
                                       self._tensor(q)).cpu().numpy()
        wave_idx = self.stats.waves
        self.stats.waves += 1
        self.stats.lookup_dispatches += 1
        self.stats.requests += len(wave)
        self.stats.queries += sum(r.queries.shape[0] for r in wave)
        if len({r.doc_id for r in wave}) > 1:
            self.stats.multi_memory_waves += 1
        for i, r in enumerate(wave):
            self._results[r.uid] = LookupResult(
                uid=r.uid, doc_id=r.doc_id,
                answers=out[i, :r.queries.shape[0]], wave=wave_idx)
        return self.has_work()

    def run(self) -> List[LookupResult]:
        """Drain the queue (repeated :meth:`step`); results in uid order,
        shed requests included."""
        while self.step():
            pass
        return self.results()

    def results(self) -> List[LookupResult]:
        return [self._results[u] for u in sorted(self._results)]

    @property
    def resident_bytes(self) -> int:
        """Logical bytes of every resident memory: O(N·k²) for the linear
        backend, O(Σ nᵢ·k) for softmax."""
        return self.stats.resident_state_bytes

    # -- durability ----------------------------------------------------

    def save_checkpoint(self, directory: str, step: int = 0,
                        keep: int = 2) -> None:
        """Write the whole engine through the atomic writer, in JAX's
        format: the resident store (for the linear backend N·k² floats
        however long the documents were), the row and length maps,
        pending ingests, queued requests, served results and the stats.
        A restored engine answers bit for bit: the store's arrays come
        back bitwise and a lookup is a function of (store, rows, q)."""
        extra = {
            "capacity": self._capacity, "n_cap": self._n_cap,
            "row_of": dict(self._row_of),
            "len_of": dict(self._len_of),
            "pending": [[d, np.asarray(t, np.int32).tolist()]
                        for d, t in self._pending],
            "queue": [{"uid": r.uid, "doc_id": r.doc_id,
                       "queries": np.asarray(r.queries).tolist(),
                       "priority": r.priority}
                      for p in sorted(self._queue, reverse=True)
                      for r in self._queue[p]],
            "results": [
                {"uid": r.uid, "doc_id": r.doc_id,
                 "answers": (None if r.answers is None
                             else np.asarray(r.answers).tolist()),
                 "status": r.status, "wave": r.wave}
                for _, r in sorted(self._results.items())],
            "next_uid": self._next_uid,
            "stats": dataclasses.asdict(self.stats),
            "seen_shapes": sorted(list(k) for k in self._seen_shapes),
        }
        CheckpointManager(directory, keep=keep).save(
            step, {"store": self.store}, extra, blocking=True)

    def restore_checkpoint(self, directory: str,
                           step: Optional[int] = None) -> None:
        """Restore from :meth:`save_checkpoint`'s output, by either
        package (the newest retained step by default, past corrupt
        ones)."""
        tree, extra, _ = CheckpointManager(directory).restore(
            {"store": self.store}, step)
        self._capacity = extra["capacity"]
        self._n_cap = extra["n_cap"]
        self.store = dict(tree["store"])
        self._row_of = dict(extra["row_of"])
        self._len_of = {d: int(n) for d, n in extra["len_of"].items()}
        self._pending = [(d, np.asarray(t, np.int32))
                         for d, t in extra["pending"]]
        self._queue = {}
        for d in sorted(extra["queue"], key=lambda d: d["uid"]):
            self._queue.setdefault(d["priority"], collections.deque()
                                   ).append(LookupRequest(
                uid=d["uid"], doc_id=d["doc_id"],
                queries=np.asarray(d["queries"], self._np_dtype),
                priority=d["priority"]))
        self._n_queued = len(extra["queue"])
        self._results = {
            d["uid"]: LookupResult(
                uid=d["uid"], doc_id=d["doc_id"],
                answers=(None if d["answers"] is None
                         else np.asarray(d["answers"], self._np_dtype)),
                status=d["status"], wave=d["wave"])
            for d in extra["results"]}
        self._next_uid = extra["next_uid"]
        self.stats = LookupStats(**extra["stats"])
        self._seen_shapes = {tuple(k) for k in extra["seen_shapes"]}

    @classmethod
    def recover(cls, encoder: Optional[Dict[str, Any]] = None, *,
                directory: str, **kwargs) -> "LookupEngine":
        """Build a lookup engine and restore it from ``directory``: the
        restart. Pass the arguments the dead incarnation had."""
        eng = cls(encoder, **kwargs)
        eng.restore_checkpoint(directory)
        return eng


# ---------------------------------------------------------------------------
# hedged lookups: tail latency and failover across lookup replicas
# ---------------------------------------------------------------------------

class HedgedLookup:
    """N :class:`LookupEngine` replicas behind one submit/results API,
    with request hedging: nearly free here, since a replica of a memory
    is an O(k²) copy.

    Every ingest or pin lands on every replica (each holds the whole
    store); a request goes to one replica, round-robin. A request still
    unanswered ``hedge_after`` ticks later (its replica slow, backlogged
    or dead) is duplicated to a second replica; the first answer wins
    and the loser is cancelled out of its queue
    (:meth:`LookupEngine.cancel`), or its late answer dropped: no uid is
    delivered twice. Both replicas hold the same store, so where every
    request of a wave has the same query count the answer is bitwise the
    same whichever replica served it.

    ``kill(r)`` stops a replica's stepping and routing (the chaos hook):
    its queued work is recovered by hedging alone.
    """

    def __init__(self, encoder: Optional[Dict[str, Any]] = None, *,
                 replicas: int = 2, hedge_after: int = 1,
                 **engine_kwargs):
        if replicas < 2:
            raise ValueError("hedging needs at least two replicas")
        if hedge_after < 1:
            raise ValueError(f"hedge_after must be >= 1, got {hedge_after}")
        self.engines = [LookupEngine(encoder, **engine_kwargs)
                        for _ in range(replicas)]
        self.hedge_after = hedge_after
        self._alive = [True] * replicas
        self._next_uid = 0
        self._tick = 0
        # uid → (replica, the replica's uid); hedges kept apart
        self._primary: Dict[int, Tuple[int, int]] = {}
        self._hedge: Dict[int, Tuple[int, int]] = {}
        self._born: Dict[int, int] = {}          # uid → submit tick
        # uid → (doc_id, queries, priority): a hedge's payload never
        # reads a dead replica's internals
        self._reqs: Dict[int, Tuple[str, np.ndarray, int]] = {}
        self._results: Dict[int, LookupResult] = {}
        self._rr = 0
        self.hedged = 0          # duplicates issued
        self.hedge_wins = 0      # answers served by the hedge copy
        self.losers_cancelled = 0

    # -- the store: every replica holds all of it ----------------------

    def ingest(self, doc_id: str, tokens) -> None:
        for eng in self.engines:
            eng.ingest(doc_id, tokens)

    def ingest_hidden(self, doc_id: str, h) -> None:
        for eng in self.engines:
            eng.ingest_hidden(doc_id, h)

    def pin(self, doc_id: str, state: DocumentState) -> None:
        for eng in self.engines:
            eng.pin(doc_id, state)

    def kill(self, replica: int) -> None:
        """Drop a replica (the chaos hook): no more routing or stepping;
        its pending work is recovered by hedging alone."""
        self._alive[replica] = False

    def _pick(self, exclude: Optional[int] = None) -> int:
        alive = [r for r in range(len(self.engines))
                 if self._alive[r] and r != exclude]
        if not alive:
            raise RuntimeError("no live lookup replica")
        r = alive[self._rr % len(alive)]
        self._rr += 1
        return r

    def submit(self, doc_id: str, queries, priority: int = 0) -> int:
        uid = self._next_uid
        self._next_uid += 1
        r = self._pick()
        sub = self.engines[r].submit(doc_id, queries, priority=priority)
        self._primary[uid] = (r, sub)
        self._born[uid] = self._tick
        self._reqs[uid] = (doc_id, np.asarray(queries), priority)
        return uid

    # -- scheduling ----------------------------------------------------

    def _collect(self, uid: int) -> None:
        """The first answer wins; the losing duplicate is cancelled (or
        its late answer discarded), never delivered."""
        for tag, route in (("primary", self._primary.get(uid)),
                           ("hedge", self._hedge.get(uid))):
            if route is None:
                continue
            r, sub = route
            res = self.engines[r]._results.get(sub)
            if res is None or res.status == STATUS_CANCELLED:
                continue
            self._results[uid] = dataclasses.replace(res, uid=uid)
            if tag == "hedge":
                self.hedge_wins += 1
            other = (self._hedge if tag == "primary"
                     else self._primary).get(uid)
            if other is not None:
                ro, so = other
                if self.engines[ro].cancel(so):
                    self.losers_cancelled += 1
            self._primary.pop(uid, None)
            self._hedge.pop(uid, None)
            self._born.pop(uid, None)
            self._reqs.pop(uid, None)
            return

    def step(self) -> bool:
        """One tick: step the live replicas, harvest answers, hedge every
        request unanswered for ``hedge_after`` ticks."""
        self._tick += 1
        for r, eng in enumerate(self.engines):
            if self._alive[r]:
                eng.step()
        for uid in list(self._born):
            self._collect(uid)
        for uid, born in list(self._born.items()):
            if uid in self._hedge or uid in self._results:
                continue
            if self._tick - born < self.hedge_after:
                continue
            rp, _ = self._primary[uid]
            try:
                rh = self._pick(exclude=rp)
            except RuntimeError:
                continue
            doc_id, queries, priority = self._reqs[uid]
            sub = self.engines[rh].submit(doc_id, queries,
                                          priority=priority)
            self._hedge[uid] = (rh, sub)
            self.hedged += 1
        return self.has_work()

    def has_work(self) -> bool:
        return bool(self._born)

    def run(self) -> List[LookupResult]:
        while self.step():
            pass
        return self.results()

    def results(self) -> List[LookupResult]:
        return [self._results[u] for u in sorted(self._results)]
