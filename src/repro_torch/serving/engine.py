"""Fixed-slot continuous-batching decode engine (port of
``repro/serving/engine.py``: the scheduler, its lifecycle and speculative
rounds).

The paper's serving claim — a fixed-size O(k²) state with constant-time
lookups — pays off when many requests share the device. Every state
operation goes through a :class:`~repro_torch.serving.backends.DecodeBackend`,
so this module is a scheduler and the backend owns the state layout.

* **Slots.** The device holds one whole-stack decode state of batch
  ``n_slots``; each slot holds at most one live request. Decode runs in
  ``segment_len``-step segments (``lm.generate_segment``) with per-slot
  positions, active masks and stop conditions (EOS, token budget)
  decided on the device, so a slot can finish mid-segment without
  holding the others up. A segment launches the decode kernel (B1 or
  B7) once per layer and step, masked rows passing ``lens = 0``, and
  syncs with the host once, when its tokens come back.

* **Scheduler.** Between segments the host drains finished slots and
  admits waiting requests into the freed ones, best first by
  (-priority, arrival, uid), a suspended request before a queued one of
  the same key. ``admission="batched"`` admits every admissible request
  at once: prompts are END-padded to a power-of-two bucket width and
  encoded by one ``lm.prefill_varlen`` pass whose per-row masking makes
  each row's state that of the row alone; the wave's rows are copied
  into their slots and no other row is touched. A wave of one is
  encoded at batch 1 and written into its slot; a length-1 prompt is
  encoded unpadded at batch 1 (JAX's carve-out). Prompts longer than
  ``prefill_chunk`` are ingested chunk by chunk through
  ``lm.decode_window_varlen`` (``ingest="recurrent"``, B1/B7 with
  per-row ``lens`` up to the chunk width) or ``lm.ingest_window_varlen``
  (``"parallel"``, the plain chunked forms), one chunk per scheduling
  step before the segment, so a long prompt never stalls the live
  slots. ``admission="per_request"`` prefills each request alone and
  writes it into its slot.

* **Isolation.** Inactive slots keep their state bit for bit, so under
  greedy decoding each request's tokens are those it would produce
  running alone.

* **Softmax.** Under the KV-cache baseline (``SoftmaxKVBackend``) the
  slots hold ``max_len``-row caches. A wave's varlen prefill runs B10
  (the causal flash-attention kernel) on CUDA tensors, and landing it
  copies its bucket-width rows into the wave's slots and zeros the rest
  of each, as JAX pads; decode writes one gated cache row per slot and
  step, and both ingest settings step single-token decode over a chunk.
  ``submit`` keeps prompt + budget + lookahead within ``max_len`` + 1,
  so every written row fits the cache.

* **Lifecycle.** A request is portable: an active slot is suspended
  into a host-side :class:`~repro_torch.serving.lifecycle.SuspendedRequest`
  (one ``snapshot_state_rows`` copy: O(k²) per layer for the fixed-size
  states, the written rows of a KV cache) and re-admitted later with
  bit-identical greedy continuation. Requests carry ``priority`` (a
  higher-priority arrival preempts the lowest-(priority, progress) slot
  when every slot is taken) and ``deadline_s`` (logical steps; a request
  past it leaves the queue, the suspended pool or its slot with its
  partial tokens), can be ``cancel``-ed, and ``max_queue`` bounds the
  queue under ``shed_policy``. Past ``degrade_threshold`` waiting
  requests per slot the engine degrades: speculation turns off and the
  ingest chunk halves, with hysteresis, every flip in
  :class:`EngineStats`. After every segment and round one fused finite
  probe (``lm.slot_state_finite``: a reduction per leaf and one (S,)
  bool copy) finds a non-finite slot; the slot is quarantined (its NaNs
  stay put, masked like any inactive row) and its request retried once
  from its last good checkpoint on a fresh slot, or completed
  ``status="failed"``. A :class:`~repro_torch.serving.lifecycle.FaultInjector`
  drives the chaos cases deterministically.

* **Speculation** (``speculate_k`` on submit, a ``draft`` provider on
  the engine). A speculative slot advances in draft/verify rounds
  batched over every speculative slot: the draft proposes K tokens, ONE
  masked ``lm.decode_window_varlen`` (B1/B7 once per layer) runs the
  K+1-token window at each slot's own position, with ``lens = K + 1`` on
  speculative rows and 0 on every other row, which keeps their state
  bit for bit; only the (S, K+1) argmax tokens come to the host. The
  longest draft prefix equal to the target's greedy tokens is accepted
  and the target's own next token appended: 1 to K+1 tokens of the
  exact greedy sequence a round. The port's windows update the state in
  place where JAX's return a new one beside the old, so a slot that
  accepted the whole window already holds its state (JAX's masked
  select is not needed), and a slot that rejected part of it is rewound
  from a copy taken before the verify: the fixed-size states of every
  speculative slot are copied (``snapshot_state_rows`` with no KV rows),
  the rewinding slots get theirs back, and ONE more masked
  ``decode_window_varlen`` re-advances each of them by its own accepted
  count, however many rewind. A softmax KV cache needs no copy: the
  verify writes rows [pos, pos+K+1), the re-advance rewrites rows
  [pos, pos+a+1) with the same keys and values, and rows past a slot's
  position are never read before they are rewritten (the invariant of
  ``lm``'s row-ranged forms, which is JAX's argument for its row-ranged
  merges). Plain and speculative requests share the slot batch, each
  kind masked while the other runs.

* **Prefix cache and fork** (``prefix_cache`` on the engine; batched
  admission only). A prompt longer than the cache's chunk is matched
  against the cache (``serving/prefix_cache.py``) at admission: a hit is
  ONE ``restore_state_rows`` copy of the cached state into the slot
  (the paper's fixed-size state: O(k²) per layer however long the
  prefix; softmax: the matched KV blocks' rows), the cursor jumps to the
  matched chunk boundary and only the suffix is ingested, through the
  continuation chunks (B1/B7 once per layer and chunk), on the chunk
  grid a cold admission uses, so the tokens are the cold ones. Every
  chunk boundary an ingest chunk crosses inserts a row-ranged snapshot
  (an owned copy) when the cache wants it. The entries a slot was
  admitted from stay pinned (``_cache_hold``) until the slot is torn
  down, wherever that happens. The cache survives ``reset``; its
  counters in :class:`EngineStats` are deltas since the reset.
  ``submit(fork=N)`` encodes the prompt once: at activation the N − 1
  other continuations become suspended requests sharing one snapshot
  (each resume copies it into its own slot), uids uid..uid+N−1; a
  primary that ends before activation completes its members with it.

Time is logical: the clock advances ``segment_len`` decode steps per
segment (the round's most tokens per slot for a speculative round), and
``arrival`` and ``deadline_s`` are in decode steps.

Policies: ``continuous`` admits into any freed slot between segments
(and preempts for priority); ``static`` admits only when every slot is
free (the batch-synchronous baseline).

* **Durability** (``journal``, ``checkpoint_dir`` on the engine). A
  :class:`~repro_torch.serving.journal.Journal` records every submit and
  cancel before it takes effect and every completion's ack before it is
  observable. ``save_checkpoint`` writes the whole engine through the
  atomic checkpoint writer in JAX's layout: the slot batch, the RNG key
  leaf and every suspended and last-good snapshot as the device tree,
  the scheduler's host state in ``extra`` (``checkpoint_every`` > 0
  saves every that many events). ``recover`` (or ``recover_in_place``)
  restores the newest checkpoint and replays the journal past it:
  acked uids are served their journaled completion and never acked
  again, unacked submits re-enter the queue under their own uids, so a
  greedy run completes every request with the tokens of an uncrashed
  run, each acked once. Sampling draws from a ``torch.Generator``, not
  JAX's key: the checkpoint keeps JAX's ``uint32[2]`` key leaf (so
  either package restores the other's greedy checkpoint) and the
  generator's state in ``extra["torch_generator"]``, which JAX does not
  read; a checkpoint without it reseeds the generator from ``seed``.
"""

from __future__ import annotations

import base64
import bisect
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.models.attention import AttnState
from repro_torch.serving.backends import DecodeBackend, backend_for_config
from repro_torch.serving.journal import (
    REC_ACK,
    REC_CANCEL,
    REC_SUBMIT,
    Journal,
    ack_record,
    cancel_record,
    completion_from_ack,
    submit_record,
)
from repro_torch.serving.lifecycle import (
    SHED_POLICIES,
    STATUS_CANCELLED,
    STATUS_DEADLINE,
    STATUS_FAILED,
    STATUS_OK,
    STATUS_SHED,
    Checkpoint,
    FaultInjector,
    InjectedCrash,
    SuspendedRequest,
    poison_snapshot,
)

PAD_ID = -1  # emitted by masked slots; never a vocabulary id
POLICIES = ("continuous", "static")


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (bucket widths for padded admission)."""
    return 1 << (int(n) - 1).bit_length()


def _queue_key(r) -> Tuple[float, int]:
    return (r.arrival, r.uid)


@dataclasses.dataclass
class Request:
    """One generation request. ``arrival`` and ``deadline_s`` (an
    absolute completion deadline) are in logical decode steps;
    ``priority`` orders admission (higher first) and arms preemption;
    ``speculate_k`` > 0 decodes through draft/verify rounds (greedy
    only). ``fork`` > 1 asks for N continuations of one prompt encoded
    once (uids uid..uid+fork-1)."""
    uid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    arrival: float = 0.0
    speculate_k: int = 0
    priority: int = 0
    deadline_s: Optional[float] = None
    fork: int = 1


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: np.ndarray            # generated tokens (incl. EOS if hit)
    finish_reason: str            # "eos" | "length" | lifecycle status
    admitted_step: int            # -1 if never admitted (shed/deadline)
    finished_step: int
    status: str = STATUS_OK       # ok|cancelled|deadline|shed|failed
    retries: int = 0              # numeric-fault retries consumed


@dataclasses.dataclass
class EngineStats:
    """The engine's counters, under JAX's names."""
    segments: int = 0
    emitted_tokens: int = 0       # segment-emitted (excludes prefill-sampled)
    prefills: int = 0             # admitted (prompt-encoded) requests
    n_slots: int = 0
    segment_len: int = 0
    # admission (batched/chunked path)
    admission_batches: int = 0    # batched-admission waves
    prefill_dispatches: int = 0   # lm.prefill_varlen passes
    ingest_chunks: int = 0        # continuation-chunk passes
    ingest_interleaved: int = 0   # ...issued while decode slots were live
    admission_dispatches: int = 0  # admission-path device calls
    prefill_jit_misses: int = 0   # distinct admission program shapes
    # speculative rounds
    spec_rounds: int = 0          # batched draft/verify rounds
    spec_drafted: int = 0         # draft tokens proposed to the verifier
    spec_accepted: int = 0        # draft tokens the target agreed with
    spec_emitted: int = 0         # tokens emitted by rounds (incl. bonus)
    spec_rewinds: int = 0         # partial-acceptance slot re-advances
    spec_rewind_rounds: int = 0   # rounds that had >= 1 partial acceptor
    spec_rewind_dispatches: int = 0  # varlen rewind passes (1 per round)
    # lifecycle & fault tolerance
    preemptions: int = 0          # active slots suspended mid-generation
    resumes: int = 0              # suspended requests re-admitted
    cancelled: int = 0            # cancel() completions
    deadline_evictions: int = 0   # requests past deadline (queued/active)
    shed: int = 0                 # bounded-queue rejections
    quarantined: int = 0          # slots poisoned by a numeric fault
    retries: int = 0              # snapshot-retries after a fault
    failed: int = 0               # requests with retries exhausted
    checkpoints: int = 0          # last-good snapshots taken
    finite_checks: int = 0        # fused isfinite probes run
    degrade_transitions: int = 0  # overload degradation flips (both ways)
    spec_disables: int = 0        # spec requests forced plain (degraded)
    # prefix cache & fork/n-best
    cache_hits: int = 0           # admissions served from the cache
    cache_misses: int = 0         # cacheable prompts with no entry
    cache_evictions: int = 0      # entries/blocks dropped (byte budget)
    cached_prefix_tokens: int = 0  # prompt tokens not encoded on hits
    forks: int = 0                # extra continuations spawned (fork-1)
    degrade_events: List[Dict] = dataclasses.field(default_factory=list)

    def to_dict(self) -> Dict:
        """Counters and derived ratios as one JSON-able dict."""
        d = dataclasses.asdict(self)
        for name in ("slot_utilization", "acceptance_rate",
                     "tokens_per_round", "mean_admission_batch",
                     "interleave_ratio"):
            d[name] = getattr(self, name)
        return d

    def to_json(self, indent: int = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent)

    @property
    def slot_utilization(self) -> float:
        """Fraction of segment slot-steps that emitted a real token."""
        total = self.segments * self.n_slots * self.segment_len
        return self.emitted_tokens / total if total else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Fraction of drafted tokens the verifier accepted."""
        return (self.spec_accepted / self.spec_drafted
                if self.spec_drafted else 0.0)

    @property
    def tokens_per_round(self) -> float:
        """Mean tokens emitted per batched speculative round, summed over
        its speculative slots (a plain segment step emits one a slot)."""
        return (self.spec_emitted / self.spec_rounds
                if self.spec_rounds else 0.0)

    @property
    def mean_admission_batch(self) -> float:
        """Requests admitted per batched-admission wave."""
        return (self.prefills / self.admission_batches
                if self.admission_batches else 0.0)

    @property
    def interleave_ratio(self) -> float:
        """Fraction of continuation-chunk passes issued while at least
        one decode slot was live."""
        return (self.ingest_interleaved / self.ingest_chunks
                if self.ingest_chunks else 0.0)


class DecodeEngine:
    """Continuous-batching decode over ``n_slots`` state slots.

    ``params`` live on the device the engine runs on (its state, its
    sampling generator and every admission pass go there). ``max_len``
    bounds prompt + generated + draft lookahead tokens per request.
    ``admission``: "batched", "per_request" or "auto" (batched where the
    layer pattern takes varlen prefill). ``prefill_chunk`` (rounded up
    to a power of two) bounds the ingest chunk and the bucket widths.
    ``ingest``: "recurrent" (B1/B7 through ``decode_window_varlen``),
    "parallel" (the plain chunked forms through
    ``ingest_window_varlen``) or "auto" (recurrent). ``temperature`` 0
    is greedy; above 0 tokens are drawn from a ``torch.Generator``
    seeded by ``seed``. ``draft``: a
    :class:`~repro_torch.serving.speculative.DraftProvider` for requests
    submitted with ``speculate_k`` > 0.

    Robustness: ``max_queue`` bounds the admission queue; when it is
    full ``shed_policy`` "reject_new" sheds the arrival and
    "evict_lowest" the lowest-priority queued request if strictly below
    the arrival (else the arrival). ``degrade_threshold`` (waiting
    requests per slot; None disables) turns speculation off and halves
    the ingest chunk while the pressure stays above it, back below half
    of it. ``finite_check`` runs the finite probe at every segment and
    round; a non-finite slot is quarantined for the rest of the run and
    its request retried up to ``max_retries`` times from its last good
    checkpoint (taken at activation, and every ``checkpoint_interval``
    events when > 0), else completed ``status="failed"``. ``injector``:
    a :class:`~repro_torch.serving.lifecycle.FaultInjector` (chaos
    tests).

    ``prefix_cache``: None or False (off), "auto" (on where the backend
    supports it and admission resolved to batched), True (on; raises
    ValueError where it cannot be) or a
    :class:`~repro_torch.serving.prefix_cache.PrefixCache` to use as it
    is (its chunk a multiple of ``prefill_chunk``); ``cache_bytes`` the
    byte budget of a cache the engine builds.

    Durability: ``journal`` a path (a file-backed
    :class:`~repro_torch.serving.journal.Journal`) or a ``Journal``
    (in memory with ``path=None``); ``checkpoint_dir`` the directory of
    engine checkpoints (``save_checkpoint``, ``recover``), keeping the
    newest ``checkpoint_keep``; ``checkpoint_every`` > 0 saves one every
    that many events.
    """

    def __init__(
        self,
        params: Any,
        cfg: ModelConfig,
        *,
        backend: Optional[DecodeBackend] = None,
        n_slots: int = 4,
        segment_len: int = 8,
        max_len: int = 512,
        eos_id: Optional[int] = None,
        temperature: float = 0.0,
        seed: int = 0,
        draft: Optional[Any] = None,
        admission: str = "auto",
        prefill_chunk: int = 64,
        ingest: str = "auto",
        max_queue: Optional[int] = None,
        shed_policy: str = "reject_new",
        degrade_threshold: Optional[float] = None,
        finite_check: bool = True,
        max_retries: int = 1,
        checkpoint_interval: int = 0,
        injector: Optional[FaultInjector] = None,
        journal: Optional[Any] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 0,
        checkpoint_keep: int = 2,
        prefix_cache: Any = None,
        cache_bytes: int = 64 << 20,
    ):
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if max_retries < 0 or checkpoint_interval < 0:
            raise ValueError("max_retries and checkpoint_interval must be "
                             ">= 0")
        if checkpoint_every < 0 or checkpoint_keep < 1:
            raise ValueError("checkpoint_every must be >= 0 and "
                             "checkpoint_keep >= 1")
        self.params = params
        self.cfg = cfg
        self.backend = (backend if backend is not None
                        else backend_for_config(cfg))
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.segment_len = segment_len
        self.max_len = max_len
        self.eos_id = eos_id
        self.temperature = temperature
        self._seed = seed
        self.draft = draft
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.degrade_threshold = degrade_threshold
        self.finite_check = finite_check
        self.max_retries = max_retries
        self.checkpoint_interval = checkpoint_interval
        self.injector = injector
        # a path is the CLI's form; fleets and tests pass a Journal
        self.journal: Optional[Journal] = (
            Journal(journal) if isinstance(journal, str) else journal)
        self.checkpoint_every = checkpoint_every
        self._ckpt_mgr: Optional[CheckpointManager] = (
            CheckpointManager(checkpoint_dir, keep=checkpoint_keep)
            if checkpoint_dir is not None else None)
        self.admission, self.ingest = self.backend.resolve_modes(
            admission, ingest)
        # a power-of-two chunk, so every bucket width is one too
        self.prefill_chunk = min(_pow2_ceil(max(1, prefill_chunk)),
                                 max_len)
        self.cache = None
        if prefix_cache is True:
            if self.admission != "batched":
                raise ValueError(
                    f"prefix caching requires batched admission; backend "
                    f"{self.backend.name!r} resolved admission="
                    f"{self.admission!r}")
            self.cache = self.backend.make_prefix_cache(cache_bytes,
                                                        self.prefill_chunk)
        elif isinstance(prefix_cache, str):
            if prefix_cache != "auto":
                raise ValueError(f"prefix_cache must be None, False, 'auto', "
                                 f"True or a PrefixCache, got "
                                 f"{prefix_cache!r}")
            if (self.backend.supports_prefix_cache
                    and self.admission == "batched"):
                self.cache = self.backend.make_prefix_cache(
                    cache_bytes, self.prefill_chunk)
        elif prefix_cache is not None and prefix_cache is not False:
            if prefix_cache.chunk % self.prefill_chunk != 0:
                raise ValueError(
                    f"prefix cache chunk {prefix_cache.chunk} is not a "
                    f"multiple of the engine's prefill_chunk "
                    f"{self.prefill_chunk}: hit suffixes would leave the "
                    f"cold-admission chunk grid")
            self.cache = prefix_cache
        # admission program shapes seen: JAX's host mirror of its jit
        # cache, kept so that the stats compare field for field
        self._seen_shapes: set = set()
        self.reset()

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Clear every request, slot, suspended request, checkpoint,
        quarantine and counter. The prefix cache survives (a learned
        artifact, not a request); the pins of slots still holding cache
        entries are released."""
        for slot, hold in enumerate(getattr(self, "_cache_hold", ())):
            if hold is not None:
                self._release_hold(slot)
        self.state = self.backend.init_slots(self.n_slots, self.max_len,
                                             device=self.device)
        s = self.n_slots
        self._tok = np.zeros((s,), np.int64)
        self._pos = np.zeros((s,), np.int32)
        self._active = np.zeros((s,), bool)
        self._remaining = np.zeros((s,), np.int32)
        self._spec_k = np.zeros((s,), np.int32)
        self._slot_req: List[Optional[Request]] = [None] * s
        self._slot_toks: List[List[int]] = [[] for _ in range(s)]
        self._slot_admitted: List[int] = [0] * s
        # a slot whose prompt is still being consumed is occupied but
        # not yet decode-active
        self._ingest_req: List[Optional[Request]] = [None] * s
        self._ingest_cursor = np.zeros((s,), np.int64)
        self._queue: List[Request] = []   # sorted by (arrival, uid)
        self._completions: Dict[int, Completion] = {}
        self._clock = 0
        self._next_uid = 0
        self._gen = torch.Generator(device=self.device).manual_seed(
            self._seed)
        # JAX's PRNGKey(seed), kept only as the checkpoint's "key" leaf:
        # the port samples from _gen
        self._key = torch.tensor(
            [(self._seed >> 32) & 0xFFFFFFFF, self._seed & 0xFFFFFFFF],
            dtype=torch.int64).to(torch.uint32)
        # lifecycle & fault-tolerance bookkeeping
        self._suspended: List[SuspendedRequest] = []
        self._quarantined = np.zeros((s,), bool)
        self._retry_count: Dict[int, int] = {}   # uid → retries consumed
        self._ckpt: Dict[int, Checkpoint] = {}
        self._last_ckpt_event = np.zeros((s,), np.int64)
        self._cancel_uids: set = set()
        self._degraded = False
        self._events = 0          # segment/round boundaries elapsed
        self._admit_passes = 0    # admission passes attempted
        # durability: uids whose ack is already in the journal (delivered
        # by an earlier incarnation, never acked again), and the flag that
        # keeps replay from journaling journaled submits and cancels anew
        self._journal_acked: Dict[int, Completion] = {}
        self._replaying = False
        # the cache entries (paged blocks) each slot was admitted from,
        # pinned until the slot is torn down; stats report the cache's
        # counters as deltas since this reset
        self._cache_hold: List[Optional[Any]] = [None] * s
        self._cache_base = (self.cache.counters()
                            if self.cache is not None else None)
        if self.draft is not None:
            self.draft.reset()
        self.stats = EngineStats(n_slots=self.n_slots,
                                 segment_len=self.segment_len)

    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0,
               speculate_k: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None,
               uid: Optional[int] = None, fork: int = 1) -> int:
        """Queue a request; returns its uid. ``arrival`` is in logical
        decode steps (0 = at once); ``deadline_s`` an absolute logical
        completion deadline; ``priority`` orders admission (higher
        first, FIFO within a priority) and arms preemption of
        lower-priority slots; ``speculate_k`` > 0 decodes through
        draft/verify rounds of that many proposals (needs the engine's
        ``draft`` and greedy decoding); ``uid`` must not be below the
        engine's next uid. Every check runs before any engine state
        changes, so a raising submit leaves the queue, the uid counter
        and the stats as they were. A full bounded queue resolves its
        shed policy at once: the shed request completes
        ``status="shed"``. ``fork`` > 1 asks for N continuations of the
        one prompt: uids uid..uid+fork-1, the prompt encoded once, and
        at activation the N − 1 others spawn as suspended requests
        sharing the encoded state, each under greedy decoding the tokens
        of an independent submit. Returns the first uid."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if fork < 1:
            raise ValueError(f"fork must be >= 1, got {fork}")
        if uid is not None and uid < self._next_uid:
            raise ValueError(
                f"uid {uid} is not monotone (engine next uid is "
                f"{self._next_uid})")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) == 0:
            raise ValueError("the prompt must hold at least one token")
        if speculate_k < 0:
            raise ValueError(f"speculate_k must be >= 0, got {speculate_k}")
        if speculate_k > 0 and self.draft is None:
            raise ValueError(
                "speculate_k > 0 needs a draft provider on the engine")
        if speculate_k > 0 and self.temperature > 0.0:
            raise ValueError(
                "speculative decoding is greedy-only (temperature=0)")
        if deadline_s is not None and deadline_s <= arrival:
            raise ValueError(
                f"deadline_s ({deadline_s}) must be after arrival "
                f"({arrival})")
        # the verify writes up to speculate_k positions past the last
        # emitted token: the softmax caches must have room for them
        if len(prompt) + max_new_tokens + speculate_k > self.max_len + 1:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) + speculate_k ({speculate_k}) "
                f"exceeds engine max_len {self.max_len} + 1")
        # ---- validation complete; engine state changes start here -----
        if uid is None:
            uid = self._next_uid
        # write-ahead: the request is durable before any engine state
        # changes (replay re-applies journaled submits without a record)
        if self.journal is not None and not self._replaying:
            self.journal.append(submit_record(
                uid, prompt, max_new_tokens, arrival, speculate_k,
                priority, deadline_s, fork=fork))
        self._next_uid = uid + fork
        req = Request(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
                      arrival=arrival, speculate_k=speculate_k,
                      priority=priority, deadline_s=deadline_s, fork=fork)
        if self.max_queue is not None and len(self._queue) >= self.max_queue:
            victim = self._pick_shed_victim(req)
            self._shed(victim)
            if victim is req:
                return uid
        # an early-arriving request submitted late is not blocked behind
        # a far-future one
        bisect.insort(self._queue, req, key=_queue_key)
        return uid

    def _pick_shed_victim(self, incoming: Request) -> Request:
        """Full queue: "reject_new" sheds the arrival; "evict_lowest" the
        lowest-priority queued request (the newest of that tier) if it is
        strictly below the arrival, else the arrival."""
        if self.shed_policy == "reject_new":
            return incoming
        victim = min(self._queue,
                     key=lambda r: (r.priority, -r.arrival, -r.uid))
        if victim.priority < incoming.priority:
            self._queue.remove(victim)
            return victim
        return incoming

    def _shed(self, req: Request) -> None:
        self.stats.shed += 1
        self._complete(req, [], admitted_step=-1, status=STATUS_SHED)

    def cancel(self, uid: int) -> bool:
        """Cancel a request by uid. A queued or suspended one completes at
        once ``status="cancelled"`` (a suspended one with its partial
        tokens); an active or ingesting one is evicted at the next
        scheduling boundary. False if the uid is unknown or complete."""
        # write-ahead: the intent is durable before it takes effect (a
        # replayed cancel of a finished request is still a no-op)
        if self.journal is not None and not self._replaying:
            self.journal.append(cancel_record(uid))
        for i, r in enumerate(self._queue):
            if r.uid == uid:
                self._queue.pop(i)
                self.stats.cancelled += 1
                self._complete(r, [], admitted_step=-1,
                               status=STATUS_CANCELLED)
                return True
        for i, s in enumerate(self._suspended):
            if s.req.uid == uid:
                self._suspended.pop(i)
                self.stats.cancelled += 1
                self._complete(s.req, s.toks, admitted_step=s.admitted_step,
                               status=STATUS_CANCELLED, retries=s.retries)
                return True
        for slot in range(self.n_slots):
            req = self._slot_req[slot] or self._ingest_req[slot]
            if req is not None and req.uid == uid:
                self._cancel_uids.add(uid)
                return True
        return False

    def has_work(self) -> bool:
        """Anything queued, suspended, ingesting or decode-active?"""
        return bool(self._queue or self._suspended or self._active.any()
                    or self._any_ingesting())

    def queue_depth(self) -> int:
        """Requests waiting in the admission queue."""
        return len(self._queue)

    def shed_queued(self, uid: int) -> bool:
        """Shed a queued request by uid (``status="shed"``): a fleet's
        cross-group eviction, whose fleet-wide bounded queue may pick a
        victim in another group than the arrival's. False if the uid is
        not queued."""
        for i, r in enumerate(self._queue):
            if r.uid == uid:
                self._queue.pop(i)
                self._shed(r)
                return True
        return False

    def completions(self) -> List[Completion]:
        """Completions recorded so far, in uid order."""
        return [self._completions[u] for u in sorted(self._completions)]

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _complete(self, req: Request, tokens: List[int],
                  admitted_step: int, status: str = STATUS_OK,
                  retries: int = 0) -> None:
        # a fork primary that ends before activation (shed, deadline,
        # cancel, a budget of one, an instant EOS) never spawned its
        # members: they complete here with its outcome, as independent
        # submits would. After activation the primary carries fork=1.
        # Each member passes the journal-acked check itself, so replay
        # stays exactly-once per uid.
        if req.fork > 1:
            for i in range(1, req.fork):
                self._complete(dataclasses.replace(req, uid=req.uid + i,
                                                   fork=1),
                               list(tokens), admitted_step, status=status,
                               retries=retries)
            req = dataclasses.replace(req, fork=1)
        prior = self._journal_acked.get(req.uid)
        if prior is not None:
            # delivered by an earlier incarnation: its journaled ack is
            # the result (exactly once), never acked twice
            self._completions[req.uid] = prior
            return
        last = tokens[-1] if tokens else None
        if status == STATUS_OK:
            reason = ("eos" if self.eos_id is not None
                      and last == self.eos_id else "length")
        else:
            reason = status
        completion = Completion(
            uid=req.uid, prompt_len=len(req.prompt),
            tokens=np.asarray(tokens, np.int32), finish_reason=reason,
            admitted_step=admitted_step, finished_step=self._clock,
            status=status, retries=retries)
        if self.journal is not None:
            # ack-ahead: the delivery record is on stable storage before
            # the completion is observable; a crash between the two
            # serves the journaled ack on recovery
            self.journal.append(ack_record(completion))
            self._journal_acked[req.uid] = completion
        self._completions[req.uid] = completion

    def _release_hold(self, slot: int) -> None:
        """Drop the cache pins (paged-KV refcounts) the slot's request
        took at hit admission: called on every slot teardown."""
        hold = self._cache_hold[slot]
        if hold is not None:
            self._cache_hold[slot] = None
            self.cache.release(hold)

    def _sync_cache_stats(self) -> None:
        """The cache's counters in the stats, as deltas since the last
        reset (the cache survives reset)."""
        if self.cache is None:
            return
        c, b = self.cache.counters(), self._cache_base
        self.stats.cache_hits = c["hits"] - b["hits"]
        self.stats.cache_misses = c["misses"] - b["misses"]
        self.stats.cache_evictions = c["evictions"] - b["evictions"]

    def _miss(self, kind: str, width: int) -> None:
        """Count an admission program shape not seen before."""
        key = (kind, width)
        if key not in self._seen_shapes:
            self._seen_shapes.add(key)
            self.stats.prefill_jit_misses += 1

    def _sample(self, logits: torch.Tensor) -> np.ndarray:
        """First tokens from (n, V) logits, brought to the host at once."""
        return self.backend.sample_token(
            logits, self.temperature, self._gen).cpu().numpy()

    def _admissible(self) -> bool:
        return bool(self._queue) and self._queue[0].arrival <= self._clock

    def _work_waiting(self) -> bool:
        return bool(self._suspended) or self._admissible()

    def _any_ingesting(self) -> bool:
        return any(r is not None for r in self._ingest_req)

    def _slot_free(self, slot: int) -> bool:
        return (not self._active[slot] and self._ingest_req[slot] is None
                and not self._quarantined[slot])

    def _prompt(self, req: Request) -> torch.Tensor:
        return torch.from_numpy(req.prompt).long()[None].to(self.device)

    def _admit_one(self, slot: int, req: Request) -> None:
        """Per-request admission: prefill the prompt alone (unpadded),
        sample the first token, write the state into ``slot``. A request
        whose budget is one token (or whose first token is EOS)
        completes here and never occupies the slot."""
        self._miss("prefill_raw", len(req.prompt))
        logits, st_req = self.backend.prefill(self.params, self._prompt(req))
        self.stats.prefills += 1
        self.stats.admission_dispatches += 1
        tok0 = int(self._sample(logits)[0])
        if req.max_new_tokens <= 1 or (self.eos_id is not None
                                       and tok0 == self.eos_id):
            self._complete(req, [tok0], admitted_step=self._clock,
                           retries=self._retry_count.pop(req.uid, 0))
            return
        self.backend.write_slot_state(self.state, st_req, slot)
        self.stats.admission_dispatches += 1
        self._activate_slot(slot, req, tok0)

    def _activate_slot(self, slot: int, req: Request, tok0: int) -> None:
        """Flip a slot whose prompt is encoded to decode-active (plain
        under degradation), and take its activation checkpoint.

        A fork spawns here: the N − 1 other continuations become
        suspended requests sharing one snapshot of the slot (an owned
        copy, which each resume copies into its own slot and nothing
        writes), and the slot's request drops to fork=1, so a requeue
        (a quarantine retry) never spawns them again."""
        members: List[Request] = []
        if req.fork > 1:
            members = [dataclasses.replace(req, uid=req.uid + i, fork=1)
                       for i in range(1, req.fork)]
            req = dataclasses.replace(req, fork=1)
        spec_k = req.speculate_k
        if spec_k > 0 and self._degraded:
            spec_k = 0               # overload: lookahead off; the greedy
            self.stats.spec_disables += 1   # tokens are the same
        self._tok[slot] = tok0
        self._pos[slot] = len(req.prompt)
        self._active[slot] = True
        self._remaining[slot] = req.max_new_tokens - 1
        self._spec_k[slot] = spec_k
        self._slot_req[slot] = req
        self._slot_toks[slot] = [tok0]
        self._slot_admitted[slot] = self._clock
        if spec_k > 0:
            self.draft.admit(
                slot, np.concatenate([req.prompt, [tok0]]).astype(np.int32))
        if members:
            snap = self._slot_snapshot(slot,
                                       self._bucket(int(self._pos[slot])))
            for m in members:
                self._suspended.append(SuspendedRequest(
                    req=m, state=snap, tok=tok0, pos=len(req.prompt),
                    remaining=req.max_new_tokens - 1, toks=[tok0],
                    admitted_step=self._clock, retries=0))
                self.stats.forks += 1
        if self.finite_check and self.max_retries > 0:
            # the last known-good restore point a later fault retries from
            self._checkpoint_slot(slot)

    def _slot_snapshot(self, slot: int, rows: int):
        """A batch-1 copy of ``slot``, row-ranged under a KV cache (its
        first ``rows`` rows: O(W·k) instead of O(max_len·k)); whole for
        the fixed-size states."""
        w = (self.max_len if self.backend.fixed_size_state
             else min(int(rows), self.max_len))
        return self.backend.snapshot_state_rows(self.state, slot, w)

    def _checkpoint_slot(self, slot: int) -> None:
        self._ckpt[slot] = Checkpoint(
            state=self._slot_snapshot(slot,
                                      self._bucket(int(self._pos[slot]))),
            tok=int(self._tok[slot]), pos=int(self._pos[slot]),
            remaining=int(self._remaining[slot]),
            toks=list(self._slot_toks[slot]))
        self._last_ckpt_event[slot] = self._events
        self.stats.checkpoints += 1

    # -- admission order: priority first, FIFO within a priority --------

    def _best_queued_idx(self) -> Optional[int]:
        """Index of the best admissible queued request by
        (-priority, arrival, uid); the queue is arrival-sorted, so the
        admissible requests are a prefix of it."""
        best, best_key = None, None
        for i, r in enumerate(self._queue):
            if r.arrival > self._clock:
                break
            key = (-r.priority, r.arrival, r.uid)
            if best_key is None or key < best_key:
                best, best_key = i, key
        return best

    def _pop_admission(self) -> Tuple[str, Any]:
        """The next item to admit: the best of the admissible queue and
        the suspended pool (a suspended request wins a tie: it has paid
        its prefill). ("resume", SuspendedRequest) or ("new", Request)."""
        qi = self._best_queued_idx()
        si, si_key = None, None
        for i, s in enumerate(self._suspended):
            key = (-s.req.priority, s.req.arrival, s.req.uid)
            if si_key is None or key < si_key:
                si, si_key = i, key
        if si is not None and (qi is None or si_key <= (
                -self._queue[qi].priority, self._queue[qi].arrival,
                self._queue[qi].uid)):
            return "resume", self._suspended.pop(si)
        if qi is None:
            raise RuntimeError("_pop_admission with nothing waiting")
        return "new", self._queue.pop(qi)

    def _resume_into(self, slot: int, susp: SuspendedRequest) -> None:
        """Re-admit a suspended request: one ``restore_state_rows`` copy
        of its snapshot plus the scalars. Greedy decode depends only on
        (state, tok, pos), so it continues as if never suspended."""
        req = susp.req
        self.backend.restore_state_rows(self.state, susp.state, slot)
        spec_k = req.speculate_k
        if spec_k > 0 and self._degraded:
            spec_k = 0
            self.stats.spec_disables += 1
        self._tok[slot] = susp.tok
        self._pos[slot] = susp.pos
        self._active[slot] = True
        self._remaining[slot] = susp.remaining
        self._spec_k[slot] = spec_k
        self._slot_req[slot] = req
        self._slot_toks[slot] = list(susp.toks)
        self._slot_admitted[slot] = susp.admitted_step
        self._retry_count[req.uid] = susp.retries
        if spec_k > 0:
            self.draft.admit(slot, np.concatenate(
                [req.prompt, susp.toks]).astype(np.int32))
        if self.finite_check and self.max_retries > 0:
            # the incoming snapshot is the slot's last known-good state
            self._ckpt[slot] = Checkpoint(
                state=susp.state, tok=susp.tok, pos=susp.pos,
                remaining=susp.remaining, toks=list(susp.toks))
            self._last_ckpt_event[slot] = self._events
        self.stats.resumes += 1

    def _vacate(self, slot: int) -> None:
        """Tear a slot down: release the draft and the prefix-cache hold
        and forget the request. Its state row is abandoned; inactive rows
        are masked in every pass, so nothing needs resetting."""
        if self._slot_req[slot] is not None and self._spec_k[slot] > 0:
            self.draft.release(slot)
        self._slot_req[slot] = None
        self._slot_toks[slot] = []
        self._spec_k[slot] = 0
        self._active[slot] = False
        self._ingest_req[slot] = None
        self._ingest_cursor[slot] = 0
        self._release_hold(slot)

    def preempt(self, slot: int) -> SuspendedRequest:
        """Swap the active request out of ``slot`` into a host-side
        :class:`SuspendedRequest` (one snapshot copy and the scalars).
        The slot frees at once; the request rejoins the admission pool
        and continues bit for bit."""
        req = self._slot_req[slot]
        if not self._active[slot] or req is None:
            raise ValueError(f"slot {slot} holds no active request")
        susp = SuspendedRequest(
            req=req,
            state=self._slot_snapshot(slot,
                                      self._bucket(int(self._pos[slot]))),
            tok=int(self._tok[slot]), pos=int(self._pos[slot]),
            remaining=int(self._remaining[slot]),
            toks=list(self._slot_toks[slot]),
            admitted_step=self._slot_admitted[slot],
            retries=self._retry_count.get(req.uid, 0))
        self._ckpt.pop(slot, None)
        self._vacate(slot)
        self._suspended.append(susp)
        self.stats.preemptions += 1
        return susp

    def _preempt_pass(self) -> None:
        """Priority preemption: while every slot is taken and a waiting
        item outranks a running one, suspend victims, the lowest
        (priority, progress) decode-active slots first, until each
        strictly higher-priority waiting item has a slot."""
        waiting = sorted(
            [r.priority for r in self._queue if r.arrival <= self._clock]
            + [s.req.priority for s in self._suspended], reverse=True)
        idx = sum(self._slot_free(s) for s in range(self.n_slots))
        while idx < len(waiting):
            victims = [s for s in range(self.n_slots)
                       if self._active[s] and self._slot_req[s] is not None]
            if not victims:
                return
            victim = min(victims, key=lambda s: (
                self._slot_req[s].priority, len(self._slot_toks[s]), s))
            if self._slot_req[victim].priority >= waiting[idx]:
                return
            self.preempt(victim)
            idx += 1

    def _admit_pass(self, policy: str) -> None:
        if policy == "static" and (self._active.any()
                                   or self._any_ingesting()):
            return             # batch-synchronous: wait for the whole batch
        if not self._work_waiting():
            return
        pass_idx = self._admit_passes
        self._admit_passes += 1
        if (self.injector is not None
                and self.injector.drops_admission(pass_idx)):
            return                    # chaos: this wave never happens
        if policy == "continuous":
            self._preempt_pass()
        if self.admission == "per_request":
            for slot in range(self.n_slots):
                # keep feeding the slot while requests complete at
                # admission (a budget of one never occupies it)
                while self._slot_free(slot) and self._work_waiting():
                    kind, item = self._pop_admission()
                    if kind == "resume":
                        self._resume_into(slot, item)
                    else:
                        self._admit_one(slot, item)
            return
        # batched: fill every free slot from the pool (resumes land at
        # once, new requests join the wave), then encode the wave's first
        # chunks in one bucket-padded varlen prefill. Loop, because
        # requests that complete at admission free their slots at the
        # same logical clock.
        while self._work_waiting():
            newly, resumed, cache_hits = [], 0, 0
            for slot in range(self.n_slots):
                if not self._slot_free(slot) or not self._work_waiting():
                    continue
                kind, item = self._pop_admission()
                if kind == "resume":
                    self._resume_into(slot, item)
                    resumed += 1
                    continue
                self._ingest_req[slot] = item
                self._ingest_cursor[slot] = 0
                hit = None
                if (self.cache is not None
                        and len(item.prompt) > self.cache.chunk):
                    hit = self.cache.match(item.prompt)
                if hit is None:
                    newly.append(slot)
                    continue
                # a hit: ONE copy lands the cached prefix in the slot and
                # the cursor jumps to its boundary; the suffix is left to
                # the continuation chunks, on the cold chunk grid
                self.backend.restore_state_rows(self.state, hit.state, slot)
                self._ingest_cursor[slot] = hit.n_tokens
                self._cache_hold[slot] = hit
                self.stats.admission_dispatches += 1
                self.stats.cached_prefix_tokens += hit.n_tokens
                cache_hits += 1
            if newly:
                self._ingest_chunk(newly, first=True)
            elif not (resumed or cache_hits):
                break
        self._sync_cache_stats()

    def _bucket(self, n: int) -> int:
        return min(_pow2_ceil(max(1, n)), self.max_len)

    def _live_chunk(self) -> int:
        """The ingest chunk: halved while degraded (still a power of two,
        at least min(8, prefill_chunk)), so ingest yields to decode
        sooner under load."""
        if not self._degraded:
            return self.prefill_chunk
        return max(min(8, self.prefill_chunk), self.prefill_chunk // 2)

    def _ingest_chunk(self, slots: List[int], *, first: bool) -> None:
        """Consume the next <= ``_live_chunk()`` prompt tokens of every
        ingesting slot in ``slots`` in one pass.

        ``first`` rows start from nothing: the wave is encoded by
        ``prefill_varlen`` (bucket-padded, per-row masked) and its rows
        alone are copied into their slots (``where_state``); a wave of
        one is encoded at batch 1 and written into its slot. Length-1
        prompts are encoded unpadded at batch 1, as JAX does (there a
        single-token forward is the one shape XLA lowers differently
        from its padded bucket). Continuation rows advance the engine
        state in place through the ingest program; every row not in the
        chunk has ``lens = 0`` and keeps its state bit for bit."""
        be = self.backend
        if first:
            ones = [s for s in slots if len(self._ingest_req[s].prompt) == 1]
            for slot in ones:
                self._miss("prefill_raw", 1)
                logits, st_req = be.prefill(
                    self.params, self._prompt(self._ingest_req[slot]))
                be.write_slot_state(self.state, st_req, slot)
                self.stats.prefills += 1
                self.stats.admission_dispatches += 2
                self._ingest_cursor[slot] = 1
                self._finish_ingest(slot, int(self._sample(logits)[0]))
            slots = [s for s in slots if s not in ones]
            if not slots:
                return
        counts = {}
        for slot in slots:
            req = self._ingest_req[slot]
            cur = int(self._ingest_cursor[slot])
            counts[slot] = min(len(req.prompt) - cur, self._live_chunk())
        width = self._bucket(max(counts.values()))
        tokens = np.zeros((self.n_slots, width), np.int64)
        lens = np.zeros((self.n_slots,), np.int32)
        pos0 = np.zeros((self.n_slots,), np.int32)
        for slot in slots:
            req = self._ingest_req[slot]
            cur = int(self._ingest_cursor[slot])
            c = min(counts[slot], width)
            tokens[slot, :c] = req.prompt[cur:cur + c]
            lens[slot] = c
            pos0[slot] = cur
        dev = self.device
        tokens_t = torch.from_numpy(tokens).to(dev)
        lens_t = torch.from_numpy(lens).to(dev)
        rows = torch.as_tensor(slots, device=dev)

        if first:
            if len(slots) == 1:
                # steady state: one freed slot refills from a compact
                # batch-1 pass, never n_slots padded rows
                slot = slots[0]
                self._miss("prefill_varlen_one", width)
                last, st = be.prefill_varlen(
                    self.params, tokens_t[slot:slot + 1],
                    lens_t[slot:slot + 1])
                be.write_slot_state(self.state, st, slot)
            else:
                self._miss("prefill_varlen", width)
                mask = np.zeros((self.n_slots,), bool)
                mask[slots] = True
                last, st = be.prefill_varlen(self.params, tokens_t, lens_t)
                be.where_state(torch.from_numpy(mask), st, self.state)
                last = last[rows]
            self.stats.admission_batches += 1
            self.stats.prefills += len(slots)
            self.stats.prefill_dispatches += 1
            self.stats.admission_dispatches += 1
        else:
            # miss keys name JAX's jit programs: the recurrent ingest is
            # its varlen window program, shared with the speculative
            # rewind
            parallel = self.ingest == "parallel"
            self._miss("ingest_varlen" if parallel else "window_varlen",
                       width)
            program = (be.ingest_window_varlen if parallel
                       else be.decode_window_varlen)
            last, self.state = program(
                self.params, self.state, tokens_t,
                torch.from_numpy(pos0).to(dev), lens_t, last_only=True)
            last = last[rows]
            self.stats.ingest_chunks += 1
            self.stats.admission_dispatches += 1
            if self._active.any():
                self.stats.ingest_interleaved += 1

        finished = [i for i, slot in enumerate(slots)
                    if self._ingest_cursor[slot] + int(lens[slot])
                    >= len(self._ingest_req[slot].prompt)]
        toks0 = {}
        if finished:
            toks0 = {slots[i]: int(t) for i, t in
                     zip(finished, self._sample(last[finished]))}
        for slot in slots:
            self._ingest_cursor[slot] += int(lens[slot])
            req = self._ingest_req[slot]
            cur = int(self._ingest_cursor[slot])
            # insert at every chunk boundary the ingest crosses (degraded
            # half-chunks land on them too), before the slot finishes:
            # a row-ranged copy of exactly `cur` rows, which the paged
            # cache splits into blocks; `wants` gates the copy on novelty
            if (self.cache is not None and cur % self.cache.chunk == 0
                    and self.cache.wants(req.prompt, cur)):
                self.cache.insert(req.prompt, cur,
                                  self._slot_snapshot(slot, cur))
            if slot in toks0:
                self._finish_ingest(slot, toks0[slot])
        self._sync_cache_stats()

    def _ingest_step(self) -> None:
        """One continuation-chunk pass over every mid-prompt slot, run
        before the segment: long prompts interleave with decode."""
        rows = [s for s in range(self.n_slots)
                if self._ingest_req[s] is not None]
        if rows:
            self._ingest_chunk(rows, first=False)

    def _finish_ingest(self, slot: int, tok0: int) -> None:
        """The slot's whole prompt is consumed and its first token
        sampled: activate it, or complete at once on a budget of one or
        an EOS."""
        req = self._ingest_req[slot]
        self._ingest_req[slot] = None
        self._ingest_cursor[slot] = 0
        if req.max_new_tokens <= 1 or (self.eos_id is not None
                                       and tok0 == self.eos_id):
            self._complete(req, [tok0], admitted_step=self._clock,
                           retries=self._retry_count.pop(req.uid, 0))
            self._release_hold(slot)
            return
        self._activate_slot(slot, req, tok0)

    def step_segment(self) -> None:
        """One ``segment_len``-step segment over the plain (not
        speculative) active slots, then drain the finished ones;
        speculative slots ride along masked, bit for bit. One host sync:
        the segment's tokens and the carried tok, pos, active and
        remaining come back as one tensor."""
        dev = self.device
        run_active = self._active & (self._spec_k == 0)
        toks, carry = self.backend.generate_segment(
            self.params, self.state,
            torch.from_numpy(self._tok).to(dev),
            torch.from_numpy(self._pos).to(dev),
            torch.from_numpy(run_active).to(dev),
            torch.from_numpy(self._remaining).to(dev),
            self.segment_len, eos_id=self.eos_id,
            temperature=self.temperature, generator=self._gen,
            pad_id=PAD_ID)
        self.state = carry["state"]
        host = torch.cat([toks, torch.stack(
            [carry["tok"], carry["pos"].long(), carry["active"].long(),
             carry["remaining"].long()], dim=1)], dim=1).cpu().numpy()
        emitted = host[:, :self.segment_len]
        # masked rows come back with tok, pos and remaining untouched and
        # active False: keep the speculative slots' own flag
        self._tok = host[:, -4].copy()
        self._pos = host[:, -3].astype(np.int32)
        self._active = np.where(run_active, host[:, -2].astype(bool),
                                self._active)
        self._remaining = host[:, -1].astype(np.int32)
        self._clock += self.segment_len
        self.stats.segments += 1
        self.stats.emitted_tokens += int((emitted != PAD_ID).sum())
        for slot in range(self.n_slots):
            if not run_active[slot]:
                continue
            row = emitted[slot]
            self._slot_toks[slot].extend(int(t) for t in row[row != PAD_ID])
            if not self._active[slot]:                # finished mid-segment
                self._free_slot(slot)

    def _free_slot(self, slot: int) -> None:
        req = self._slot_req[slot]
        self._complete(req, self._slot_toks[slot],
                       admitted_step=self._slot_admitted[slot],
                       retries=self._retry_count.pop(req.uid, 0))
        self._ckpt.pop(slot, None)
        self._vacate(slot)

    # ------------------------------------------------------------------
    # lifecycle & fault tolerance
    # ------------------------------------------------------------------

    def _evict(self, slot: int, status: str) -> None:
        """Complete a slot's request now, with its partial tokens, and
        free the slot."""
        active = self._slot_req[slot] is not None
        req = self._slot_req[slot] or self._ingest_req[slot]
        self._complete(req, list(self._slot_toks[slot]) if active else [],
                       admitted_step=(self._slot_admitted[slot] if active
                                      else -1),
                       status=status,
                       retries=self._retry_count.pop(req.uid, 0))
        self._ckpt.pop(slot, None)
        self._vacate(slot)

    def _set_degraded(self, on: bool, pressure: float) -> None:
        self._degraded = on
        self.stats.degrade_transitions += 1
        self.stats.degrade_events.append({
            "clock": self._clock, "degraded": on,
            "pressure": round(pressure, 3)})
        if on:
            # live speculative slots turn plain: speculation emits the
            # greedy sequence, so dropping it sheds lookahead, no token
            for slot in range(self.n_slots):
                if self._active[slot] and self._spec_k[slot] > 0:
                    self.draft.release(slot)
                    self._spec_k[slot] = 0
                    self.stats.spec_disables += 1

    def _lifecycle_pass(self) -> None:
        """Boundary housekeeping: drain cancellations, enforce deadlines
        wherever a request waits or runs, flip degradation (with
        hysteresis)."""
        if self._cancel_uids:
            for slot in range(self.n_slots):
                req = self._slot_req[slot] or self._ingest_req[slot]
                if req is not None and req.uid in self._cancel_uids:
                    self._cancel_uids.discard(req.uid)
                    self.stats.cancelled += 1
                    self._evict(slot, STATUS_CANCELLED)
        for r in [r for r in self._queue if r.deadline_s is not None
                  and r.deadline_s <= self._clock]:
            self._queue.remove(r)
            self.stats.deadline_evictions += 1
            self._complete(r, [], admitted_step=-1, status=STATUS_DEADLINE)
        for s in [s for s in self._suspended
                  if s.req.deadline_s is not None
                  and s.req.deadline_s <= self._clock]:
            self._suspended.remove(s)
            self.stats.deadline_evictions += 1
            self._complete(s.req, s.toks, admitted_step=s.admitted_step,
                           status=STATUS_DEADLINE, retries=s.retries)
        for slot in range(self.n_slots):
            req = self._slot_req[slot] or self._ingest_req[slot]
            if (req is not None and req.deadline_s is not None
                    and req.deadline_s <= self._clock):
                self.stats.deadline_evictions += 1
                self._evict(slot, STATUS_DEADLINE)
        if self.degrade_threshold is not None:
            waiting = len(self._suspended) + sum(
                1 for r in self._queue if r.arrival <= self._clock)
            pressure = waiting / self.n_slots
            if not self._degraded and pressure >= self.degrade_threshold:
                self._set_degraded(True, pressure)
            elif self._degraded and pressure <= self.degrade_threshold / 2:
                self._set_degraded(False, pressure)

    def _quarantine(self, slot: int) -> None:
        """A non-finite state in ``slot``: quarantine the slot for the
        rest of the run (its NaNs stay put, masked like any inactive
        row, so its neighbours are bit for bit a fault-free run's) and
        retry its request from the last good checkpoint on a fresh slot,
        up to ``max_retries`` times, else complete it
        ``status="failed"``."""
        self.stats.quarantined += 1
        self._quarantined[slot] = True
        req = self._slot_req[slot] or self._ingest_req[slot]
        ckpt = self._ckpt.pop(slot, None)
        if req is not None:
            used = self._retry_count.get(req.uid, 0)
            if used < self.max_retries:
                self._retry_count[req.uid] = used + 1
                self.stats.retries += 1
                if ckpt is not None:
                    self._suspended.append(SuspendedRequest(
                        req=req, state=ckpt.state, tok=ckpt.tok,
                        pos=ckpt.pos, remaining=ckpt.remaining,
                        toks=list(ckpt.toks),
                        admitted_step=self._slot_admitted[slot],
                        retries=used + 1))
                else:
                    # poisoned mid-ingest: nothing emitted, so the last
                    # good state is the empty start
                    bisect.insort(self._queue, req, key=_queue_key)
            else:
                self.stats.failed += 1
                self._retry_count.pop(req.uid, None)
                self._complete(
                    req, list(ckpt.toks) if ckpt is not None else [],
                    status=STATUS_FAILED, retries=used,
                    admitted_step=(self._slot_admitted[slot]
                                   if self._slot_req[slot] is not None
                                   else -1))
        self._vacate(slot)

    def _post_event(self) -> None:
        """Segment/round boundary: chaos injection, the finite probe and
        quarantine, periodic checkpoints of healthy active slots."""
        ev = self._events
        if self.injector is not None and self.injector.crashes(ev):
            # a process death at a boundary: nothing after this runs
            raise InjectedCrash(ev)
        self._events += 1
        if self.injector is not None:
            be = self.backend
            for slot in self.injector.nan_slots(ev):
                be.restore_state(self.state, poison_snapshot(
                    be.snapshot_state(self.state, slot)), slot)
            self._clock += self.injector.extra_delay(ev)
        if self.finite_check:
            occupied = self._active | np.asarray(
                [r is not None for r in self._ingest_req])
            if occupied.any():
                finite = self.backend.slot_state_finite(
                    self.state).cpu().numpy()
                self.stats.finite_checks += 1
                for slot in np.nonzero(occupied & ~finite
                                       & ~self._quarantined)[0]:
                    self._quarantine(int(slot))
        if (self.checkpoint_interval > 0 and self.finite_check
                and self.max_retries > 0):
            for slot in range(self.n_slots):
                if (self._active[slot] and not self._quarantined[slot]
                        and self._events - self._last_ckpt_event[slot]
                        >= self.checkpoint_interval):
                    self._checkpoint_slot(slot)
        if (self._ckpt_mgr is not None and self.checkpoint_every > 0
                and self._events % self.checkpoint_every == 0):
            self.save_checkpoint()

    def _fail_all_pending(self) -> None:
        """Every slot is quarantined: nothing can run again, so fail the
        remaining work instead of spinning."""
        for s in self._suspended:
            self.stats.failed += 1
            self._complete(s.req, s.toks, admitted_step=s.admitted_step,
                           status=STATUS_FAILED, retries=s.retries)
        self._suspended = []
        for r in self._queue:
            self.stats.failed += 1
            self._complete(r, [], admitted_step=-1, status=STATUS_FAILED)
        self._queue = []

    # ------------------------------------------------------------------
    # durability: engine checkpoints and journal replay
    # ------------------------------------------------------------------

    @staticmethod
    def _req_to_dict(req: Request) -> Dict:
        return {"uid": int(req.uid),
                "prompt": np.asarray(req.prompt, np.int32).tolist(),
                "max_new_tokens": int(req.max_new_tokens),
                "arrival": float(req.arrival),
                "speculate_k": int(req.speculate_k),
                "priority": int(req.priority),
                "deadline_s": (None if req.deadline_s is None
                               else float(req.deadline_s)),
                "fork": int(req.fork)}

    @staticmethod
    def _req_from_dict(d: Dict) -> Request:
        return Request(uid=d["uid"],
                       prompt=np.asarray(d["prompt"], np.int32),
                       max_new_tokens=d["max_new_tokens"],
                       arrival=d["arrival"], speculate_k=d["speculate_k"],
                       priority=d["priority"], deadline_s=d["deadline_s"],
                       fork=d.get("fork", 1))

    @staticmethod
    def _snapshot_kv_rows(snap) -> int:
        """The KV rows of a (possibly row-ranged) snapshot, -1 when it
        holds no KV cache (the fixed-size states): written beside the
        checkpoint so that restore rebuilds each snapshot's template."""
        for part in sorted(snap):
            for st in snap[part]:
                if isinstance(st, AttnState) and st.k_cache is not None:
                    return int(st.k_cache.shape[st.k_cache.ndim - 3])
        return -1

    def _snapshot_template(self, rows: int):
        """The tree of a ``rows``-row slot snapshot, as views of the
        engine's state (nothing copied); ``rows`` < 0 means whole."""
        w = self.max_len if rows is None or rows < 0 else int(rows)
        return self.backend.state_rows_view(
            self.state, 0, max(1, min(w, self.max_len)))

    def _generator_state(self) -> Dict[str, str]:
        return {"device": self.device.type,
                "state": base64.b64encode(bytes(
                    self._gen.get_state().numpy())).decode("ascii")}

    def _set_generator_state(self, saved: Optional[Dict[str, str]]) -> None:
        """The sampling generator as saved, or seeded from ``seed`` when
        the checkpoint has none (a JAX checkpoint) or another device's."""
        self._gen = torch.Generator(device=self.device)
        if saved is None or saved.get("device") != self.device.type:
            self._gen.manual_seed(self._seed)
            return
        raw = np.frombuffer(base64.b64decode(saved["state"]), np.uint8)
        self._gen.set_state(torch.from_numpy(raw.copy()))

    def save_checkpoint(self, step: Optional[int] = None) -> int:
        """Write a whole-engine checkpoint through the atomic writer, in
        JAX's layout. The tree holds the slot batch, the ``key`` leaf and
        every suspended and last-good snapshot: O(S·k²) floats per layer
        for the paper's fixed-size backends whatever the contexts (the
        softmax baseline writes its KV caches). The host state (queues,
        per-slot scalars, completions, stats, the logical clock and the
        generator's state) rides in ``extra``; ``journal_seq`` is the
        journal position the checkpoint holds, so recovery replays only
        later records. Needs ``checkpoint_dir``; returns the step (the
        event counter unless given)."""
        if self._ckpt_mgr is None:
            raise ValueError("engine has no checkpoint_dir configured")
        step = self._events if step is None else int(step)
        tree = {
            "key": self._key,
            "slot_ckpt": {str(s): c.state
                          for s, c in sorted(self._ckpt.items())},
            "state": self.state,
            "suspended": tuple(s.state for s in self._suspended),
        }
        extra = {
            "journal_seq": (self.journal.seq
                            if self.journal is not None else 0),
            "clock": int(self._clock),
            "events": int(self._events),
            "admit_passes": int(self._admit_passes),
            "next_uid": int(self._next_uid),
            "tok": self._tok.tolist(), "pos": self._pos.tolist(),
            "active": [bool(a) for a in self._active],
            "remaining": self._remaining.tolist(),
            "spec_k": self._spec_k.tolist(),
            "slot_req": [None if r is None else self._req_to_dict(r)
                         for r in self._slot_req],
            "slot_toks": [list(t) for t in self._slot_toks],
            "slot_admitted": [int(a) for a in self._slot_admitted],
            "ingest_req": [None if r is None else self._req_to_dict(r)
                           for r in self._ingest_req],
            "ingest_cursor": self._ingest_cursor.tolist(),
            "queue": [self._req_to_dict(r) for r in self._queue],
            "suspended": [
                {"req": self._req_to_dict(s.req), "tok": int(s.tok),
                 "pos": int(s.pos), "remaining": int(s.remaining),
                 "toks": list(s.toks),
                 "admitted_step": int(s.admitted_step),
                 "retries": int(s.retries)}
                for s in self._suspended],
            "slot_ckpt": {
                str(s): {"tok": int(c.tok), "pos": int(c.pos),
                         "remaining": int(c.remaining),
                         "toks": list(c.toks)}
                for s, c in sorted(self._ckpt.items())},
            # row-ranged snapshot widths (KV rows; -1 for fixed-size
            # states): restore rebuilds the templates from them, so a
            # ranged snapshot round-trips
            "suspended_rows": [self._snapshot_kv_rows(s.state)
                               for s in self._suspended],
            "slot_ckpt_rows": {
                str(s): self._snapshot_kv_rows(c.state)
                for s, c in sorted(self._ckpt.items())},
            "completions": [ack_record(c)
                            for _, c in sorted(self._completions.items())],
            "quarantined": [bool(q) for q in self._quarantined],
            "retry_count": {str(u): int(n)
                            for u, n in self._retry_count.items()},
            "last_ckpt_event": self._last_ckpt_event.tolist(),
            "cancel_uids": sorted(int(u) for u in self._cancel_uids),
            "degraded": bool(self._degraded),
            "stats": dataclasses.asdict(self.stats),
            "seen_shapes": sorted(list(k) for k in self._seen_shapes),
            # the port's own: JAX reads no such key
            "torch_generator": self._generator_state(),
        }
        self._ckpt_mgr.save(step, tree, extra, blocking=True)
        return step

    def restore_checkpoint(self, step: Optional[int] = None) -> int:
        """Restore this engine from its checkpoint directory (the newest
        retained step by default, past corrupt ones), written by either
        package. The engine must be built with the (params, cfg,
        n_slots, max_len) the checkpoint was written under: the tree's
        structure follows the config. Returns the journal position the
        checkpoint holds (where replay starts)."""
        if self._ckpt_mgr is None:
            raise ValueError("engine has no checkpoint_dir configured")

        def like_fn(extra):
            susp_rows = extra.get("suspended_rows",
                                  [-1] * len(extra["suspended"]))
            ck_rows = extra.get("slot_ckpt_rows", {})
            return {"key": torch.zeros(2, dtype=torch.uint32),
                    "slot_ckpt": {k: self._snapshot_template(
                        ck_rows.get(k, -1)) for k in sorted(
                            extra["slot_ckpt"])},
                    "state": self.state,
                    "suspended": tuple(self._snapshot_template(w)
                                       for w in susp_rows)}

        tree, extra, _ = self._ckpt_mgr.restore_with(like_fn, step)
        for slot in range(self.n_slots):
            self._release_hold(slot)
        self.state = tree["state"]
        self._key = tree["key"]
        self._clock = extra["clock"]
        self._events = extra["events"]
        self._admit_passes = extra["admit_passes"]
        self._next_uid = extra["next_uid"]
        self._tok = np.asarray(extra["tok"], np.int64)
        self._pos = np.asarray(extra["pos"], np.int32)
        self._active = np.asarray(extra["active"], bool)
        self._remaining = np.asarray(extra["remaining"], np.int32)
        self._spec_k = np.asarray(extra["spec_k"], np.int32)
        self._slot_req = [None if d is None else self._req_from_dict(d)
                          for d in extra["slot_req"]]
        self._slot_toks = [list(t) for t in extra["slot_toks"]]
        self._slot_admitted = list(extra["slot_admitted"])
        self._ingest_req = [None if d is None else self._req_from_dict(d)
                            for d in extra["ingest_req"]]
        self._ingest_cursor = np.asarray(extra["ingest_cursor"], np.int64)
        self._queue = [self._req_from_dict(d) for d in extra["queue"]]
        self._suspended = [
            SuspendedRequest(
                req=self._req_from_dict(d["req"]),
                state=tree["suspended"][i], tok=d["tok"], pos=d["pos"],
                remaining=d["remaining"], toks=list(d["toks"]),
                admitted_step=d["admitted_step"], retries=d["retries"])
            for i, d in enumerate(extra["suspended"])]
        self._ckpt = {
            int(k): Checkpoint(state=tree["slot_ckpt"][k], tok=d["tok"],
                               pos=d["pos"], remaining=d["remaining"],
                               toks=list(d["toks"]))
            for k, d in extra["slot_ckpt"].items()}
        self._completions = {rec["uid"]: completion_from_ack(rec)
                             for rec in extra["completions"]}
        self._quarantined = np.asarray(extra["quarantined"], bool)
        self._retry_count = {int(u): n
                             for u, n in extra["retry_count"].items()}
        self._last_ckpt_event = np.asarray(extra["last_ckpt_event"],
                                           np.int64)
        self._cancel_uids = set(extra["cancel_uids"])
        self._degraded = extra["degraded"]
        self.stats = EngineStats(**extra["stats"])
        self._seen_shapes = {tuple(k) for k in extra["seen_shapes"]}
        self._set_generator_state(extra.get("torch_generator"))
        # a draft provider's per-slot state follows from prompt + emitted
        # tokens: re-admit rather than serialise (ModelDraft re-prefills)
        if self.draft is not None:
            self.draft.reset()
            for slot in range(self.n_slots):
                if self._active[slot] and self._spec_k[slot] > 0:
                    req = self._slot_req[slot]
                    self.draft.admit(slot, np.concatenate(
                        [req.prompt, self._slot_toks[slot]]
                    ).astype(np.int32))
        return extra.get("journal_seq", 0)

    def _replay_journal(self, from_seq: int = 0) -> None:
        """Re-apply the journal's records past ``from_seq`` (the position
        the restored checkpoint holds; 0 without one). Journaled acks are
        the delivery record: their uids are served the recorded
        completion, from before the checkpoint too, and their submits do
        not run again. Unacked submits re-enter the queue under their own
        uids (journal order is uid order, so uids stay monotone), and
        greedy decoding reproduces their tokens. A cancel journaled while
        its request ran replays against the requeued request."""
        if self.journal is None:
            raise ValueError("engine has no journal to replay")
        records = self.journal.records()
        for rec in records:
            if rec["t"] == REC_ACK:
                self._journal_acked[rec["uid"]] = completion_from_ack(rec)
        self._completions.update(self._journal_acked)
        self._replaying = True
        try:
            for rec in records[from_seq:]:
                if rec["t"] == REC_SUBMIT:
                    fork = rec.get("fork", 1)
                    # a forked submit owns uid..uid+fork-1: it runs again
                    # unless every member was delivered
                    if all(rec["uid"] + i in self._journal_acked
                           for i in range(fork)):
                        continue
                    self.submit(np.asarray(rec["prompt"], np.int32),
                                rec["max_new_tokens"],
                                arrival=rec["arrival"],
                                speculate_k=rec["speculate_k"],
                                priority=rec["priority"],
                                deadline_s=rec["deadline_s"],
                                uid=rec["uid"], fork=fork)
                elif rec["t"] == REC_CANCEL:
                    if rec["uid"] in self._journal_acked:
                        continue        # resolved before the crash
                    self.cancel(rec["uid"])
        finally:
            self._replaying = False

    def recover_in_place(self) -> None:
        """Restore the newest checkpoint (if any) and replay the journal
        past it: the engine is then where the dead incarnation was at its
        last boundary, and running it yields every outstanding ack
        (greedy: bit for bit), none lost or repeated."""
        from_seq = 0
        if self._ckpt_mgr is not None and self._ckpt_mgr.has_checkpoint():
            from_seq = self.restore_checkpoint()
        if self.journal is not None:
            self._replay_journal(from_seq)

    @classmethod
    def recover(cls, params: Any, cfg: ModelConfig, *,
                journal: Optional[Any] = None,
                checkpoint_dir: Optional[str] = None,
                **kwargs) -> "DecodeEngine":
        """Build an engine and bring it to the journal and checkpoint's
        state: the restart after a crash. Pass the engine arguments the
        dead incarnation had (the checkpoint's tree follows them)."""
        eng = cls(params, cfg, journal=journal,
                  checkpoint_dir=checkpoint_dir, **kwargs)
        eng.recover_in_place()
        return eng

    # ------------------------------------------------------------------
    # speculative rounds
    # ------------------------------------------------------------------

    def step_spec_round(self) -> None:
        """One draft/verify round, batched over every speculative slot.

        1. The draft proposes w = max K tokens per speculative slot.
        2. ONE masked ``decode_window_varlen`` runs the (w+1)-token
           windows [input, d₁..d_w] at each slot's own position (lens =
           w+1 on speculative rows, 0 elsewhere) and the target's greedy
           token after each window prefix comes to the host, (S, w+1)
           ints only.
        3. Per slot the longest draft prefix matching those tokens is
           accepted and the target's own next token appended: 1 to K+1
           tokens of the plain greedy sequence, under the segment's
           stop rules (budget, EOS inclusive).
        4. Full acceptors keep the verify's state; partial acceptors get
           their round-start copy back and ONE more masked
           ``decode_window_varlen`` re-advances each by its accepted
           count (``spec_rewind_dispatches`` equals
           ``spec_rewind_rounds``).
        """
        be, dev = self.backend, self.device
        spec = self._active & (self._spec_k > 0)
        slots = [int(s) for s in np.nonzero(spec)[0]]
        if not slots:
            raise RuntimeError("step_spec_round with no speculative slot")
        w = int(self._spec_k[slots].max())

        drafts = np.asarray(
            self.draft.propose(self._tok, self._pos, spec, w), np.int64)
        window = np.zeros((self.n_slots, w + 1), np.int64)
        window[:, 0] = self._tok
        window[:, 1:] = drafts
        pos_pre = self._pos.copy()
        # the verify advances the state in place: keep each speculative
        # slot's fixed-size state (no KV rows) for a rewind
        pre = {s: be.snapshot_state_rows(self.state, s, 0) for s in slots}
        logits, _ = be.decode_window_varlen(
            self.params, self.state, torch.from_numpy(window).to(dev),
            torch.from_numpy(pos_pre).to(dev),
            torch.from_numpy(np.where(spec, w + 1, 0).astype(np.int32)
                             ).to(dev))
        greedy = logits.argmax(-1).cpu().numpy()         # (S, w+1)
        # chaos hook: a sabotaged round accepts no draft token, so every
        # continuing slot rewinds; the emitted token is still the
        # target's own next token, so the output does not move
        sabotaged = (self.injector is not None
                     and self.injector.sabotages_round(
                         self.stats.spec_rounds))
        self.stats.spec_rounds += 1

        rewinds = []                   # (slot, tokens consumed)
        max_emitted = 1
        for slot in slots:
            ks = int(self._spec_k[slot])
            g = greedy[slot]
            a = 0
            while not sabotaged and a < ks and drafts[slot, a] == g[a]:
                a += 1
            self.stats.spec_drafted += ks
            self.stats.spec_accepted += a
            # emit g[0..a] one at a time under the segment's stop rules
            emitted = []
            finished = False
            for t in g[:a + 1]:
                emitted.append(int(t))
                self._remaining[slot] -= 1
                if ((self.eos_id is not None and int(t) == self.eos_id)
                        or self._remaining[slot] <= 0):
                    finished = True
                    break
            self._slot_toks[slot].extend(emitted)
            self.stats.spec_emitted += len(emitted)
            max_emitted = max(max_emitted, len(emitted))
            if finished:
                self._free_slot(slot)
                continue
            # the slot consumed window[:a+1]; its next input is the last
            # emitted token, the target's own
            n_cons = a + 1
            self.draft.commit(slot, np.asarray(emitted, np.int32))
            self._tok[slot] = emitted[-1]
            if a < w:
                rewinds.append((slot, n_cons))
            self._pos[slot] += n_cons

        if rewinds:
            wr = max(n for _, n in rewinds)
            tokens = np.zeros((self.n_slots, wr), np.int64)
            lens = np.zeros((self.n_slots,), np.int32)
            for slot, n_cons in rewinds:
                be.restore_state_rows(self.state, pre[slot], slot)
                tokens[slot, :n_cons] = window[slot, :n_cons]
                lens[slot] = n_cons
            self._miss("window_varlen", wr)
            be.decode_window_varlen(
                self.params, self.state, torch.from_numpy(tokens).to(dev),
                torch.from_numpy(pos_pre).to(dev),
                torch.from_numpy(lens).to(dev), last_only=True)
            self.stats.spec_rewinds += len(rewinds)
            self.stats.spec_rewind_rounds += 1
            self.stats.spec_rewind_dispatches += 1

        self._clock += max_emitted

    # ------------------------------------------------------------------
    # driving
    # ------------------------------------------------------------------

    def step(self, policy: str = "continuous") -> bool:
        """One scheduling iteration: the lifecycle pass (cancels,
        deadlines, degradation), the admission pass (preempt, resume,
        admit), one continuation chunk (if a slot is mid-prompt), one
        segment over the plain slots and one round over the speculative
        ones, each followed by the boundary's probe. Returns whether
        work remains; False at once when idle."""
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got "
                             f"{policy!r}")
        if not self.has_work():
            return False
        self._lifecycle_pass()
        self._admit_pass(policy)
        if self._any_ingesting():
            self._ingest_step()
        if not self._active.any():
            if self._any_ingesting():
                return self.has_work()
            if self._quarantined.all() and (self._queue or self._suspended):
                self._fail_all_pending()
                return self.has_work()
            if self._work_waiting():
                # work waits but nothing was admitted (a dropped wave, or
                # every free slot quarantined): stall a segment
                self._clock += self.segment_len
                return self.has_work()
            if self._queue:
                # the queue head is in the future: move the clock to it,
                # in whole segments
                ahead = self._queue[0].arrival - self._clock
                skip = max(1, -int(-ahead // self.segment_len))
                self._clock += skip * self.segment_len
            return self.has_work()
        if (self._active & (self._spec_k == 0)).any():
            self.step_segment()
            self._post_event()
        if (self._active & (self._spec_k > 0)).any():
            self.step_spec_round()
            self._post_event()
        return self.has_work()

    def run(self, policy: str = "continuous") -> List[Completion]:
        """Drive every request to completion; completions in uid order."""
        while self.step(policy):
            pass
        return self.completions()

    # ------------------------------------------------------------------
    # prefix-cache persistence
    # ------------------------------------------------------------------

    def cache_template(self, n_tokens: int):
        """The tree of an ``n_tokens``-row slot snapshot, as views of the
        engine's state (nothing copied): the ``template_fn`` a
        :class:`~repro_torch.serving.prefix_cache.PrefixCache` loads
        arrays onto (the device and dtype of each leaf)."""
        w = max(1, min(int(n_tokens), self.max_len))
        return self.backend.state_rows_view(self.state, 0, w)

    def _cache_manager(self, directory) -> CheckpointManager:
        if self.cache is None:
            raise ValueError("engine has no prefix cache configured")
        return (directory if isinstance(directory, CheckpointManager)
                else CheckpointManager(directory, keep=1))

    def save_cache(self, directory, step: Optional[int] = None) -> int:
        """Persist the prefix cache through the atomic checkpoint writer
        into ``directory`` (a path or a CheckpointManager; not the
        directory of engine checkpoints), in JAX's format. Returns the
        step written."""
        mgr = self._cache_manager(directory)
        step = self._events if step is None else int(step)
        self.cache.save(mgr, step)
        return step

    def load_cache(self, directory) -> bool:
        """Restore a prefix cache saved by :meth:`save_cache` (by either
        package). A missing or corrupt file leaves the cache empty and
        returns False: a cold start, never wrong answers."""
        return self.cache.load(self._cache_manager(directory),
                               self.cache_template)
