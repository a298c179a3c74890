"""Fixed-slot continuous-batching decode engine (port of the core of
``repro/serving/engine.py``).

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
  admits queued requests into the freed ones. ``admission="batched"``
  admits every admissible request at once: prompts are END-padded to a
  power-of-two bucket width and encoded by one ``lm.prefill_varlen``
  pass whose per-row masking makes each row's state that of the row
  alone; the wave's rows are copied into their slots and no other row
  is touched. A wave of one is encoded at batch 1 and written into its
  slot; a length-1 prompt is encoded unpadded at batch 1 (JAX's carve-
  out). Prompts longer than ``prefill_chunk`` are ingested chunk by
  chunk through ``lm.decode_window_varlen`` (``ingest="recurrent"``,
  B1/B7 with per-row ``lens`` up to the chunk width) or
  ``lm.ingest_window_varlen`` (``"parallel"``, the plain chunked forms),
  one chunk per scheduling step before the segment, so a long prompt
  never stalls the live slots. ``admission="per_request"`` prefills
  each request alone and writes it into its slot.

* **Isolation.** Inactive slots keep their state bit for bit, so under
  greedy decoding each request's tokens are those it would produce
  running alone.

* **Softmax.** Under the KV-cache baseline (``SoftmaxKVBackend``) the
  slots hold ``max_len``-row caches. A wave's varlen prefill runs B10
  (the causal flash-attention kernel) on CUDA tensors, and landing it
  copies its bucket-width rows into the wave's slots and zeros the rest
  of each, as JAX pads; decode writes one gated cache row per slot and
  step, and both ingest settings step single-token decode over a chunk.
  ``submit`` keeps prompt + budget within ``max_len`` + 1, so every
  written row fits the cache.

Time is logical: the clock advances ``segment_len`` decode steps per
segment, and request ``arrival`` times are in decode steps.

Policies: ``continuous`` admits into any freed slot between segments;
``static`` admits only when every slot is free (the batch-synchronous
baseline).

Not ported here (they come with their ROADMAP items): the lifecycle
(priorities, preemption, deadlines, cancellation, bounded queues,
overload degradation, the finite probe and quarantine), speculative
rounds, the journal and engine checkpoints, the prefix cache and fork.
Admission order is JAX's (-priority, arrival, uid) with every priority
0, i.e. (arrival, uid).
"""

from __future__ import annotations

import bisect
import dataclasses
import json
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.serving.backends import DecodeBackend, backend_for_config

PAD_ID = -1  # emitted by masked slots; never a vocabulary id
POLICIES = ("continuous", "static")


def _pow2_ceil(n: int) -> int:
    """Smallest power of two >= n (bucket widths for padded admission)."""
    return 1 << (int(n) - 1).bit_length()


@dataclasses.dataclass
class Request:
    """One generation request; ``arrival`` is in logical decode steps."""
    uid: int
    prompt: np.ndarray            # (P,) int32
    max_new_tokens: int
    arrival: float = 0.0


@dataclasses.dataclass
class Completion:
    uid: int
    prompt_len: int
    tokens: np.ndarray            # generated tokens (incl. EOS if hit)
    finish_reason: str            # "eos" | "length"
    admitted_step: int
    finished_step: int


@dataclasses.dataclass
class EngineStats:
    """The core's counters, under JAX's names."""
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

    def to_dict(self) -> Dict:
        """Counters and derived ratios as one JSON-able dict."""
        d = dataclasses.asdict(self)
        for name in ("slot_utilization", "mean_admission_batch",
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
    bounds prompt + generated tokens per request. ``admission``:
    "batched", "per_request" or "auto" (batched where the layer pattern
    takes varlen prefill). ``prefill_chunk`` (rounded up to a power of
    two) bounds the ingest chunk and the bucket widths. ``ingest``:
    "recurrent" (B1/B7 through ``decode_window_varlen``), "parallel"
    (the plain chunked forms through ``ingest_window_varlen``) or "auto"
    (recurrent). ``temperature`` 0 is greedy; above 0 tokens are drawn
    from a ``torch.Generator`` seeded by ``seed``.
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
        admission: str = "auto",
        prefill_chunk: int = 64,
        ingest: str = "auto",
    ):
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
        self.admission, self.ingest = self.backend.resolve_modes(
            admission, ingest)
        # a power-of-two chunk, so every bucket width is one too
        self.prefill_chunk = min(_pow2_ceil(max(1, prefill_chunk)),
                                 max_len)
        # admission program shapes seen: JAX's host mirror of its jit
        # cache, kept so that the stats compare field for field
        self._seen_shapes: set = set()
        self.reset()

    # ------------------------------------------------------------------
    # requests
    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Clear every request, slot and counter."""
        self.state = self.backend.init_slots(self.n_slots, self.max_len,
                                             device=self.device)
        s = self.n_slots
        self._tok = np.zeros((s,), np.int64)
        self._pos = np.zeros((s,), np.int32)
        self._active = np.zeros((s,), bool)
        self._remaining = np.zeros((s,), np.int32)
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
        self.stats = EngineStats(n_slots=self.n_slots,
                                 segment_len=self.segment_len)

    def submit(self, prompt, max_new_tokens: int, arrival: float = 0.0,
               uid: Optional[int] = None) -> int:
        """Queue a request; returns its uid. ``arrival`` is in logical
        decode steps (0 = at once); ``uid`` must not be below the
        engine's next uid. Every check runs before any engine state
        changes."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if uid is not None and uid < self._next_uid:
            raise ValueError(
                f"uid {uid} is not monotone (engine next uid is "
                f"{self._next_uid})")
        if max_new_tokens < 1:
            raise ValueError(
                f"max_new_tokens must be >= 1, got {max_new_tokens}")
        if len(prompt) == 0:
            raise ValueError("the prompt must hold at least one token")
        if len(prompt) + max_new_tokens > self.max_len + 1:
            raise ValueError(
                f"prompt ({len(prompt)}) + max_new_tokens "
                f"({max_new_tokens}) exceeds engine max_len "
                f"{self.max_len} + 1")
        if uid is None:
            uid = self._next_uid
        self._next_uid = uid + 1
        req = Request(uid=uid, prompt=prompt, max_new_tokens=max_new_tokens,
                      arrival=arrival)
        # an early-arriving request submitted late is not blocked behind
        # a far-future one
        bisect.insort(self._queue, req, key=lambda r: (r.arrival, r.uid))
        return uid

    def has_work(self) -> bool:
        """Anything queued, ingesting or decode-active?"""
        return bool(self._queue or self._active.any()
                    or self._any_ingesting())

    def queue_depth(self) -> int:
        """Requests waiting in the admission queue."""
        return len(self._queue)

    def completions(self) -> List[Completion]:
        """Completions recorded so far, in uid order."""
        return [self._completions[u] for u in sorted(self._completions)]

    # ------------------------------------------------------------------
    # scheduling
    # ------------------------------------------------------------------

    def _complete(self, req: Request, tokens: List[int],
                  admitted_step: int) -> None:
        last = tokens[-1] if tokens else None
        reason = ("eos" if self.eos_id is not None and last == self.eos_id
                  else "length")
        self._completions[req.uid] = Completion(
            uid=req.uid, prompt_len=len(req.prompt),
            tokens=np.asarray(tokens, np.int32), finish_reason=reason,
            admitted_step=admitted_step, finished_step=self._clock)

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

    def _any_ingesting(self) -> bool:
        return any(r is not None for r in self._ingest_req)

    def _slot_free(self, slot: int) -> bool:
        return not self._active[slot] and self._ingest_req[slot] is None

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
            self._complete(req, [tok0], admitted_step=self._clock)
            return
        self.backend.write_slot_state(self.state, st_req, slot)
        self.stats.admission_dispatches += 1
        self._activate_slot(slot, req, tok0)

    def _activate_slot(self, slot: int, req: Request, tok0: int) -> None:
        """Flip a slot whose prompt is encoded to decode-active."""
        self._tok[slot] = tok0
        self._pos[slot] = len(req.prompt)
        self._active[slot] = True
        self._remaining[slot] = req.max_new_tokens - 1
        self._slot_req[slot] = req
        self._slot_toks[slot] = [tok0]
        self._slot_admitted[slot] = self._clock

    def _admit_pass(self, policy: str) -> None:
        if policy == "static" and (self._active.any()
                                   or self._any_ingesting()):
            return             # batch-synchronous: wait for the whole batch
        if self.admission == "per_request":
            for slot in range(self.n_slots):
                # keep feeding the slot while requests complete at
                # admission (a budget of one never occupies it)
                while self._slot_free(slot) and self._admissible():
                    self._admit_one(slot, self._queue.pop(0))
            return
        # batched: fill every free slot, then encode the wave's first
        # chunks in one bucket-padded varlen prefill. Loop, because
        # requests that complete at admission free their slots at the
        # same logical clock.
        while self._admissible():
            newly = []
            for slot in range(self.n_slots):
                if not self._slot_free(slot) or not self._admissible():
                    continue
                self._ingest_req[slot] = self._queue.pop(0)
                self._ingest_cursor[slot] = 0
                newly.append(slot)
            if not newly:
                break
            self._ingest_chunk(newly, first=True)

    def _bucket(self, n: int) -> int:
        return min(_pow2_ceil(max(1, n)), self.max_len)

    def _ingest_chunk(self, slots: List[int], *, first: bool) -> None:
        """Consume the next <= ``prefill_chunk`` prompt tokens of every
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
                self._finish_ingest({slot: int(self._sample(logits)[0])})
            slots = [s for s in slots if s not in ones]
            if not slots:
                return
        counts = {}
        for slot in slots:
            req = self._ingest_req[slot]
            cur = int(self._ingest_cursor[slot])
            counts[slot] = min(len(req.prompt) - cur, self.prefill_chunk)
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
            # its varlen window program
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

        finished = []
        for i, slot in enumerate(slots):
            self._ingest_cursor[slot] += int(lens[slot])
            if self._ingest_cursor[slot] >= len(self._ingest_req[slot].prompt):
                finished.append(i)
        if finished:
            toks0 = self._sample(last[finished])
            self._finish_ingest({slots[i]: int(t)
                                 for i, t in zip(finished, toks0)})

    def _ingest_step(self) -> None:
        """One continuation-chunk pass over every mid-prompt slot, run
        before the segment: long prompts interleave with decode."""
        rows = [s for s in range(self.n_slots)
                if self._ingest_req[s] is not None]
        if rows:
            self._ingest_chunk(rows, first=False)

    def _finish_ingest(self, first_tokens: Dict[int, int]) -> None:
        """Each slot's whole prompt is consumed and its first token
        sampled: activate it, or complete at once on a budget of one or
        an EOS."""
        for slot, tok0 in first_tokens.items():
            req = self._ingest_req[slot]
            self._ingest_req[slot] = None
            self._ingest_cursor[slot] = 0
            if req.max_new_tokens <= 1 or (self.eos_id is not None
                                           and tok0 == self.eos_id):
                self._complete(req, [tok0], admitted_step=self._clock)
                continue
            self._activate_slot(slot, req, tok0)

    def step_segment(self) -> None:
        """One ``segment_len``-step segment over the active slots, then
        drain the finished ones. One host sync: the segment's tokens and
        the carried tok, pos, active and remaining come back as one
        tensor."""
        dev = self.device
        run_active = self._active.copy()
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
        self._tok = host[:, -4].copy()
        self._pos = host[:, -3].astype(np.int32)
        self._active = host[:, -2].astype(bool)
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
                       admitted_step=self._slot_admitted[slot])
        self._slot_req[slot] = None
        self._slot_toks[slot] = []
        self._active[slot] = False

    def step(self, policy: str = "continuous") -> bool:
        """One scheduling iteration: an admission pass, one continuation
        chunk (if a slot is mid-prompt), one segment over the active
        slots. Returns whether work remains; False at once when idle."""
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got "
                             f"{policy!r}")
        if not self.has_work():
            return False
        self._admit_pass(policy)
        if self._any_ingesting():
            self._ingest_step()
        if not self._active.any():
            if not self._any_ingesting() and self._queue:
                # the queue head is in the future: move the clock to it,
                # in whole segments
                ahead = self._queue[0].arrival - self._clock
                skip = max(1, -int(-ahead // self.segment_len))
                self._clock += skip * self.segment_len
            return self.has_work()
        self.step_segment()
        return self.has_work()

    def run(self, policy: str = "continuous") -> List[Completion]:
        """Drive every queued request to completion; completions in uid
        order."""
        while self.step(policy):
            pass
        return self.completions()
