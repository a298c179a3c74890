"""Request lifecycle and fault-tolerance primitives of the serving engines
(port of ``repro/serving/lifecycle.py``).

The paper's fixed-size O(k²) representation makes a serving request
portable: the whole attended context of a generation in progress is one
k×k state per layer, so suspending, checkpointing or retrying a request
is a snapshot copy, where a softmax KV cache moves its history. This
module holds the host-side descriptors that ride on that:

* :class:`SuspendedRequest`: a request swapped out of its slot mid-
  generation, its batch-1 state snapshot and the scalar decode
  bookkeeping (next input token, position, remaining budget, tokens
  emitted so far). Re-admission is one copy back into a slot; greedy
  continuation is bit for bit that of never having been suspended,
  since a greedy step depends only on (state, tok, pos).
* :class:`Checkpoint`: the same payload taken at a known-good segment
  boundary, kept per slot, so a numeric fault found later retries the
  request from its last finite state.
* :class:`FaultInjector`: deterministic chaos hooks the engine consults
  at its scheduling boundaries, keyed on its event counters: NaN-poison
  a slot after an event, drop an admission pass, sabotage a speculative
  round (every draft rejected, every slot rewinds), stretch the logical
  clock after an event, or crash the engine at an event.

``InjectedCrash`` is raised by the engine when the injector schedules a
crash; ``serve --mode stream`` catches it (exit code 3, the journal and
checkpoints left for ``--recover``) and ``FleetEngine.step`` counts it as
a replica's breaker failure.

Request lifecycle::

    queued ── admit ──> active ── finish ──────────> completed (ok)
      │                │  ▲                             ▲
      │ deadline/shed/ │  └── resume ── suspended <── preempt
      │ cancel         │                   │
      ▼                ├── deadline/cancel ┴──> completed (deadline/
    completed          │                         cancelled)
    (shed/deadline/    └── NaN detected ──> quarantined slot
     cancelled)              │ retry from the last good checkpoint
                             ├────────────> suspended (re-queued)
                             └ retries exhausted ─> completed (failed)
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import torch

# Completion.status (and LookupResult.status) values
STATUS_OK = "ok"                # ran to EOS / budget (answered)
STATUS_CANCELLED = "cancelled"  # cancel(uid) before completion
STATUS_DEADLINE = "deadline"    # deadline_s passed (queued or active)
STATUS_SHED = "shed"            # bounded queue rejected it (overload)
STATUS_FAILED = "failed"        # numeric fault, retries exhausted

SHED_POLICIES = ("reject_new", "evict_lowest")


class InjectedCrash(RuntimeError):
    """Raised by the engine at an event boundary where the injector
    schedules a crash; ``event_idx`` names the kill point. Whatever the
    engine had not journaled or checkpointed is lost."""

    def __init__(self, event_idx: int):
        super().__init__(f"injected crash at event {event_idx}")
        self.event_idx = event_idx


@dataclasses.dataclass
class SuspendedRequest:
    """A request swapped out of its slot mid-generation. ``state`` is
    the slot's batch-1 whole-stack snapshot (row-ranged for a softmax KV
    cache); the scalars are the per-slot values the engine carries."""
    req: Any                    # the original Request
    state: Any                  # batch-1 device snapshot
    tok: int                    # next input token
    pos: int                    # its position
    remaining: int              # budget left (the next token's included)
    toks: List[int]             # tokens emitted so far
    admitted_step: int          # original admission clock
    retries: int = 0            # numeric-fault retries consumed


@dataclasses.dataclass
class Checkpoint:
    """Last known-good per-slot restore point (a SuspendedRequest's
    payload without the request)."""
    state: Any
    tok: int
    pos: int
    remaining: int
    toks: List[int]


def poison_snapshot(snapshot: Any) -> Any:
    """A copy of a batch-1 state snapshot with every float leaf filled
    with NaN (other leaves as they are): restored into one slot, the
    fault model of a corrupted in-flight state."""
    def bad(x):
        if x is None or not x.is_floating_point():
            return x
        return torch.full_like(x, float("nan"))
    return {part: tuple(type(st)(*(bad(x) for x in st)) for st in group)
            for part, group in snapshot.items()}


@dataclasses.dataclass
class FaultInjector:
    """Deterministic chaos hooks, keyed on the engine's event counter
    (one event per decode segment or speculative round; admission passes
    count apart), so two runs with one injector see the same faults.

    ``nan``: (event, slot) pairs, the slot's state NaN-poisoned after
    that event. ``drop_admission``: admission-pass indices skipped whole.
    ``spec_mismatch``: speculative-round indices whose drafts are all
    rejected. ``delay``: event → extra logical steps on the clock after
    it. ``crash``: events at which the engine raises
    :class:`InjectedCrash` before any other boundary work."""
    nan: Tuple[Tuple[int, int], ...] = ()
    drop_admission: Tuple[int, ...] = ()
    spec_mismatch: Tuple[int, ...] = ()
    delay: Optional[Dict[int, int]] = None
    crash: Tuple[int, ...] = ()

    def nan_slots(self, event_idx: int) -> List[int]:
        return [s for e, s in self.nan if e == event_idx]

    def drops_admission(self, pass_idx: int) -> bool:
        return pass_idx in self.drop_admission

    def sabotages_round(self, round_idx: int) -> bool:
        return round_idx in self.spec_mismatch

    def extra_delay(self, event_idx: int) -> int:
        return (self.delay or {}).get(event_idx, 0)

    def crashes(self, event_idx: int) -> bool:
        return event_idx in self.crash
