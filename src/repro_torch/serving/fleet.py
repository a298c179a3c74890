"""A fleet of decode engines: one admission queue, N backend slot groups,
each of R replicas with failover (port of ``repro/serving/fleet.py``).

The :class:`~repro_torch.serving.backends.DecodeBackend` seam makes the
engine a scheduler, so one fleet serves requests against several model
families at once: ``submit(backend=...)`` routes each request to the
slot group holding that family's parameters and config, and the fleet
steps the groups round-robin, so a segment of one family never starves
another. For the paper's fixed-size families a group's admission,
preemption and retry move O(k²) bytes a request, the softmax group's
O(max_len·k).

* Each group is a whole :class:`~repro_torch.serving.engine.DecodeEngine`
  (its own slots, clock and lifecycle), so a request's tokens are by
  construction those of its group run alone with the same submissions.
  The fleet adds routing, fleet-wide uids and a fleet-level bounded
  queue: ``max_queue`` bounds the requests queued over every group, and
  ``shed_policy="evict_lowest"`` may shed a victim in another group
  than the arrival's (``DecodeEngine.shed_queued``).
* Lifecycle controls (cancel, priorities, deadlines, preemption, the
  NaN quarantine) live in the groups; ``cancel`` routes by uid.

Replica failover: ``replicas=N`` runs N identical engines per group
behind the queue, each with its own write-ahead journal (in memory, or
files under ``journal_dir``), submissions round-robin over the healthy
replicas.

* An :class:`~repro_torch.serving.lifecycle.InjectedCrash` out of a
  replica's ``step`` counts a failure; at ``breaker_threshold`` failures
  the circuit breaker opens: the replica is no longer routed to or
  stepped.
* A replica that has not finished a step for ``heartbeat_misses`` fleet
  steps is declared dead and its work failed over: every completion
  acked in its journal is adopted as it is, and every unacked submit is
  re-admitted to a healthy replica of its group under a fresh uid,
  aliased back to the original. Callers see one completion per original
  uid, under greedy decoding the tokens of a run where no replica died:
  the re-admission costs a prompt's prefill into an O(k²) state, with no
  KV cache to rebuild. Deadlines do not survive failover: they are
  stamps on the dead replica's clock.
* ``save_checkpoint`` checkpoints every healthy replica's engine and
  the fleet's routing tables (``fleet.json``); ``recover`` restarts
  from them and the journals.

``stats()`` has JAX's keys but ``compiled_segment_programs``, and the
fleet has no ``compiled_segment_programs()``: JAX counts the jit cache's
segment programs per group, and the port compiles no program (a segment
runs eagerly through the same kernels whatever the group has served).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.serving.engine import Completion, DecodeEngine
from repro_torch.serving.journal import Journal, completion_from_ack
from repro_torch.serving.lifecycle import SHED_POLICIES, InjectedCrash


def fleet_demo_config(name: str):
    """A smoke-scale config of each family a fleet serves, sharing the
    vocabulary (256) and d_model, so one workload feeds a mixed fleet:
    linear | gated_linear | softmax (yi-34b's smoke config under that
    attention), mamba2 (a pure-Mamba cut of zamba2-7b's smoke config),
    rwkv6 (rwkv6-1.6b's smoke config); fp32. The attention groups have
    head dim 8, which the CUDA kernels do not take (their ``HEAD_DIMS``):
    on a card they raise ValueError, as any D = 8 call does."""
    from repro_torch.configs import get_smoke_config
    if name in ("linear", "gated_linear", "softmax"):
        cfg = get_smoke_config("yi-34b").with_backend(name)
    elif name == "mamba2":
        cfg = dataclasses.replace(
            get_smoke_config("zamba2-7b"), name="mamba2-fleet-smoke",
            layer_pattern=("mamba",), n_repeats=2, tail=(), n_layers=2)
    elif name == "rwkv6":
        cfg = get_smoke_config("rwkv6-1.6b")
    else:
        raise KeyError(
            f"unknown fleet demo backend {name!r}; known: linear, "
            f"gated_linear, softmax, mamba2, rwkv6")
    return dataclasses.replace(cfg, dtype="float32")


@dataclasses.dataclass
class ReplicaState:
    """One replica's supervision record: its engine and the breaker and
    heartbeat bookkeeping that routing and failover read."""
    engine: DecodeEngine
    name: str                 # backend group
    idx: int                  # replica index within the group
    failures: int = 0         # crashes observed from step()
    open: bool = False        # circuit breaker tripped: no routing/steps
    dead: bool = False        # heartbeat declared it dead; failed over
    last_beat: int = 0        # fleet step of its last completed step


class FleetEngine:
    """N backend slot groups behind one submit/run API.

    ``groups`` maps a group name to ``(params, cfg)``; every group gets
    its own :class:`DecodeEngine` built with the shared engine arguments
    (``n_slots`` per group, ``segment_len``, ``max_len``, ...), its
    backend resolved from its config, its device its parameters'.
    ``per_group`` gives per-group engine arguments (a draft provider for
    one group, say).

    Durability: ``replicas`` engines per group, round-robin routing and
    journal-based failover (module docstring); ``replica_injectors``
    maps ``(group, replica_idx)`` to a FaultInjector (crash one replica,
    not all); ``journal_dir`` / ``checkpoint_dir`` put the per-replica
    journals and engine checkpoints in files
    (``<dir>/<group>.r<idx>...``), which :meth:`recover` restarts from;
    ``breaker_threshold`` crashes open a replica's breaker and
    ``heartbeat_misses`` silent fleet steps declare it dead.
    """

    def __init__(
        self,
        groups: Dict[str, Tuple],
        *,
        max_queue: Optional[int] = None,
        shed_policy: str = "reject_new",
        per_group: Optional[Dict[str, Dict[str, Any]]] = None,
        replicas: int = 1,
        replica_injectors: Optional[Dict[Tuple[str, int], Any]] = None,
        journal_dir: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        breaker_threshold: int = 1,
        heartbeat_misses: int = 2,
        **engine_kwargs,
    ):
        if not groups:
            raise ValueError("FleetEngine needs at least one backend group")
        if shed_policy not in SHED_POLICIES:
            raise ValueError(f"shed_policy must be one of {SHED_POLICIES}, "
                             f"got {shed_policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        if replicas < 1 or breaker_threshold < 1 or heartbeat_misses < 1:
            raise ValueError("replicas, breaker_threshold and "
                             "heartbeat_misses must be >= 1")
        self.max_queue = max_queue
        self.shed_policy = shed_policy
        self.n_replicas = replicas
        self.breaker_threshold = breaker_threshold
        self.heartbeat_misses = heartbeat_misses
        self.journal_dir = journal_dir
        self.checkpoint_dir = checkpoint_dir
        self._replicas: Dict[str, List[ReplicaState]] = {}
        for name, (params, cfg) in groups.items():
            reps = []
            for r in range(replicas):
                kw = dict(engine_kwargs)
                kw.update((per_group or {}).get(name, {}))
                inj = (replica_injectors or {}).get((name, r))
                if inj is not None:
                    kw["injector"] = inj
                if "journal" not in kw:
                    kw["journal"] = (
                        os.path.join(journal_dir, f"{name}.r{r}.journal")
                        if journal_dir is not None else Journal())
                if checkpoint_dir is not None and "checkpoint_dir" not in kw:
                    kw["checkpoint_dir"] = os.path.join(
                        checkpoint_dir, f"{name}.r{r}")
                # groups keep unbounded queues; the fleet bounds the total
                reps.append(ReplicaState(
                    engine=DecodeEngine(params, cfg, **kw), name=name,
                    idx=r))
            self._replicas[name] = reps
        # each group's primary (replica-0) engine
        self.groups: Dict[str, DecodeEngine] = {
            name: reps[0].engine for name, reps in self._replicas.items()}
        self.default_backend = next(iter(self.groups))
        self.reset()

    # ------------------------------------------------------------------

    def reset(self) -> None:
        """Clear every group's requests, slots and stats. The replicas'
        supervision state (breakers, heartbeats, aliases) resets too;
        in-memory journals start afresh (file-backed ones are durable
        logs and stay as they are)."""
        for reps in self._replicas.values():
            for rs in reps:
                rs.engine.reset()
                rs.failures = 0
                rs.open = False
                rs.dead = False
                rs.last_beat = 0
                if rs.engine.journal is not None \
                        and rs.engine.journal.path is None:
                    rs.engine.journal = Journal()
        self._route: Dict[int, str] = {}        # uid → group name
        self._replica_route: Dict[int, int] = {}  # uid → replica idx
        self._alias: Dict[int, int] = {}        # re-admitted uid → orig
        self._realias: Dict[int, int] = {}      # orig uid → re-admitted
        self._dead_acks: Dict[int, Completion] = {}  # adopted journal acks
        self._rr: Dict[str, int] = {n: 0 for n in self._replicas}
        self._beat = 0
        self._next_uid = 0
        self.fleet_shed = 0      # sheds forced by the fleet's queue bound
        self.failovers = 0       # replicas declared dead and failed over
        self.readmitted = 0      # stranded requests re-admitted
        self.unrecovered: List[int] = []  # stranded with no healthy home

    # -- replica supervision -------------------------------------------

    def _healthy(self, name: str) -> List[ReplicaState]:
        return [rs for rs in self._replicas[name]
                if not rs.open and not rs.dead]

    def _alive(self) -> List[ReplicaState]:
        return [rs for reps in self._replicas.values() for rs in reps
                if not rs.open and not rs.dead]

    def _pick_replica(self, name: str) -> ReplicaState:
        """Round-robin over the group's healthy replicas (an open
        breaker takes a replica out of the rotation)."""
        healthy = self._healthy(name)
        if not healthy:
            raise RuntimeError(
                f"no healthy replica in group {name!r} "
                f"({len(self._replicas[name])} configured)")
        rs = healthy[self._rr[name] % len(healthy)]
        self._rr[name] += 1
        return rs

    def _heartbeat_pass(self) -> None:
        """A replica silent for ``heartbeat_misses`` fleet steps (its
        breaker open, or its steps failing) is dead: adopt its journal's
        acks and re-admit its unacked submits elsewhere."""
        for reps in self._replicas.values():
            for rs in reps:
                if (not rs.dead
                        and self._beat - rs.last_beat
                        >= self.heartbeat_misses):
                    self._failover(rs)

    def _failover(self, rs: ReplicaState) -> None:
        rs.dead = True
        rs.open = True
        self.failovers += 1
        jr = rs.engine.journal
        if jr is None:
            return
        # delivered is delivered: journaled acks are served as they are,
        # never run again (exactly once across a replica's death)
        for uid, rec in jr.acked().items():
            self._dead_acks[uid] = completion_from_ack(rec)
        for rec in jr.unacked_submits():
            orig = rec["uid"]
            fork = rec.get("fork", 1)
            try:
                target = self._pick_replica(rs.name)
            except RuntimeError:
                self.unrecovered.append(orig)
                continue
            new_uid = self._next_uid
            self._next_uid = new_uid + fork
            target.engine.submit(
                np.asarray(rec["prompt"], np.int32),
                rec["max_new_tokens"], arrival=0.0,
                speculate_k=rec["speculate_k"],
                priority=rec["priority"], deadline_s=None, uid=new_uid,
                fork=fork)
            for i in range(fork):
                self._route[new_uid + i] = rs.name
                self._replica_route[new_uid + i] = target.idx
                self._alias[new_uid + i] = orig + i
                self._realias[orig + i] = new_uid + i
            self.readmitted += 1

    def backend_of(self, uid: int) -> Optional[str]:
        return self._route.get(uid)

    def _queued_total(self) -> int:
        return sum(rs.engine.queue_depth() for rs in self._alive())

    def _pick_queued_victim(self) -> Optional[Tuple[ReplicaState, Any]]:
        """The lowest-priority (then newest) queued request over every
        group: the fleet-wide form of the engine's evict_lowest."""
        best = None
        for rs in self._alive():
            for r in rs.engine._queue:
                key = (r.priority, -r.arrival, -r.uid)
                if best is None or key < best[0]:
                    best = (key, rs, r)
        return (best[1], best[2]) if best is not None else None

    def _record_route(self, uid: int, fork: int, backend: str,
                      target: ReplicaState) -> None:
        self._next_uid = uid + fork
        for u in range(uid, uid + fork):
            self._route[u] = backend
            self._replica_route[u] = target.idx

    def submit(self, prompt, max_new_tokens: int, *,
               backend: Optional[str] = None, arrival: float = 0.0,
               speculate_k: int = 0, priority: int = 0,
               deadline_s: Optional[float] = None,
               fork: int = 1) -> int:
        """Queue a request against one backend group (the first group by
        default). Returns a fleet-wide uid; ``fork=N`` owns uids
        uid..uid+N-1, all on one replica (the members share one
        prefill). The fleet's bounded queue resolves sheds over every
        group."""
        if backend is None:
            backend = self.default_backend
        if backend not in self.groups:
            raise KeyError(
                f"unknown backend {backend!r}; fleet serves "
                f"{list(self.groups)}")
        if fork < 1:
            raise ValueError(f"fork must be >= 1, got {fork}")
        target = self._pick_replica(backend)
        eng = target.engine
        uid = self._next_uid
        if (self.max_queue is not None
                and self._queued_total() >= self.max_queue):
            shed_arrival = True
            if self.shed_policy == "evict_lowest":
                victim = self._pick_queued_victim()
                if victim is not None and victim[1].priority < priority:
                    victim[0].engine.shed_queued(victim[1].uid)
                    self.fleet_shed += 1
                    shed_arrival = False
            if shed_arrival:
                # the engine validates (nothing changes if it raises),
                # then the arrival is shed at once: its completion lands
                # in its group with status="shed", fork members with it
                eng.submit(np.asarray(prompt), max_new_tokens,
                           arrival=arrival, speculate_k=speculate_k,
                           priority=priority, deadline_s=deadline_s,
                           uid=uid, fork=fork)
                if not eng.shed_queued(uid):
                    raise RuntimeError(f"uid {uid} was not queued")
                self.fleet_shed += 1
                self._record_route(uid, fork, backend, target)
                return uid
        eng.submit(np.asarray(prompt), max_new_tokens, arrival=arrival,
                   speculate_k=speculate_k, priority=priority,
                   deadline_s=deadline_s, uid=uid, fork=fork)
        self._record_route(uid, fork, backend, target)
        return uid

    def cancel(self, uid: int) -> bool:
        name = self._route.get(uid)
        if name is None:
            return False
        # a failed-over request lives under its re-admitted alias
        live = self._realias.get(uid, uid)
        idx = self._replica_route.get(live, 0)
        return self._replicas[name][idx].engine.cancel(live)

    # ------------------------------------------------------------------

    def has_work(self) -> bool:
        # a breaker-open replica not yet declared dead awaits failover:
        # its stranded work still counts
        pending_failover = any(
            rs.open and not rs.dead
            for reps in self._replicas.values() for rs in reps)
        return pending_failover or any(
            rs.engine.has_work() for rs in self._alive())

    def step(self, policy: str = "continuous") -> bool:
        """One scheduling iteration of every healthy replica of every
        group, round-robin. A replica whose step crashes counts a breaker
        failure (at ``breaker_threshold`` its breaker opens); the
        heartbeat pass after it declares silent replicas dead and fails
        their work over."""
        self._beat += 1
        for reps in self._replicas.values():
            for rs in reps:
                if rs.open or rs.dead:
                    continue
                try:
                    rs.engine.step(policy)
                    rs.last_beat = self._beat
                except InjectedCrash:
                    rs.failures += 1
                    if rs.failures >= self.breaker_threshold:
                        rs.open = True
        self._heartbeat_pass()
        return self.has_work()

    def run(self, policy: str = "continuous") -> List[Completion]:
        """Drive every group's requests to completion; every completion
        (fleet-shed ones included) in uid order."""
        while self.step(policy):
            pass
        return self.completions()

    def completions(self) -> List[Completion]:
        """One completion per original uid: live replicas' results, the
        acks adopted from dead replicas' journals, and failed-over work
        keyed back from its re-admission alias to the caller's uid."""
        merged: Dict[int, Completion] = {}
        for reps in self._replicas.values():
            for rs in reps:
                if rs.dead:
                    continue        # its journal's acks are in _dead_acks
                merged.update(rs.engine._completions)
        merged.update(self._dead_acks)
        for new_uid, orig in self._alias.items():
            c = merged.pop(new_uid, None)
            if c is not None and orig not in self._dead_acks:
                merged[orig] = dataclasses.replace(c, uid=orig)
        return [merged[u] for u in sorted(merged)]

    def stats(self) -> Dict[str, Any]:
        """Per-group stats and the fleet's counters, JSON-able."""
        return {
            "fleet_shed": self.fleet_shed,
            "failovers": self.failovers,
            "readmitted": self.readmitted,
            "unrecovered": list(self.unrecovered),
            "groups": {
                name: {
                    "backend": eng.backend.name,
                    "fixed_size_state": eng.backend.fixed_size_state,
                    "state_bytes_per_slot":
                        eng.backend.state_bytes_per_slot(eng.max_len),
                    "stats": eng.stats.to_dict(),
                    "prefix_cache": (
                        None if eng.cache is None else {
                            "kind": eng.cache.name,
                            **eng.cache.counters()}),
                }
                for name, eng in self.groups.items()
            },
            "replicas": {
                name: [
                    {"idx": rs.idx, "open": rs.open, "dead": rs.dead,
                     "failures": rs.failures,
                     "journal_seq": (rs.engine.journal.seq
                                     if rs.engine.journal else 0)}
                    for rs in reps]
                for name, reps in self._replicas.items()
            },
        }

    # ------------------------------------------------------------------
    # fleet durability: checkpoint and recover
    # ------------------------------------------------------------------

    def _fleet_meta_path(self) -> str:
        return os.path.join(self.checkpoint_dir, "fleet.json")

    def save_checkpoint(self) -> None:
        """Checkpoint every healthy replica's engine (each under
        ``<checkpoint_dir>/<group>.r<idx>``) and the fleet's routing and
        alias tables (``fleet.json``, written atomically), in JAX's
        format. Needs ``checkpoint_dir``."""
        if self.checkpoint_dir is None:
            raise ValueError("fleet has no checkpoint_dir configured")
        for rs in self._alive():
            rs.engine.save_checkpoint()
        meta = {
            "next_uid": self._next_uid,
            "route": {str(u): n for u, n in self._route.items()},
            "replica_route": {str(u): i
                              for u, i in self._replica_route.items()},
            "alias": {str(u): o for u, o in self._alias.items()},
            "realias": {str(u): o for u, o in self._realias.items()},
            "rr": dict(self._rr),
            "beat": self._beat,
            "fleet_shed": self.fleet_shed,
            "failovers": self.failovers,
            "readmitted": self.readmitted,
            "unrecovered": list(self.unrecovered),
            "replica_flags": {
                name: [{"open": rs.open, "dead": rs.dead,
                        "failures": rs.failures,
                        "last_beat": rs.last_beat} for rs in reps]
                for name, reps in self._replicas.items()},
        }
        tmp = self._fleet_meta_path() + ".tmp"
        with open(tmp, "w") as f:
            json.dump(meta, f)
        os.replace(tmp, self._fleet_meta_path())

    def recover_in_place(self) -> None:
        """Restore every healthy replica's engine from its checkpoint and
        journal, and the fleet's tables from ``fleet.json``: the restart
        after the whole process died."""
        if self.checkpoint_dir is not None \
                and os.path.exists(self._fleet_meta_path()):
            with open(self._fleet_meta_path()) as f:
                meta = json.load(f)
            self._next_uid = meta["next_uid"]
            self._route = {int(u): n for u, n in meta["route"].items()}
            self._replica_route = {
                int(u): i for u, i in meta["replica_route"].items()}
            self._alias = {int(u): o for u, o in meta["alias"].items()}
            self._realias = {int(u): o
                             for u, o in meta["realias"].items()}
            self._rr = dict(meta["rr"])
            self._beat = meta["beat"]
            self.fleet_shed = meta["fleet_shed"]
            self.failovers = meta["failovers"]
            self.readmitted = meta["readmitted"]
            self.unrecovered = list(meta["unrecovered"])
            for name, flags in meta["replica_flags"].items():
                for rs, fl in zip(self._replicas[name], flags):
                    rs.open = fl["open"]
                    rs.dead = fl["dead"]
                    rs.failures = fl["failures"]
                    rs.last_beat = fl["last_beat"]
        for rs in self._alive():
            rs.engine.recover_in_place()
        for reps in self._replicas.values():
            for rs in reps:
                if rs.dead and rs.engine.journal is not None:
                    for uid, rec in rs.engine.journal.acked().items():
                        self._dead_acks[uid] = completion_from_ack(rec)

    @classmethod
    def recover(cls, groups: Dict[str, Tuple], **kwargs) -> "FleetEngine":
        """Build a fleet and bring it to its journals' and checkpoints'
        state. Pass the arguments (``journal_dir`` and ``checkpoint_dir``
        among them) the dead incarnation had."""
        fleet = cls(groups, **kwargs)
        fleet.recover_in_place()
        return fleet
