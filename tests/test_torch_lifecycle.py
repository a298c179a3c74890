"""The port's request lifecycle against the JAX package on converted
weights, qwen3-0.6b's smoke config in fp32, for ``linear``,
``gated_linear`` and ``softmax``:

* the port's ``DecodeEngine`` against JAX's under chaos: a NaN poisoned
  into a busy slot (quarantine and one retry from the checkpoint) and
  into both slots (every pending request failed), priorities with
  arrivals (preemption and resume), speculation with sabotaged rounds
  and a NaN, a bounded queue under ``evict_lowest`` with a deadline
  that evicts an active request, degradation and speculation turned
  plain,
  cancels (queued and active), dropped admission waves, a clock delay
  and periodic checkpoints: completions token for token, statuses,
  finish reasons, retries, admitted and finished steps and every
  lifecycle counter equal (one JAX engine per backend serves every
  scenario, its knobs set between resets, as the port's);
* every case of JAX's ``tests/test_lifecycle.py`` within torch
  (parametrised where JAX's are), the run-alone reference a request's
  own prefill and greedy generation.
"""

import copy
import dataclasses
import json

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import FaultInjector as JaxFaultInjector
from repro.serving import NgramDraft as JaxNgramDraft
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm
from repro_torch.serving import (DecodeEngine, EngineStats, FaultInjector,
                                 NgramDraft)
from repro_torch.serving.lifecycle import (SuspendedRequest,
                                           poison_snapshot)

BACKENDS = ["linear", "gated_linear", "softmax"]
KNOBS = dict(injector=None, draft=None, max_queue=None,
             shed_policy="reject_new", degrade_threshold=None,
             max_retries=1, checkpoint_interval=0)
COUNTERS = ("segments", "emitted_tokens", "prefills", "admission_batches",
            "ingest_chunks", "spec_rounds", "spec_drafted", "spec_accepted",
            "spec_emitted", "spec_rewinds", "spec_rewind_rounds",
            "spec_rewind_dispatches", "preemptions", "resumes", "cancelled",
            "deadline_evictions", "shed", "quarantined", "retries", "failed",
            "checkpoints", "finite_checks", "degrade_transitions",
            "spec_disables", "degrade_events", "cache_hits",
            "cache_misses", "cache_evictions", "cached_prefix_tokens",
            "forks")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(backend):
    kw = dict(dtype="float32")
    return (dataclasses.replace(
                jax_smoke_config("qwen3-0.6b").with_backend(backend), **kw),
            dataclasses.replace(
                get_smoke_config("qwen3-0.6b").with_backend(backend), **kw))


def _chaos_workload(vocab):
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, vocab, size=int(n)).astype(np.int32)
               for n in rng.integers(3, 20, size=8)]
    return prompts, [10, 12, 9, 11, 8, 10, 6, 14]


# -- the chaos scenarios, the same calls on either package's engine --------
# each: (knobs, submit kwargs per request index, drive before run)

def _cancel_drive(eng):
    eng.cancel(5)                      # queued: resolves at once
    eng.step()
    eng.cancel(0)                      # active: evicted at the boundary
    eng.cancel(99)                     # unknown


SCENARIOS = {
    "nan_retry": (lambda pk: dict(injector=pk["F"](nan=((0, 0),))),
                  lambda i: {}, None),
    "nan_all": (lambda pk: dict(injector=pk["F"](nan=((0, 0), (3, 1)))),
                lambda i: {}, None),
    "priority": (lambda pk: {},
                 lambda i: dict(priority=i % 3, arrival=float(2 * i)), None),
    "spec_chaos": (lambda pk: dict(draft=pk["D"](), injector=pk["F"](
                       spec_mismatch=(0, 1, 2), nan=((2, 1),))),
                   lambda i: dict(speculate_k=3, priority=i % 2), None),
    "overload": (lambda pk: dict(max_queue=3, shed_policy="evict_lowest",
                                 degrade_threshold=1.0, draft=pk["D"]()),
                 lambda i: dict(priority=i % 3,
                                deadline_s={1: 8.0, 6: 10.0}.get(i),
                                speculate_k=2 if i % 2 else 0), None),
    "cancel": (lambda pk: {}, lambda i: {}, _cancel_drive),
    "drop_delay": (lambda pk: dict(
                       injector=pk["F"](drop_admission=(0, 2),
                                        delay={1: 5}),
                       checkpoint_interval=2),
                   lambda i: dict(deadline_s=40.0 if i == 3 else None),
                   None),
}


def _run_scenario(eng, pk, name, prompts, gens):
    knobs, sub, drive = SCENARIOS[name]
    for k, v in dict(KNOBS, **knobs(pk)).items():
        setattr(eng, k, v)
    eng.reset()
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.submit(p, g, **sub(i))
    if drive is not None:
        drive(eng)
    return eng.run(), eng.stats.to_dict()


@pytest.fixture(scope="module")
def chaos_runs():
    """Per backend: the port's weights and JAX's runs of every scenario."""
    out = {}
    pk = {"F": JaxFaultInjector, "D": JaxNgramDraft}
    for backend in BACKENDS:
        jcfg, tcfg = _configs(backend)
        pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg)
        prompts, gens = _chaos_workload(jcfg.vocab_size)
        eng = JaxEngine(pj, jcfg, n_slots=2, segment_len=4, max_len=64,
                        prefill_chunk=8)
        runs = {name: _run_scenario(eng, pk, name, prompts, gens)
                for name in SCENARIOS}
        out[backend] = (tcfg, pt, prompts, gens, runs)
    return out


@pytest.mark.parametrize("backend", BACKENDS)
def test_lifecycle_matches_jax_engine(chaos_runs, backend):
    tcfg, pt, prompts, gens, runs = chaos_runs[backend]
    eng = DecodeEngine(pt, tcfg, n_slots=2, segment_len=4, max_len=64,
                       prefill_chunk=8)
    pk = {"F": FaultInjector, "D": NgramDraft}
    for name in SCENARIOS:
        comps, st = _run_scenario(eng, pk, name, prompts, gens)
        j_comps, j_st = runs[name]
        assert len(comps) == len(j_comps) == len(prompts), name
        for a, b in zip(comps, j_comps):
            assert (a.uid, a.status, a.finish_reason, a.retries,
                    a.admitted_step, a.finished_step) == (
                b.uid, b.status, b.finish_reason, b.retries,
                b.admitted_step, b.finished_step), (name, a.uid)
            np.testing.assert_array_equal(a.tokens, b.tokens,
                                          err_msg=f"{name} {a.uid}")
        for k in COUNTERS:
            assert st[k] == j_st[k], (name, k)


def test_chaos_scenarios_reach_every_path(chaos_runs):
    """The scenarios above exercise what they are named for (JAX's counts,
    which the port's equal)."""
    runs = chaos_runs["linear"][4]
    st = {name: s for name, (_, s) in runs.items()}
    assert st["nan_retry"]["quarantined"] == st["nan_retry"]["retries"] == 1
    assert st["nan_all"]["failed"] > 0
    assert st["priority"]["preemptions"] >= 1
    assert st["spec_chaos"]["spec_rewinds"] and st["spec_chaos"]["retries"]
    o = st["overload"]
    assert o["shed"] and o["deadline_evictions"] and \
        o["degrade_transitions"] and o["spec_disables"]
    assert st["cancel"]["cancelled"] == 2
    assert st["drop_delay"]["checkpoints"] > 8


# ---------------------------------------------------------------------------
# JAX's tests/test_lifecycle.py within torch
# ---------------------------------------------------------------------------

def _model(backend="linear"):
    _, tcfg = _configs(backend)
    return tcfg, lm.init_params(torch.Generator().manual_seed(0), tcfg)


def _make_workload(cfg, n=6, prompt_len=8, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len,
                            dtype=np.int64).astype(np.int32)
               for _ in range(n)]
    return prompts, [5, 12, 3, 9, 1, 7][:n]


def _busy_workload(cfg):
    """Budgets long enough that every slot is mid-request at event 0 (a
    NaN landing on a freed slot is overwritten by the next admission,
    which is not what these tests probe)."""
    prompts, _ = _make_workload(cfg)
    return prompts, [10, 12, 9, 11, 8, 10]


def _standalone(params, cfg, prompt, gen_len, max_len):
    logits, st = lm.prefill(params, torch.from_numpy(prompt).long()[None],
                            cfg)
    st = lm.pad_decode_state(st, cfg, max_len)
    tok0 = lm.sample_token(logits, 0.0)
    toks = [int(tok0[0])]
    if gen_len > 1:
        more, _ = lm.generate(params, st, tok0, len(prompt), gen_len - 1,
                              cfg)
        toks += more[0].tolist()
    return toks


def _engine(params, cfg, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("segment_len", 4)
    kw.setdefault("max_len", 64)
    return DecodeEngine(params, cfg, **kw)


class TestSubmitValidation:
    def test_rejected_submit_is_atomic(self):
        cfg, params = _model()
        eng = _engine(params, cfg, max_queue=4)
        eng.submit(np.array([1, 2, 3], np.int32), 4)
        before = (len(eng._queue), eng._next_uid,
                  copy.deepcopy(eng.stats.to_dict()))
        bad = [
            dict(prompt=[1, 2], max_new_tokens=0),
            dict(prompt=[1, 2], max_new_tokens=4, speculate_k=-1),
            dict(prompt=[1, 2], max_new_tokens=4, speculate_k=3),
            dict(prompt=[1, 2], max_new_tokens=200),
            dict(prompt=[1, 2], max_new_tokens=4,
                 arrival=5.0, deadline_s=5.0),
            dict(prompt=[1, 2], max_new_tokens=4, fork=0),
        ]
        for kw in bad:
            with pytest.raises(ValueError):
                eng.submit(**kw)
        assert (len(eng._queue), eng._next_uid, eng.stats.to_dict()) == \
            before
        eng.submit(np.array([4, 5], np.int32), 3)
        assert [c.status for c in eng.run()] == ["ok", "ok"]


class TestPreemptResume:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_explicit_preempt_bit_identical(self, backend):
        cfg, params = _model(backend)
        prompts, _ = _make_workload(cfg, n=1)
        ref = _standalone(params, cfg, prompts[0], 12, 64)
        eng = _engine(params, cfg)
        eng.submit(prompts[0], 12)
        eng._admit_pass("continuous")
        eng.step_segment()
        eng._post_event()
        susp = eng.preempt(0)
        assert isinstance(susp, SuspendedRequest)
        assert not eng._active.any() and len(susp.toks) > 0
        comps = eng.run()
        np.testing.assert_array_equal(comps[0].tokens, np.asarray(ref))
        assert eng.stats.preemptions == 1 and eng.stats.resumes == 1
        assert comps[0].status == "ok"

    def test_priority_preempts_lowest_progress(self):
        cfg, params = _model()
        prompts, _ = _make_workload(cfg, n=3)
        jobs = [(prompts[0], 12, 0.0, 0), (prompts[1], 12, 0.0, 0),
                (prompts[2], 8, 6.0, 5)]
        refs = [_standalone(params, cfg, p, g, 64) for p, g, *_ in jobs]
        eng = _engine(params, cfg)
        for p, g, arr, pri in jobs:
            eng.submit(p, g, arrival=arr, priority=pri)
        comps = eng.run()
        assert eng.stats.preemptions >= 1
        assert eng.stats.resumes == eng.stats.preemptions
        for c, ref in zip(comps, refs):
            np.testing.assert_array_equal(c.tokens, np.asarray(ref))
        assert 0 <= comps[2].admitted_step < comps[0].finished_step

    def test_preempt_resume_speculative_slot(self):
        """A speculative request survives suspension: the draft is
        released and re-admitted with prompt + emitted context."""
        cfg, params = _model()
        prompts, _ = _make_workload(cfg, n=2)
        eng = _engine(params, cfg, draft=NgramDraft())
        plain = []
        for p in prompts:
            eng.reset()
            eng.submit(p, 10)
            plain.append(eng.run()[0].tokens)
        eng.reset()
        eng.submit(prompts[0], 10, speculate_k=4)
        eng.submit(prompts[1], 10, speculate_k=4, arrival=4.0, priority=2)
        for c, ref in zip(eng.run(), plain):
            np.testing.assert_array_equal(c.tokens, ref)


class TestDeadlinesAndCancel:
    def test_queued_deadline_sheds(self):
        cfg, params = _model()
        eng = _engine(params, cfg, n_slots=1)
        prompts, _ = _make_workload(cfg, n=3)
        eng.submit(prompts[0], 30)
        eng.submit(prompts[1], 8, deadline_s=4.0)
        eng.submit(prompts[2], 8)
        comps = eng.run()
        assert comps[1].status == "deadline"
        assert comps[1].admitted_step == -1
        assert comps[0].status == comps[2].status == "ok"
        assert eng.stats.deadline_evictions == 1

    def test_active_deadline_keeps_partial_tokens(self):
        cfg, params = _model()
        eng = _engine(params, cfg)
        prompts, _ = _make_workload(cfg, n=1)
        eng.submit(prompts[0], 40, deadline_s=10.0)
        comps = eng.run()
        assert comps[0].status == "deadline"
        assert 0 < len(comps[0].tokens) < 40
        assert comps[0].finish_reason == "deadline"

    def test_injected_delay_trips_deadline(self):
        cfg, params = _model()
        prompts, _ = _make_workload(cfg, n=1)
        eng = _engine(params, cfg)
        eng.submit(prompts[0], 12, deadline_s=20.0)
        assert eng.run()[0].status == "ok"
        eng2 = _engine(params, cfg, injector=FaultInjector(delay={0: 100}))
        eng2.submit(prompts[0], 12, deadline_s=20.0)
        assert eng2.run()[0].status == "deadline"

    def test_cancel_everywhere(self):
        cfg, params = _model()
        eng = _engine(params, cfg, n_slots=1)
        prompts, _ = _make_workload(cfg, n=3)
        u0 = eng.submit(prompts[0], 20)
        u1 = eng.submit(prompts[1], 8)
        assert eng.cancel(u1)
        assert eng._completions[u1].status == "cancelled"
        eng._admit_pass("continuous")
        eng.step_segment()
        eng._post_event()
        assert eng.cancel(u0)
        assert eng.cancel(u0 + 999) is False
        by_uid = {c.uid: c for c in eng.run()}
        assert by_uid[u0].status == "cancelled"
        assert len(by_uid[u0].tokens) > 0
        assert eng.cancel(u0) is False
        assert eng.stats.cancelled == 2


class TestOverloadShed:
    def test_reject_new_bounds_queue(self):
        cfg, params = _model()
        eng = _engine(params, cfg, max_queue=3)
        prompts, _ = _make_workload(cfg, n=6)
        uids = [eng.submit(p, 4, arrival=50.0) for p in prompts]
        assert len(eng._queue) == 3 and eng.stats.shed == 3
        comps = eng.run()
        assert [c.status for c in comps] == ["ok"] * 3 + ["shed"] * 3
        for c in comps:
            if c.status == "shed":
                assert c.admitted_step == -1 and len(c.tokens) == 0
        assert len(comps) == len(uids)

    def test_evict_lowest_prefers_low_priority(self):
        cfg, params = _model()
        eng = _engine(params, cfg, max_queue=2, shed_policy="evict_lowest")
        prompts, _ = _make_workload(cfg, n=4)
        u_lo = eng.submit(prompts[0], 4, arrival=50.0, priority=0)
        u_mid = eng.submit(prompts[1], 4, arrival=50.0, priority=1)
        u_hi = eng.submit(prompts[2], 4, arrival=50.0, priority=3)
        assert eng._completions[u_lo].status == "shed"
        assert {r.uid for r in eng._queue} == {u_mid, u_hi}
        u_new = eng.submit(prompts[3], 4, arrival=50.0, priority=0)
        assert eng._completions[u_new].status == "shed"
        assert eng.stats.shed == 2

    def test_degradation_hysteresis_records_transitions(self):
        cfg, params = _model()
        eng = _engine(params, cfg, degrade_threshold=1.5)
        prompts, _ = _make_workload(cfg, n=8)
        for p in prompts:
            eng.submit(p, 6)
        comps = eng.run()
        st = eng.stats
        assert st.degrade_transitions == 2
        assert st.degrade_events[0]["degraded"] is True
        assert st.degrade_events[1]["degraded"] is False
        assert all(c.status == "ok" for c in comps)

    def test_degraded_spec_disable_keeps_tokens(self):
        cfg, params = _model()
        prompts, _ = _make_workload(cfg, n=6)
        outs = {}
        for thresh in (None, 0.5):
            eng = _engine(params, cfg, draft=NgramDraft(),
                          degrade_threshold=thresh)
            for p in prompts:
                eng.submit(p, 8, speculate_k=4)
            outs[thresh] = eng.run()
            if thresh is not None:
                assert eng.stats.spec_disables > 0
        for a, b in zip(outs[None], outs[0.5]):
            np.testing.assert_array_equal(a.tokens, b.tokens)


class TestQuarantine:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_unaffected_slots_bit_identical(self, backend):
        """A NaN in one slot mid-run: every request's tokens equal the
        fault-free run's, the poisoned one's through one retry."""
        cfg, params = _model(backend)
        prompts, gens = _busy_workload(cfg)
        eng = _engine(params, cfg)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        clean = eng.run()
        eng2 = _engine(params, cfg, injector=FaultInjector(nan=((0, 0),)),
                       max_retries=1)
        for p, g in zip(prompts, gens):
            eng2.submit(p, g)
        chaos = eng2.run()
        st = eng2.stats
        assert st.quarantined == 1 and st.retries == 1
        assert st.failed == 0 and st.resumes >= 1
        for a, b in zip(clean, chaos):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert b.status == "ok"
        assert len([c for c in chaos if c.retries == 1]) == 1

    def test_retries_exhausted_fails_cleanly(self):
        cfg, params = _model()
        prompts, gens = _busy_workload(cfg)
        eng = _engine(params, cfg)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        clean = eng.run()
        eng2 = _engine(params, cfg, injector=FaultInjector(nan=((0, 0),)),
                       max_retries=0)
        for p, g in zip(prompts, gens):
            eng2.submit(p, g)
        chaos = eng2.run()
        st = eng2.stats
        assert st.quarantined == 1 and st.failed == 1 and st.retries == 0
        failed = [c for c in chaos if c.status == "failed"]
        assert len(failed) == 1 and failed[0].finish_reason == "failed"
        for a, b in zip(clean, chaos):
            if b.status == "ok":
                np.testing.assert_array_equal(a.tokens, b.tokens)

    def test_repeated_fault_exhausts_single_retry(self):
        cfg, params = _model()
        prompts, gens = _busy_workload(cfg)
        inj = FaultInjector(nan=((0, 0),) + tuple(
            (e, s) for e in range(2, 7) for s in (0, 1)))
        eng = _engine(params, cfg, injector=inj, max_retries=1)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        comps = eng.run()
        assert eng.stats.failed >= 1
        assert len(comps) == len(prompts)

    def test_quarantined_slot_not_reused(self):
        cfg, params = _model()
        prompts, gens = _busy_workload(cfg)
        eng = _engine(params, cfg, injector=FaultInjector(nan=((0, 0),)),
                      max_retries=1)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        eng.run()
        assert bool(eng._quarantined[0])
        assert eng._slot_req[0] is None and not eng._active[0]

    def test_all_slots_poisoned_fails_pending(self):
        cfg, params = _model()
        prompts, gens = _busy_workload(cfg)
        eng = _engine(params, cfg,
                      injector=FaultInjector(nan=((0, 0), (0, 1))),
                      max_retries=0)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        comps = eng.run()
        assert len(comps) == len(prompts)
        assert eng.stats.failed == len(prompts)
        assert all(c.status == "failed" for c in comps)

    def test_dropped_admission_wave_retries(self):
        cfg, params = _model()
        prompts, gens = _make_workload(cfg)
        eng = _engine(params, cfg)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        clean = eng.run()
        eng2 = _engine(params, cfg,
                       injector=FaultInjector(drop_admission=(0,)))
        for p, g in zip(prompts, gens):
            eng2.submit(p, g)
        chaos = eng2.run()
        for a, b in zip(clean, chaos):
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert b.status == "ok"
        assert chaos[0].admitted_step > clean[0].admitted_step

    def test_spec_mismatch_injection_rewinds_not_diverges(self):
        cfg, params = _model()
        prompts, _ = _make_workload(cfg, n=2)
        outs = {}
        for inj in (None, FaultInjector(spec_mismatch=(0, 1, 2))):
            eng = _engine(params, cfg, draft=NgramDraft(), injector=inj)
            for p in prompts:
                eng.submit(p, 10, speculate_k=4)
            outs[inj is None] = (eng.run(), eng.stats.spec_rewind_rounds)
        for a, b in zip(outs[True][0], outs[False][0]):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        assert outs[False][1] >= outs[True][1]

    def test_poison_snapshot_fills_float_leaves(self):
        cfg, params = _model()
        state = lm.init_decode_state(cfg, 2, max_len=8)
        bad = poison_snapshot(lm.snapshot_state(state, 1))
        assert all(torch.isnan(t).all() for g in bad.values() for st in g
                   for t in st if t is not None)
        lm.restore_state(state, bad, 1)
        assert lm.slot_state_finite(state).tolist() == [True, False]


class TestResetAndStats:
    def test_reset_rerun_identical(self):
        cfg, params = _model()
        prompts, gens = _make_workload(cfg)
        eng = _engine(params, cfg)
        runs = []
        for _ in range(2):
            eng.reset()
            assert eng.stats == EngineStats(n_slots=eng.n_slots,
                                            segment_len=eng.segment_len)
            for p, g in zip(prompts, gens):
                eng.submit(p, g)
            runs.append(eng.run())
        for a, b in zip(*runs):
            assert a.uid == b.uid
            np.testing.assert_array_equal(a.tokens, b.tokens)
            assert (a.admitted_step, a.finished_step) == (
                b.admitted_step, b.finished_step)

    def test_reset_clears_lifecycle_state(self):
        cfg, params = _model()
        prompts, gens = _busy_workload(cfg)
        eng = _engine(params, cfg, injector=FaultInjector(nan=((0, 0),)),
                      max_retries=1)
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        eng.run()
        assert eng._quarantined.any()
        eng.injector = None
        eng.reset()
        assert not eng._quarantined.any()
        assert not eng._suspended and not eng._ckpt
        assert eng.stats.quarantined == 0
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        assert all(c.status == "ok" for c in eng.run())

    def test_stats_json_roundtrip(self):
        cfg, params = _model()
        prompts, gens = _make_workload(cfg, n=3)
        eng = _engine(params, cfg, max_queue=1)
        for p, g in zip(prompts, gens):
            eng.submit(p, g, arrival=50.0)
        eng.run()
        d = json.loads(eng.stats.to_json())
        for field in ("segments", "shed", "quarantined", "preemptions",
                      "retries", "failed", "degrade_events",
                      "slot_utilization", "mean_admission_batch",
                      "acceptance_rate", "tokens_per_round"):
            assert field in d
        assert d["shed"] == eng.stats.shed == 2
        assert isinstance(d["slot_utilization"], float)
