"""The port's durable serving against the JAX package, on converted
weights of ``fleet_demo_config``'s smoke configs (fp32):

* kill and recover under linear, softmax and mamba2, crashed at events
  0, 2 and 4, from the journal and a checkpoint, from the journal alone,
  and crashed twice: every uid completes with the tokens of JAX's
  uncrashed greedy run, acked once in the journal file;
* engine checkpoints mid-flight: the port's continuation gives JAX's
  tokens under every backend, a checkpoint written by either package
  restores in the other (linear and softmax), the clock, stats and next
  uid come back, and a sampled (temperature > 0) run continues bit for
  bit through the generator's saved state;
* the fleet: replica failover with JAX's ``replica_injectors`` gives
  JAX's completions per original uid and JAX's ``failovers``,
  ``readmitted`` and ``unrecovered``; the breaker stops routing; a fleet
  checkpoint and ``FleetEngine.recover`` reach the same completions;
  JAX's two journal-aware fork cases;
* the lookup engine's checkpoint (bitwise, either package's) and
  ``HedgedLookup`` with a killed replica against JAX's answers and
  hedge counts, with no uid delivered twice.

Each JAX side runs once per module (module-scoped fixtures); the crash
points are parametrised on the port's side against it.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import lm as jlm
from repro.qa.gru import gru_params as jax_gru_params
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import FaultInjector as JaxFaultInjector
from repro.serving import FleetEngine as JaxFleet
from repro.serving import HedgedLookup as JaxHedged
from repro.serving import LookupEngine as JaxLookup
from repro.serving import fleet_demo_config as jax_fleet_config
from repro_torch import convert
from repro_torch.serving import (DecodeEngine, FaultInjector, FleetEngine,
                                 HedgedLookup, InjectedCrash, Journal,
                                 LookupEngine, fleet_demo_config)

BACKENDS = ["linear", "softmax", "mamba2"]
ENGINE_KW = dict(n_slots=2, segment_len=4, max_len=64)
CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _workload(vocab, n=6, prompt_len=8, seed=0):
    """JAX's ``tests/test_serving._make_workload``, draw for draw."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=prompt_len,
                            dtype=np.int64).astype(np.int32)
               for _ in range(n)]
    return prompts, [5, 12, 3, 9, 1, 7][:n]


def _submit_all(eng, prompts, gens, **kw):
    return [eng.submit(p, g, **kw) for p, g in zip(prompts, gens)]


def _tokens(completions):
    return {c.uid: np.asarray(c.tokens).tolist() for c in completions}


def _acked_uids(path_or_journal):
    j = (Journal(path_or_journal) if isinstance(path_or_journal, str)
         else path_or_journal)
    return sorted(r["uid"] for r in j.records() if r["t"] == "ack")


def _engine(pt, tcfg, **kw):
    return DecodeEngine(pt, tcfg, **dict(ENGINE_KW, **kw))


@pytest.fixture(scope="module")
def models():
    """Per backend: JAX's weights, the port's copy, the workload and JAX's
    uncrashed greedy tokens."""
    out = {}
    for backend in BACKENDS:
        jcfg, tcfg = jax_fleet_config(backend), fleet_demo_config(backend)
        pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg,
                                     device=CPU)
        prompts, gens = _workload(jcfg.vocab_size)
        eng = JaxEngine(pj, jcfg, **ENGINE_KW)
        _submit_all(eng, prompts, gens)
        ref = _tokens(eng.run())
        out[backend] = dict(jcfg=jcfg, tcfg=tcfg, pj=pj, pt=pt,
                            prompts=prompts, gens=gens, ref=ref)
    return out


@pytest.fixture(scope="module")
def jax_checkpoints(models, tmp_path_factory):
    """JAX's engine stopped after 3 steps and checkpointed, for linear
    and softmax: the directory and what the engine held at the save."""
    out = {}
    for backend in ("linear", "softmax"):
        m = models[backend]
        cd = str(tmp_path_factory.mktemp(f"jax_ck_{backend}"))
        eng = JaxEngine(m["pj"], m["jcfg"], checkpoint_dir=cd, **ENGINE_KW)
        _submit_all(eng, m["prompts"], m["gens"])
        for _ in range(3):
            eng.step()
        eng.save_checkpoint()
        out[backend] = dict(dir=cd, clock=eng._clock,
                            next_uid=eng._next_uid,
                            stats=eng.stats.to_dict(),
                            completions=_tokens(eng.completions()))
    return out


# ---------------------------------------------------------------------------
# kill and recover
# ---------------------------------------------------------------------------

class TestKillAndRecover:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_uncrashed_port_run_gives_jax_tokens(self, models, backend):
        m = models[backend]
        eng = _engine(m["pt"], m["tcfg"])
        _submit_all(eng, m["prompts"], m["gens"])
        assert _tokens(eng.run()) == m["ref"]

    @pytest.mark.parametrize("backend", BACKENDS)
    @pytest.mark.parametrize("crash_at", [0, 2, 4])
    def test_recovered_tokens_are_jax_uncrashed_ones(self, models, tmp_path,
                                                     backend, crash_at):
        m = models[backend]
        jp, cd = str(tmp_path / "wal.journal"), str(tmp_path / "ck")
        eng = _engine(m["pt"], m["tcfg"], journal=jp, checkpoint_dir=cd,
                      checkpoint_every=2,
                      injector=FaultInjector(crash=(crash_at,)))
        _submit_all(eng, m["prompts"], m["gens"])
        with pytest.raises(InjectedCrash):
            eng.run()
        eng.journal.close()
        rec = DecodeEngine.recover(m["pt"], m["tcfg"], journal=Journal(jp),
                                   checkpoint_dir=cd, **ENGINE_KW)
        got = _tokens(rec.run())
        rec.journal.close()
        assert got == m["ref"]
        assert _acked_uids(jp) == sorted(m["ref"])       # each uid once

    def test_recover_from_the_journal_alone(self, models, tmp_path):
        m = models["linear"]
        jp = str(tmp_path / "wal.journal")
        eng = _engine(m["pt"], m["tcfg"], journal=jp,
                      injector=FaultInjector(crash=(1,)))
        _submit_all(eng, m["prompts"], m["gens"])
        with pytest.raises(InjectedCrash):
            eng.run()
        rec = DecodeEngine.recover(m["pt"], m["tcfg"], journal=Journal(jp),
                                   **ENGINE_KW)
        assert _tokens(rec.run()) == m["ref"]
        assert _acked_uids(rec.journal) == sorted(m["ref"])

    def test_double_crash_double_recover(self, models, tmp_path):
        m = models["linear"]
        jp, cd = str(tmp_path / "wal.journal"), str(tmp_path / "ck")
        eng = _engine(m["pt"], m["tcfg"], journal=jp, checkpoint_dir=cd,
                      checkpoint_every=2, injector=FaultInjector(crash=(1,)))
        _submit_all(eng, m["prompts"], m["gens"])
        with pytest.raises(InjectedCrash):
            eng.run()
        rec1 = DecodeEngine.recover(m["pt"], m["tcfg"], journal=Journal(jp),
                                    checkpoint_dir=cd, checkpoint_every=2,
                                    injector=FaultInjector(crash=(2,)),
                                    **ENGINE_KW)
        with pytest.raises(InjectedCrash):
            rec1.run()
        rec2 = DecodeEngine.recover(m["pt"], m["tcfg"], journal=Journal(jp),
                                    checkpoint_dir=cd, **ENGINE_KW)
        assert _tokens(rec2.run()) == m["ref"]
        assert _acked_uids(rec2.journal) == sorted(m["ref"])


# ---------------------------------------------------------------------------
# engine checkpoints
# ---------------------------------------------------------------------------

class TestEngineCheckpoint:
    @pytest.mark.parametrize("backend", BACKENDS)
    def test_mid_flight_roundtrip_gives_jax_tokens(self, models, tmp_path,
                                                   backend):
        m = models[backend]
        cd = str(tmp_path / "ck")
        eng = _engine(m["pt"], m["tcfg"], checkpoint_dir=cd)
        _submit_all(eng, m["prompts"], m["gens"])
        for _ in range(3):
            eng.step()
        eng.save_checkpoint()
        fresh = _engine(m["pt"], m["tcfg"], checkpoint_dir=cd)
        fresh.restore_checkpoint()
        assert _tokens(fresh.run()) == m["ref"]

    @pytest.mark.parametrize("backend", ["linear", "softmax"])
    def test_jax_checkpoint_restores_in_the_port(self, models,
                                                 jax_checkpoints, backend):
        m, ck = models[backend], jax_checkpoints[backend]
        eng = _engine(m["pt"], m["tcfg"], checkpoint_dir=ck["dir"])
        eng.restore_checkpoint()
        assert eng._clock == ck["clock"]
        assert eng._next_uid == ck["next_uid"]
        assert eng.stats.to_dict() == ck["stats"]
        assert _tokens(eng.completions()) == ck["completions"]
        assert _tokens(eng.run()) == m["ref"]

    @pytest.mark.parametrize("backend", ["linear", "softmax"])
    def test_port_checkpoint_restores_in_jax(self, models, tmp_path,
                                             jax_checkpoints, backend):
        m, ck = models[backend], jax_checkpoints[backend]
        cd = str(tmp_path / "ck")
        eng = _engine(m["pt"], m["tcfg"], checkpoint_dir=cd)
        _submit_all(eng, m["prompts"], m["gens"])
        for _ in range(3):
            eng.step()
        # the port stopped where JAX's stopped, with JAX's counters, and
        # its key leaf is JAX's PRNGKey(seed)
        assert (eng._clock, eng._next_uid) == (ck["clock"], ck["next_uid"])
        assert eng._key.dtype == torch.uint32
        assert eng._key.tolist() == np.asarray(
            jax.random.PRNGKey(0)).tolist()
        assert eng.stats.to_dict() == ck["stats"]
        eng.save_checkpoint()
        jeng = JaxEngine(m["pj"], m["jcfg"], checkpoint_dir=cd,
                         **ENGINE_KW)
        jeng.restore_checkpoint()
        assert jeng._clock == eng._clock
        assert jeng._next_uid == eng._next_uid
        assert jeng.stats.to_dict() == eng.stats.to_dict()
        assert _tokens(jeng.run()) == m["ref"]

    def test_restore_preserves_stats_clock_and_uids(self, models, tmp_path):
        m = models["linear"]
        cd = str(tmp_path / "ck")
        eng = _engine(m["pt"], m["tcfg"], checkpoint_dir=cd)
        _submit_all(eng, m["prompts"], m["gens"])
        for _ in range(2):
            eng.step()
        eng.save_checkpoint()
        fresh = _engine(m["pt"], m["tcfg"], checkpoint_dir=cd)
        fresh.restore_checkpoint()
        assert fresh._next_uid == eng._next_uid
        assert fresh._clock == eng._clock
        assert fresh.stats.to_dict() == eng.stats.to_dict()
        assert torch.equal(fresh._key, eng._key)

    def test_sampled_run_continues_bit_for_bit(self, models, tmp_path):
        """Temperature > 0: the generator's state rides in ``extra``, so
        the restored run draws what the uninterrupted one drew."""
        m = models["linear"]
        kw = dict(temperature=0.8, seed=3)
        eng = _engine(m["pt"], m["tcfg"], **kw)
        _submit_all(eng, m["prompts"], m["gens"])
        ref = _tokens(eng.run())
        cd = str(tmp_path / "ck")
        eng = _engine(m["pt"], m["tcfg"], checkpoint_dir=cd, **kw)
        _submit_all(eng, m["prompts"], m["gens"])
        for _ in range(3):
            eng.step()
        eng.save_checkpoint()
        fresh = _engine(m["pt"], m["tcfg"], checkpoint_dir=cd, **kw)
        fresh.restore_checkpoint()
        assert _tokens(fresh.run()) == ref

    def test_jax_checkpoint_without_generator_reseeds(self, models,
                                                      jax_checkpoints):
        m, ck = models["linear"], jax_checkpoints["linear"]
        eng = _engine(m["pt"], m["tcfg"], checkpoint_dir=ck["dir"], seed=5)
        eng._gen.manual_seed(99)
        eng.restore_checkpoint()
        want = torch.Generator().manual_seed(5).get_state()
        assert torch.equal(eng._gen.get_state(), want)


# ---------------------------------------------------------------------------
# the fleet
# ---------------------------------------------------------------------------

FAILOVER_INJECTORS = {("linear", 1): (1,)}
DEAD_INJECTORS = {("linear", 0): (0,), ("linear", 1): (0,)}


def _fleet_summary(fleet):
    st = fleet.stats()
    return (_tokens(fleet.completions()), st["failovers"], st["readmitted"],
            list(st["unrecovered"]))


@pytest.fixture(scope="module")
def jax_fleets(models):
    """JAX's fleet runs: 8 requests over 2 linear replicas with replica 1
    crashing at event 1; 4 requests with both replicas crashing at event
    0 (stepped at most 8 times)."""
    m = models["linear"]
    groups = {"linear": (m["pj"], m["jcfg"])}
    prompts, gens = _workload(m["jcfg"].vocab_size, n=8)
    fleet = JaxFleet(groups, replicas=2, replica_injectors={
        k: JaxFaultInjector(crash=v) for k, v in
        FAILOVER_INJECTORS.items()}, **ENGINE_KW)
    uids = [fleet.submit(p, g, backend="linear")
            for p, g in zip(prompts, gens)]
    fleet.run()
    out = {"failover": (uids,) + _fleet_summary(fleet)}
    fleet = JaxFleet(groups, replicas=2, heartbeat_misses=1,
                     replica_injectors={k: JaxFaultInjector(crash=v)
                                        for k, v in DEAD_INJECTORS.items()},
                     **ENGINE_KW)
    for p, g in zip(prompts[:4], gens[:4]):
        fleet.submit(p, g, backend="linear")
    for _ in range(8):
        if not fleet.has_work():
            break
        fleet.step()
    out["dead"] = _fleet_summary(fleet)
    return out


def _port_fleet(m, **kw):
    return FleetEngine({"linear": (m["pt"], m["tcfg"])},
                       **dict(ENGINE_KW, **kw))


class TestFleet:
    def test_failover_gives_jax_completions_and_counts(self, models,
                                                       jax_fleets):
        m = models["linear"]
        prompts, gens = _workload(m["jcfg"].vocab_size, n=8)
        fleet = _port_fleet(m, replicas=2, replica_injectors={
            k: FaultInjector(crash=v) for k, v in
            FAILOVER_INJECTORS.items()})
        uids = [fleet.submit(p, g, backend="linear")
                for p, g in zip(prompts, gens)]
        fleet.run()
        got = (uids,) + _fleet_summary(fleet)
        assert got == jax_fleets["failover"]
        assert got[2] == 1 and got[3] > 0 and got[4] == []
        dead = fleet.stats()["replicas"]["linear"][1]
        assert dead["dead"] and dead["open"]
        # the same tokens as a single engine (one replica, no crash)
        solo = _port_fleet(m)
        for p, g in zip(prompts, gens):
            solo.submit(p, g, backend="linear")
        assert _tokens(solo.run()) == got[1]

    def test_no_healthy_replica_gives_jax_unrecovered(self, models,
                                                      jax_fleets):
        m = models["linear"]
        prompts, gens = _workload(m["jcfg"].vocab_size, n=4)
        fleet = _port_fleet(m, replicas=2, heartbeat_misses=1,
                            replica_injectors={
                                k: FaultInjector(crash=v)
                                for k, v in DEAD_INJECTORS.items()})
        for p, g in zip(prompts, gens):
            fleet.submit(p, g, backend="linear")
        for _ in range(8):
            if not fleet.has_work():
                break
            fleet.step()
        got = _fleet_summary(fleet)
        assert got == jax_fleets["dead"]
        assert got[3]

    def test_breaker_stops_routing_to_a_dead_replica(self, models):
        m = models["linear"]
        fleet = _port_fleet(m, replicas=2, breaker_threshold=1,
                            replica_injectors={
                                ("linear", 0): FaultInjector(crash=(0,))})
        prompts, gens = _workload(m["jcfg"].vocab_size, n=4)
        for p, g in zip(prompts, gens):
            fleet.submit(p, g, backend="linear")
        fleet.run()
        assert len(fleet.completions()) == 4
        u = fleet.submit(prompts[0], 2, backend="linear")
        assert fleet._replica_route[u] == 1
        fleet.run()
        assert u in {c.uid for c in fleet.completions()}

    def test_fleet_checkpoint_and_recover(self, models, tmp_path):
        m = models["linear"]
        jd, cd = str(tmp_path / "wal"), str(tmp_path / "ck")
        os.makedirs(jd)
        kw = dict(journal_dir=jd, checkpoint_dir=cd)
        fleet = _port_fleet(m, **kw)
        for p, g in zip(m["prompts"], m["gens"]):
            fleet.submit(p, g, backend="linear")
        for _ in range(2):
            fleet.step()
        fleet.save_checkpoint()
        for reps in fleet._replicas.values():
            for rs in reps:
                rs.engine.journal.close()
        fresh = FleetEngine.recover({"linear": (m["pt"], m["tcfg"])},
                                    **dict(ENGINE_KW, **kw))
        assert _tokens(fresh.run()) == m["ref"]

    def test_fork_replay_exactly_once(self, models):
        """JAX's ``test_prefix_cache.py`` case: a journaled fork submit
        runs again on replay only while a member is unacked, and acked
        members are served as journaled."""
        m = models["linear"]
        jr = Journal()
        eng = _engine(m["pt"], m["tcfg"], journal=jr)
        eng.submit(m["prompts"][0], 6, fork=3)
        ref = eng.run()
        assert len(jr.acked()) == 3
        eng2 = _engine(m["pt"], m["tcfg"], journal=jr)
        eng2._replay_journal()
        assert not eng2.has_work()
        got = eng2.completions()
        assert [c.uid for c in got] == [0, 1, 2]
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        # a member acked, the others not: the submit runs again and only
        # the unacked members are acked anew
        part = Journal()
        for r in jr.records():
            if r["t"] != "ack" or r["uid"] == 1:
                part.append(r)
        eng3 = _engine(m["pt"], m["tcfg"], journal=part)
        eng3._replay_journal()
        got = _tokens(eng3.run())
        assert got == _tokens(ref)
        assert sorted(r["uid"] for r in part.records()
                      if r["t"] == "ack") == [0, 1, 2]

    def test_fleet_fork_routes_all_uids(self, models):
        m = models["linear"]
        fleet = _port_fleet(m)
        p = m["prompts"][0]
        uid = fleet.submit(p, 4, fork=3)
        uid2 = fleet.submit(p, 4)
        assert uid == 0 and uid2 == 3
        comps = fleet.run("continuous")
        assert [c.uid for c in comps] == [0, 1, 2, 3]
        for c in comps[1:]:
            np.testing.assert_array_equal(comps[0].tokens, c.tokens)


# ---------------------------------------------------------------------------
# the lookup engine's checkpoint and HedgedLookup
# ---------------------------------------------------------------------------

K = 16


def _lookup_fixtures():
    """JAX's ``test_durability._lookup_fixtures``: the encoder from JAX's
    keys, six documents and a uniform query width."""
    root = jax.random.PRNGKey(0)
    enc = {"embed": jax.random.normal(root, (50, 8)).astype(jnp.float32)
           * 0.1, "gru": jax_gru_params(jax.random.fold_in(root, 1), 8, K)}
    rng = np.random.default_rng(0)
    docs = {f"d{i}": rng.integers(0, 50, size=int(rng.integers(3, 12)))
            for i in range(6)}
    queries = {f"d{i}": rng.standard_normal((2, K)).astype(np.float32)
               for i in range(6)}
    return enc, docs, queries


def _port_encoder(enc):
    return convert.encoder_from_jax(jax.tree.map(np.asarray, enc),
                                    device=CPU)


@pytest.fixture(scope="module")
def jax_lookup(tmp_path_factory):
    """JAX's lookup engine answering d0 and checkpointed, and JAX's hedged
    run with replica 0 killed."""
    enc, docs, queries = _lookup_fixtures()
    e = JaxLookup(enc, wave_size=4)
    for d, t in docs.items():
        e.ingest(d, t)
    e.flush()
    u0 = e.submit("d0", queries["d0"])
    answer = {r.uid: r for r in e.run()}[u0].answers
    directory = str(tmp_path_factory.mktemp("jax_lookup"))
    e.save_checkpoint(directory)
    h = JaxHedged(enc, replicas=2, hedge_after=1, wave_size=2)
    for d, t in docs.items():
        h.ingest(d, t)
    huids = {d: h.submit(d, q) for d, q in queries.items()}
    h.kill(0)
    out = {r.uid: r for r in h.run()}
    return dict(enc=enc, docs=docs, queries=queries, answer=answer,
                dir=directory,
                store={k: np.asarray(v) for k, v in e.store.items()},
                hedged={d: out[u].answers for d, u in huids.items()},
                counts=(h.hedged, h.hedge_wins, h.losers_cancelled))


class TestLookup:
    def test_checkpoint_roundtrip_bitwise(self, jax_lookup, tmp_path):
        enc = _port_encoder(jax_lookup["enc"])
        e = LookupEngine(enc, wave_size=4, device="cpu")
        for d, t in jax_lookup["docs"].items():
            e.ingest(d, t)
        e.flush()
        u0 = e.submit("d0", jax_lookup["queries"]["d0"])
        ref = {r.uid: r for r in e.run()}[u0].answers
        np.testing.assert_allclose(ref, jax_lookup["answer"], rtol=1e-4,
                                   atol=1e-6)
        d = str(tmp_path / "lk")
        e.save_checkpoint(d)
        rec = LookupEngine.recover(enc, directory=d, wave_size=4,
                                   device="cpu")
        for k in e.store:
            assert torch.equal(e.store[k], rec.store[k])
        assert rec.stats == e.stats and rec.rows() == e.rows()
        assert {r.uid: r.answers.tolist() for r in rec.results()} == \
            {r.uid: r.answers.tolist() for r in e.results()}
        u = rec.submit("d0", jax_lookup["queries"]["d0"])
        np.testing.assert_array_equal(
            {r.uid: r for r in rec.run()}[u].answers, ref)

    def test_jax_checkpoint_restores_bitwise(self, jax_lookup):
        enc = _port_encoder(jax_lookup["enc"])
        rec = LookupEngine.recover(enc, directory=jax_lookup["dir"],
                                   wave_size=4, device="cpu")
        for k, v in jax_lookup["store"].items():
            np.testing.assert_array_equal(rec.store[k].numpy(), v)
        np.testing.assert_array_equal(rec.results()[0].answers,
                                      jax_lookup["answer"])
        u = rec.submit("d0", jax_lookup["queries"]["d0"])
        np.testing.assert_allclose({r.uid: r for r in rec.run()}[u].answers,
                                   jax_lookup["answer"], rtol=1e-5,
                                   atol=1e-7)

    def test_hedged_lookup_with_a_killed_replica(self, jax_lookup):
        enc = _port_encoder(jax_lookup["enc"])
        docs, queries = jax_lookup["docs"], jax_lookup["queries"]
        solo = LookupEngine(enc, wave_size=4, device="cpu")
        for d, t in docs.items():
            solo.ingest(d, t)
        uids = {d: solo.submit(d, q) for d, q in queries.items()}
        res = {r.uid: r for r in solo.run()}
        h = HedgedLookup(enc, replicas=2, hedge_after=1, wave_size=2,
                         device="cpu")
        for d, t in docs.items():
            h.ingest(d, t)
        huids = {d: h.submit(d, q) for d, q in queries.items()}
        h.kill(0)
        out = h.run()
        assert sorted(r.uid for r in out) == sorted(huids.values())
        by = {r.uid: r for r in out}
        for d in docs:
            np.testing.assert_array_equal(by[huids[d]].answers,
                                          res[uids[d]].answers)
            np.testing.assert_allclose(by[huids[d]].answers,
                                       jax_lookup["hedged"][d], rtol=1e-4,
                                       atol=1e-6)
        assert (h.hedged, h.hedge_wins, h.losers_cancelled) == \
            jax_lookup["counts"]
        assert h.hedged > 0 and h.hedge_wins > 0

    def test_no_duplicate_delivery_without_a_kill(self, jax_lookup):
        enc = _port_encoder(jax_lookup["enc"])
        h = HedgedLookup(enc, replicas=2, hedge_after=1, wave_size=1,
                         device="cpu")
        for d, t in jax_lookup["docs"].items():
            h.ingest(d, t)
        huids = [h.submit(d, q) for d, q in jax_lookup["queries"].items()]
        out = h.run()
        assert [r.uid for r in out] == sorted(huids)
        assert all(r.status == "ok" for r in out)
        # every hedge's loser was either cancelled in its queue or
        # answered too late and dropped
        answered = sum(1 for e in h.engines for r in e.results()
                       if r.status == "ok")
        assert h.hedged == h.losers_cancelled + answered - len(huids)
