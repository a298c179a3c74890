"""The port's prefix cache and fork against the JAX package, on converted
weights, qwen3-0.6b's smoke config in fp32:

* ``chain_digests`` gives JAX's hex digests;
* every case of JAX's ``tests/test_prefix_cache.py`` within torch but the
  journal's and the fleet's (durability, a later slice): the digest,
  fixed-state and paged-KV units, the row-ranged snapshots, the engine's
  off / cold / warm runs, the byte claim, eviction, the refusals and fork;
* the engine against JAX's under ``linear``, ``gated_linear`` and
  ``softmax``: off, cold and warm completions, every counter (the
  cache's ``bytes_used`` and ``cow_copies`` included) and a fork of 3;
  a cache saved by either package loads in the other, a corrupt one
  leaves the cache empty;
* the pins: every paged block's refcount is 0 after each of the
  lifecycle scenarios (``test_torch_lifecycle.py``) with the cache on,
  whose tokens stay greedy's; a quarantined fork member leaves its
  siblings' snapshot and the cache bit for bit;
* the registry's ``list_backends`` / ``get_backend_cls`` and
  ``serve --mode stream --prefix-cache on --fork 3`` as a subprocess.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import get_backend_cls as jax_get_backend_cls
from repro.serving import list_backends as jax_list_backends
from repro.serving.prefix_cache import chain_digests as jax_chain_digests
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.models.attention import AttnState
from repro_torch.serving import (DecodeEngine, FaultInjector, NgramDraft,
                                 get_backend_cls, list_backends)
from repro_torch.serving.prefix_cache import (FixedStatePrefixCache,
                                              PagedKVCache, chain_digests,
                                              tree_nbytes)
from test_torch_lifecycle import SCENARIOS, _chaos_workload, _run_scenario

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["linear", "gated_linear", "softmax"]
CHUNK = 8
PREFIX = 24
ENGINE_KW = dict(n_slots=2, segment_len=4, max_len=48, prefill_chunk=CHUNK)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(backend, arch="qwen3-0.6b"):
    j, t = jax_smoke_config(arch), get_smoke_config(arch)
    if backend is not None:
        j, t = j.with_backend(backend), t.with_backend(backend)
    return (dataclasses.replace(j, dtype="float32"),
            dataclasses.replace(t, dtype="float32"))


def _model(backend="linear"):
    _, tcfg = _configs(backend)
    return tcfg, lm.init_params(torch.Generator().manual_seed(0), tcfg)


def _shared_prefix_prompts(vocab, n=4, prefix=PREFIX, tail=CHUNK, seed=0):
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=prefix).astype(np.int32)
    return [np.concatenate([shared, rng.integers(0, vocab, size=tail)
                            ]).astype(np.int32) for _ in range(n)]


def _run(engine, prompts, gen=6, fork=1):
    engine.reset()
    for p in prompts:
        engine.submit(p, gen, fork=fork)
    return engine.run("continuous")


def _summary(comps):
    return [(c.uid, c.status, c.finish_reason, c.admitted_step,
             c.finished_step, c.tokens.tolist()) for c in comps]


def _observe(engine, comps):
    """Completions, stats and the cache's own counters of a run."""
    return (_summary(comps), engine.stats.to_dict(),
            None if engine.cache is None else engine.cache.counters())


def _off_cold_warm_fork(engine, prompts):
    """off (the cache detached), cold, warm (reset keeps the cache) and a
    fork of 3 over one prompt, on one engine whose cache starts empty."""
    cache, engine.cache = engine.cache, None
    runs = {"off": _observe(engine, _run(engine, prompts))}
    engine.cache = cache
    for name in ("cold", "warm"):
        runs[name] = _observe(engine, _run(engine, prompts))
    runs["fork"] = _observe(engine, _run(engine, prompts[:1], fork=3))
    return runs


@pytest.fixture(scope="module")
def models():
    """Per backend: both packages' configs and weights, the workload, and
    JAX's engine (its cache on) with its off / cold / warm / fork runs."""
    out = {}
    for backend in BACKENDS:
        jcfg, tcfg = _configs(backend)
        pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg)
        prompts = _shared_prefix_prompts(jcfg.vocab_size)
        jeng = JaxEngine(pj, jcfg, prefix_cache="auto", **ENGINE_KW)
        out[backend] = dict(tcfg=tcfg, pt=pt, prompts=prompts, jeng=jeng,
                            runs=_off_cold_warm_fork(jeng, prompts))
    return out


# ---------------------------------------------------------------------------
# chained content digests
# ---------------------------------------------------------------------------

class TestChainDigests:
    def test_boundaries(self):
        d = chain_digests(np.arange(100, dtype=np.int32), 32)
        assert [n for n, _ in d] == [32, 64, 96]
        assert chain_digests(np.arange(31, dtype=np.int32), 32) == []

    def test_digest_covers_whole_prefix(self):
        a = np.arange(96, dtype=np.int32)
        b = a.copy()
        b[0] += 1
        da, db = chain_digests(a, 32), chain_digests(b, 32)
        assert all(x[1] != y[1] for x, y in zip(da, db))

    def test_shared_prefix_shares_digests(self):
        a = np.arange(96, dtype=np.int32)
        b = np.concatenate([a[:64], a[64:] + 7])
        da, db = chain_digests(a, 32), chain_digests(b, 32)
        assert da[0] == db[0] and da[1] == db[1] and da[2] != db[2]

    @pytest.mark.parametrize("chunk", [1, 8, 64])
    def test_equal_to_jax(self, chunk):
        rng = np.random.default_rng(chunk)
        for n in (0, 7, 64, 200):
            p = rng.integers(0, 151_936, size=n).astype(np.int32)
            assert chain_digests(p, chunk) == jax_chain_digests(p, chunk)
            # int64 and list prompts hash their int32 bytes, as JAX's
            assert chain_digests(p.astype(np.int64).tolist(), chunk) == \
                jax_chain_digests(p, chunk)


# ---------------------------------------------------------------------------
# FixedStatePrefixCache units (states stubbed with plain tensors)
# ---------------------------------------------------------------------------

def _fake_state(nbytes):
    return {"s": torch.zeros(nbytes // 4)}


class TestFixedStateCache:
    def test_longest_prefix_wins(self):
        c = FixedStatePrefixCache(max_bytes=1 << 20, chunk=32)
        p = np.arange(100, dtype=np.int32)
        c.insert(p, 32, _fake_state(64))
        c.insert(p, 96, _fake_state(64))
        hit = c.match(p)
        assert hit is not None and hit.n_tokens == 96

    def test_match_capped_below_prompt_len(self):
        c = FixedStatePrefixCache(max_bytes=1 << 20, chunk=32)
        p = np.arange(64, dtype=np.int32)
        c.insert(p, 64, _fake_state(64))
        assert c.match(p) is None
        hit = c.match(np.concatenate([p, [7]]).astype(np.int32))
        assert hit is not None and hit.n_tokens == 64

    def test_lru_eviction_under_byte_budget(self):
        c = FixedStatePrefixCache(max_bytes=200, chunk=32)
        prompts = [np.arange(32, dtype=np.int32) + 100 * i for i in range(3)]
        for p in prompts:
            c.insert(p, 32, _fake_state(80))
        assert c.bytes_used <= 200 and len(c) == 2 and c.evictions == 1
        assert c.match(np.concatenate([prompts[0], [1]])) is None
        assert c.match(np.concatenate([prompts[2], [1]])) is not None

    def test_match_refreshes_lru(self):
        c = FixedStatePrefixCache(max_bytes=160, chunk=32)
        a = np.arange(32, dtype=np.int32)
        b = a + 500
        c.insert(a, 32, _fake_state(80))
        c.insert(b, 32, _fake_state(80))
        c.match(np.concatenate([a, [1]]))
        c.insert(a + 900, 32, _fake_state(80))
        assert c.match(np.concatenate([a, [1]])) is not None
        assert c.match(np.concatenate([b, [1]])) is None

    def test_wants_only_novel_boundaries(self):
        c = FixedStatePrefixCache(max_bytes=1 << 20, chunk=32)
        p = np.arange(96, dtype=np.int32)
        assert c.wants(p, 32) and not c.wants(p, 33)
        c.insert(p, 32, _fake_state(64))
        assert not c.wants(p, 32) and c.wants(p, 64)


# ---------------------------------------------------------------------------
# PagedKVCache units (block payloads stubbed with AttnStates)
# ---------------------------------------------------------------------------

def _kv_snapshot(rows, k=4, layers=1, fill=0.0):
    """{"stack": (layer states,), "tail": ()} with (1, rows, 1, k) caches:
    the (…, T, H, D) layout, time axis ndim − 3."""
    st = AttnState(k_cache=torch.full((1, rows, 1, k), fill),
                   v_cache=torch.full((1, rows, 1, k), fill))
    return {"stack": ((st,),) * layers, "tail": ()}


class TestPagedKVCache:
    def test_bytes_grow_with_prefix(self):
        c = PagedKVCache(max_bytes=1 << 20, chunk=32)
        p = np.arange(100, dtype=np.int32)
        c.insert(p, 96, _kv_snapshot(96))
        one = c.prefix_nbytes(p, 32)
        assert one > 0
        assert c.prefix_nbytes(p, 64) == 2 * one
        assert c.prefix_nbytes(p, 96) == 3 * one

    def test_refcount_pins_against_eviction(self):
        blk = tree_nbytes(_kv_snapshot(32))
        c = PagedKVCache(max_bytes=2 * blk, chunk=32)
        p = np.arange(65, dtype=np.int32)
        c.insert(p, 64, _kv_snapshot(64))
        hit = c.match(p)
        assert hit is not None and hit.n_tokens == 64
        assert all(c.refcount(d) == 1 for d in hit.keys)
        c.insert(np.arange(32, dtype=np.int32) + 999, 32, _kv_snapshot(32))
        assert all(d in c._blocks for d in hit.keys)
        c.release(hit)
        assert all(c.refcount(d) == 0 for d in hit.keys)
        c.insert(np.arange(32, dtype=np.int32) + 5000, 32, _kv_snapshot(32))
        assert c.bytes_used <= 2 * blk and c.evictions >= 1

    def test_gap_truncates_match(self):
        c = PagedKVCache(max_bytes=1 << 20, chunk=32)
        p = np.arange(100, dtype=np.int32)
        c.insert(p, 96, _kv_snapshot(96))
        d = chain_digests(p, 32)
        c._bytes -= c._blocks.pop(d[1][1]).nbytes
        c._lru.pop(d[1][1], None)
        hit = c.match(p)
        assert hit is not None and hit.n_tokens == 32
        assert c.prefix_nbytes(p, 96) == 0
        c.release(hit)

    def test_materialized_rows_in_order(self):
        c = PagedKVCache(max_bytes=1 << 20, chunk=2)
        p = np.arange(5, dtype=np.int32)
        rows = torch.arange(4.0).reshape(1, 4, 1, 1).expand(1, 4, 1, 4)
        st = AttnState(k_cache=rows.clone(), v_cache=rows.clone())
        snap = {"stack": ((st,),), "tail": ()}
        c.insert(p, 4, snap)
        snap["stack"][0][0].k_cache.fill_(9.0)   # blocks own their rows
        hit = c.match(p)
        got = hit.state["stack"][0][0].k_cache[0, :, 0, 0]
        assert got.tolist() == [0.0, 1.0, 2.0, 3.0]
        assert c.cow_copies == 2
        c.release(hit)

    def test_residue_restricts_insert_to_last_block(self):
        """A hybrid snapshot (a KV cache beside a recurrent state) stores
        only its own boundary's block."""
        snap = _kv_snapshot(64)
        snap["tail"] = (AttnState(s=torch.zeros(1, 1, 4, 4)),)
        c = PagedKVCache(max_bytes=1 << 20, chunk=32)
        p = np.arange(65, dtype=np.int32)
        c.insert(p, 64, snap)
        assert len(c) == 1 and c.prefix_nbytes(p, 64) == 0
        c.insert(p, 64, _kv_snapshot(64))      # pure KV: the first block
        assert len(c) == 2 and c.prefix_nbytes(p, 64) > 0


# ---------------------------------------------------------------------------
# row-ranged softmax KV snapshots
# ---------------------------------------------------------------------------

def _kv_leaves(state):
    return [st for g in state.values() for st in g
            if isinstance(st, AttnState) and st.k_cache is not None]


class TestRowRangedSnapshots:
    def _state(self, cfg, params, prompt, max_len=64):
        _, st = lm.prefill(params, torch.from_numpy(prompt).long()[None],
                           cfg)
        return lm.pad_decode_state(st, cfg, max_len)

    def test_snapshot_rows_bytes_scale_with_rows(self):
        cfg, params = _model("softmax")
        state = self._state(cfg, params, np.arange(8, dtype=np.int32))
        full = lm.snapshot_state(state, 0)
        r8 = lm.snapshot_state_rows(state, 0, 8)
        r32 = lm.snapshot_state_rows(state, 0, 32)
        assert tree_nbytes(r8) * 4 == tree_nbytes(r32)
        assert tree_nbytes(r8) < tree_nbytes(full)
        assert tree_nbytes(lm.snapshot_state_rows(state, 0, 64)) == \
            tree_nbytes(full)
        view = lm.state_rows_view(state, 0, 8)     # the template: no copy
        assert tree_nbytes(view) == tree_nbytes(r8)
        assert all(v.k_cache.data_ptr() == s.k_cache.data_ptr()
                   for v, s in zip(_kv_leaves(view), _kv_leaves(state)))

    def test_ranged_restore_writes_only_covered_rows(self):
        cfg, params = _model("softmax")
        state = self._state(cfg, params, np.arange(8, dtype=np.int32))
        snap = lm.snapshot_state_rows(state, 0, 8)
        poisoned = lm.snapshot_state(state, 0)
        for st in _kv_leaves(poisoned):
            st.k_cache.fill_(7.0)
        restored = lm.restore_state_rows(poisoned, snap, 0)
        for st_r, st_o in zip(_kv_leaves(restored), _kv_leaves(state)):
            t = st_r.k_cache.ndim - 3
            got = st_r.k_cache.movedim(t, 0)
            want = st_o.k_cache.movedim(t, 0)
            assert torch.equal(got[:8], want[:8])
            assert bool((got[8:] == 7.0).all())

    def test_where_state_rows_merges_only_window(self):
        cfg, params = _model("softmax")
        state = self._state(cfg, params, np.arange(8, dtype=np.int32))
        old = lm.snapshot_state(state, 0)
        marked = lm.snapshot_state(state, 0)
        for st in _kv_leaves(marked):
            st.k_cache.fill_(3.0)
        merged = lm.where_state_rows(np.ones(1, bool), marked,
                                     lm.snapshot_state(state, 0),
                                     np.full(1, 8), 4)
        got = _kv_leaves(merged)[0].k_cache
        want = _kv_leaves(old)[0].k_cache
        t = got.ndim - 3
        got, want = got.movedim(t, 0), want.movedim(t, 0)
        assert torch.equal(got[:8], want[:8])
        assert bool((got[8:12] == 3.0).all())
        assert torch.equal(got[12:], want[12:])

    def test_preempt_resume_bit_identity_ranged(self):
        cfg, params = _model("softmax")
        prompts = _shared_prefix_prompts(cfg.vocab_size, n=2, prefix=16)
        eng = DecodeEngine(params, cfg, **dict(ENGINE_KW, max_len=96))
        ref = _run(eng, prompts, gen=10)
        eng.reset()
        for p in prompts:
            eng.submit(p, 10)
        while not eng._active.any():
            eng.step()
        victim = next(s for s in range(eng.n_slots) if eng._active[s])
        susp = eng.preempt(victim)
        assert tree_nbytes(susp.state) < \
            eng.backend.state_bytes_per_slot(eng.max_len)
        got = eng.run()
        assert _summary(got)[0][-1] == _summary(ref)[0][-1]
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a.tokens, b.tokens)

    def test_spec_round_bit_identity_ranged(self):
        cfg, params = _model("softmax")
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, cfg.vocab_size, size=12).astype(np.int32)
                   for _ in range(3)]
        ref = _run(DecodeEngine(params, cfg, **dict(ENGINE_KW, max_len=96)),
                   prompts, gen=10)
        eng = DecodeEngine(params, cfg, draft=NgramDraft(),
                           **dict(ENGINE_KW, max_len=96))
        for p in prompts:
            eng.submit(p, 10, speculate_k=4)
        got = eng.run()
        assert eng.stats.spec_rounds > 0
        for a, b in zip(ref, got):
            np.testing.assert_array_equal(a.tokens, b.tokens)


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_cache_matches_jax(models, backend):
    """off, cold, warm and a fork of 3: completions, every stats field and
    every cache counter equal JAX's; the three runs give one set of
    tokens; warm encodes no prompt."""
    m = models[backend]
    eng = DecodeEngine(m["pt"], m["tcfg"], prefix_cache="auto", **ENGINE_KW)
    runs = _off_cold_warm_fork(eng, m["prompts"])
    for name, (comps, st, counters) in runs.items():
        j_comps, j_st, j_counters = m["runs"][name]
        assert comps == j_comps, name
        assert set(st) == set(j_st)
        for k in st:
            assert st[k] == j_st[k], (name, k)
        assert counters == j_counters, name
    toks = {name: [c[-1] for c in runs[name][0]]
            for name in ("off", "cold", "warm")}
    assert toks["off"] == toks["cold"] == toks["warm"]
    cold, warm, fork = (runs[n][1] for n in ("cold", "warm", "fork"))
    n = len(m["prompts"])
    assert cold["cache_hits"] >= 1 and warm["prefills"] == 0
    assert (warm["cache_hits"], warm["cache_misses"],
            warm["cached_prefix_tokens"]) == (n, 0, PREFIX * n)
    assert (fork["prefills"], fork["forks"]) == (0, 2)   # a warm hit
    assert len({tuple(c[-1]) for c in runs["fork"][0]}) == 1
    # every pin released: a paged block's refcount is 0 between runs
    if backend == "softmax":
        assert runs["warm"][2]["cow_copies"] - \
            runs["cold"][2]["cow_copies"] == n * PREFIX // CHUNK
        assert all(b.refcount == 0 for b in eng.cache._blocks.values())


def test_linear_bytes_flat_softmax_bytes_grow(models):
    """The paper's cost claim in bytes: doubling the cached prefix leaves a
    fixed-size entry's bytes unchanged while the softmax blocks double;
    each figure equal to JAX's."""
    sizes = {}
    for backend in ("linear", "softmax"):
        m = models[backend]
        eng = DecodeEngine(m["pt"], m["tcfg"], prefix_cache="auto",
                           **ENGINE_KW)
        base = np.random.default_rng(3).integers(
            0, m["tcfg"].vocab_size, size=32).astype(np.int32)
        for n in (16, 32):
            p = np.concatenate([base[:n], [1]]).astype(np.int32)
            _run(eng, [p], gen=2)
            sizes[backend, n] = eng.cache.prefix_nbytes(p, n)
    assert sizes["linear", 16] > 0
    assert sizes["linear", 32] == sizes["linear", 16]
    assert sizes["softmax", 32] == 2 * sizes["softmax", 16]
    # JAX's warm cache holds the same entry sizes
    jc = models["linear"]["jeng"].cache
    assert set(e["nbytes"] for e in jc._entries.values()) == \
        {sizes["linear", 16]}
    jb = models["softmax"]["jeng"].cache
    assert set(b.nbytes for b in jb._blocks.values()) == \
        {sizes["softmax", 16] // 2}


def test_eviction_degrades_to_cold_miss(models):
    m = models["linear"]
    prompts = m["prompts"][:3]
    off = _run(DecodeEngine(m["pt"], m["tcfg"], **ENGINE_KW), prompts)
    eng = DecodeEngine(m["pt"], m["tcfg"], prefix_cache="auto",
                       cache_bytes=1, **ENGINE_KW)
    got = _run(eng, prompts)
    for a, b in zip(off, got):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    assert eng.stats.cache_hits == 0 and eng.stats.cache_evictions >= 1


@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_required_cache_raises_on_per_request_admission(arch):
    _, cfg = _configs(None, arch)
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    with pytest.raises(ValueError, match="prefix caching requires batched"):
        DecodeEngine(params, cfg, n_slots=2, max_len=32, prefix_cache=True)
    # "auto" turns it off there; the backend names the capability
    eng = DecodeEngine(params, cfg, n_slots=2, max_len=32,
                       prefix_cache="auto")
    assert eng.cache is None and not eng.backend.supports_prefix_cache
    with pytest.raises(ValueError, match="supports_prefix_cache"):
        eng.backend.make_prefix_cache(1 << 20, CHUNK)


def test_misaligned_cache_chunk_rejected():
    cfg, params = _model()
    with pytest.raises(ValueError, match="chunk"):
        DecodeEngine(params, cfg, prefix_cache=FixedStatePrefixCache(
            max_bytes=1 << 20, chunk=12), **ENGINE_KW)
    with pytest.raises(ValueError, match="prefix_cache"):
        DecodeEngine(params, cfg, prefix_cache="on", **ENGINE_KW)
    shared = FixedStatePrefixCache(max_bytes=1 << 20, chunk=2 * CHUNK)
    assert DecodeEngine(params, cfg, prefix_cache=shared,
                        **ENGINE_KW).cache is shared


# ---------------------------------------------------------------------------
# fork / n-best
# ---------------------------------------------------------------------------

class TestFork:
    @pytest.mark.parametrize("backend", ["linear", "softmax"])
    def test_fork_equals_independent_submits(self, backend):
        cfg, params = _model(backend)
        prompt = _shared_prefix_prompts(cfg.vocab_size, n=1)[0]
        eng = DecodeEngine(params, cfg, **dict(ENGINE_KW, n_slots=3))
        indep = _run(eng, [prompt] * 3, gen=8)
        forked = _run(eng, [prompt], gen=8, fork=3)
        assert [c.uid for c in forked] == [0, 1, 2]
        for a, b in zip(indep, forked):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        assert eng.stats.prefills == 1 and eng.stats.forks == 2
        assert eng._next_uid == 3

    def test_fork_members_shed_with_primary(self):
        cfg, params = _model()
        prompt = _shared_prefix_prompts(cfg.vocab_size, n=1)[0]
        eng = DecodeEngine(params, cfg, max_queue=1, **ENGINE_KW)
        eng.submit(prompt, 4)
        eng.submit(prompt, 4, fork=3)              # shed on arrival
        comps = eng.run()
        by_uid = {c.uid: c for c in comps}
        assert len(comps) == 4 and eng.stats.shed == 1
        assert all(by_uid[u].status == "shed" for u in (1, 2, 3))

    def test_fork_budget_one_completes_at_admission(self):
        cfg, params = _model()
        prompt = _shared_prefix_prompts(cfg.vocab_size, n=1)[0]
        eng = DecodeEngine(params, cfg, **ENGINE_KW)
        comps = _run(eng, [prompt], gen=1, fork=2)
        assert len(comps) == 2 and eng.stats.forks == 0
        np.testing.assert_array_equal(comps[0].tokens, comps[1].tokens)

    def test_quarantined_member_leaves_siblings_and_cache(self):
        """A NaN in a fork member's slot: the member is retried from its
        checkpoint (the shared snapshot), every token stays the clean
        run's, and the siblings' snapshot and the cache entries are bit
        for bit what they were."""
        cfg, params = _model()
        prompts = _shared_prefix_prompts(cfg.vocab_size, n=2)
        kw = dict(ENGINE_KW, n_slots=4, prefix_cache="auto")
        eng = DecodeEngine(params, cfg, **kw)
        _run(eng, prompts[:1], gen=2)          # warm the cache
        clean = _run(eng, prompts[1:], gen=10, fork=3)
        entries = {k: [t.clone() for g in e["state"].values() for st in g
                       for t in st if t is not None]
                   for k, e in eng.cache._entries.items()}
        eng.injector = FaultInjector(nan=((1, 1),))
        eng.reset()
        eng.submit(prompts[1], 10, fork=3)
        eng.step()                  # a hit, the suffix, the members spawned
        assert eng.stats.cache_hits == 1 and eng.stats.forks == 2
        snap = eng._suspended[0].state           # the members' one snapshot
        assert eng._suspended[1].state is snap
        before = [t.clone() for g in snap.values() for st in g for t in st
                  if t is not None]
        got = eng.run()
        st = eng.stats
        assert (st.quarantined, st.retries, st.failed) == (1, 1, 0)
        assert [c.retries for c in got] == [0, 1, 0]
        for a, b in zip(clean, got):
            np.testing.assert_array_equal(a.tokens, b.tokens)
        after = [t for g in snap.values() for st in g for t in st
                 if t is not None]
        assert all(torch.equal(a, b) for a, b in zip(before, after))
        for k, e in eng.cache._entries.items():
            now = [t for g in e["state"].values() for st in g for t in st
                   if t is not None]
            assert all(torch.equal(a, b) for a, b in zip(entries[k], now))


# ---------------------------------------------------------------------------
# pins through the lifecycle
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["linear", "softmax"])
def test_lifecycle_scenarios_release_every_pin(backend):
    """The lifecycle scenarios with the cache on and a shared 16-token
    prefix: after each one every paged block's refcount is 0 and no slot
    holds a pin; a completed request's tokens are its greedy tokens
    alone, a cut one's a prefix of them."""
    jcfg, tcfg = _configs(backend)
    params = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    prompts, gens = _chaos_workload(tcfg.vocab_size)
    shared = np.random.default_rng(5).integers(0, tcfg.vocab_size, size=16)
    prompts = [np.concatenate([shared, p]).astype(np.int32)
               for p in prompts]
    ref = {}
    eng = DecodeEngine(params, tcfg, n_slots=2, segment_len=4, max_len=64)
    for i, (p, g) in enumerate(zip(prompts, gens)):
        eng.reset()
        eng.submit(p, g)
        ref[i] = eng.run()[0].tokens.tolist()
    eng = DecodeEngine(params, tcfg, n_slots=2, segment_len=4, max_len=64,
                       prefill_chunk=CHUNK, prefix_cache=True)
    pk = {"F": FaultInjector, "D": NgramDraft}
    hits = 0
    for name in SCENARIOS:
        comps, st = _run_scenario(eng, pk, name, prompts, gens)
        hits += st["cache_hits"]
        assert len(comps) == len(prompts), name
        for c in comps:
            got = c.tokens.tolist()
            want = ref[c.uid] if c.status == "ok" else ref[c.uid][:len(got)]
            assert got == want, (name, c.uid, c.status)
        assert eng._cache_hold == [None] * eng.n_slots, name
        if backend == "softmax":
            assert all(b.refcount == 0
                       for b in eng.cache._blocks.values()), name
            assert len(eng.cache._lru) == len(eng.cache), name
    assert hits > 0


# ---------------------------------------------------------------------------
# persistence across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["linear", "softmax"])
def test_cache_saved_by_either_package_loads_in_the_other(models, backend,
                                                          tmp_path):
    """JAX's warm cache saved, loaded by the port: its warm run serves
    every request from it with JAX's warm tokens; the port's saved,
    loaded by JAX: the same. A corrupt file: False and an empty cache."""
    m = models[backend]
    jeng, prompts = m["jeng"], m["prompts"]
    j_warm = m["runs"]["warm"]
    n = len(prompts)
    jeng.save_cache(str(tmp_path / "jax"))
    eng = DecodeEngine(m["pt"], m["tcfg"], prefix_cache="auto", **ENGINE_KW)
    assert eng.load_cache(str(tmp_path / "jax"))
    assert eng.cache.bytes_used == jeng.cache.bytes_used
    warm = _observe(eng, _run(eng, prompts))
    assert warm[0] == j_warm[0]
    assert (warm[1]["cache_hits"], warm[1]["prefills"]) == (n, 0)
    if backend == "softmax":
        assert all(b.refcount == 0 for b in eng.cache._blocks.values())

    eng.save_cache(str(tmp_path / "torch"))
    saved = jeng.cache
    jeng.cache = type(saved)(max_bytes=saved.max_bytes, chunk=saved.chunk)
    try:
        assert jeng.load_cache(str(tmp_path / "torch"))
        assert jeng.cache.bytes_used == eng.cache.bytes_used
        j_again = _observe(jeng, _run(jeng, prompts))
        assert j_again[0] == j_warm[0]
        assert j_again[1]["cache_hits"] == n
    finally:
        jeng.cache = saved

    step = tmp_path / "torch" / os.listdir(tmp_path / "torch")[0]
    (step / "arrays.npz").write_bytes(b"not a zip")
    assert not eng.load_cache(str(tmp_path / "torch"))
    assert len(eng.cache) == 0 and eng.cache.bytes_used == 0
    assert not eng.load_cache(str(tmp_path / "none"))
    off = _run(eng, prompts)                    # a cold start, right tokens
    assert [c.tokens.tolist() for c in off] == [c[-1] for c in j_warm[0]]


def test_registry_matches_jax():
    assert list_backends() == jax_list_backends()
    for name in list_backends():
        assert get_backend_cls(name).name == name
        assert get_backend_cls(name).priority == \
            jax_get_backend_cls(name).priority
    with pytest.raises(KeyError, match="unknown backend"):
        get_backend_cls("nope")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def test_serve_stream_prefix_cache_and_fork_cli(tmp_path):
    """``serve --mode stream --prefix-cache on --fork 3`` as a subprocess
    with two threads: 3 completions a request off one prefill each, the
    cache line printed; ``on`` raises for rwkv6-1.6b, ``auto`` runs it
    without a cache."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    path = tmp_path / "stats.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode",
         "stream", "--smoke", "--device", "cpu", "--prefix-cache", "on",
         "--fork", "3", "--slots", "4", "--n-requests", "4",
         "--prompt-len", "40", "--gen-len", "16", "--prefill-chunk", "16",
         "--stats-json", str(path)],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    assert "stream: 12 requests" in out.stdout
    assert "prefix cache (fixed_state): hits=0 misses=4" in out.stdout
    st = json.loads(path.read_text())
    assert (st["prefills"], st["forks"]) == (4, 8)

    args = ["--mode", "stream", "--arch", "rwkv6-1.6b", "--smoke",
            "--device", "cpu", "--slots", "2", "--n-requests", "2",
            "--prompt-len", "8", "--gen-len", "2"]
    with pytest.raises(ValueError, match="batched admission"):
        serve.stream(serve.parse_args(args + ["--prefix-cache", "on"]))
    res = serve.stream(serve.parse_args(args + ["--prefix-cache", "auto"]))
    assert res["engine"].cache is None and len(res["completions"]) == 2
