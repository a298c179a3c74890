"""The port's speculative decoding against the JAX package on converted
weights, smoke configs in fp32:

* the port's ``DecodeEngine`` against JAX's with ``speculate_k`` under
  linear, gated_linear and softmax (qwen3-0.6b) and on rwkv6-1.6b and
  zamba2-7b, each with ``NgramDraft``, ``ReplayDraft`` and ``ModelDraft``
  (a draft model of the target's weights with noise of a tenth of each
  leaf's spread, so windows are accepted whole and in part): completions
  token for token, statuses, admitted and finished steps and every
  ``spec_*`` and lifecycle counter equal (JAX's engine serves every run
  of a family, so its count of compiled admission shapes is not
  compared: ``test_torch_engine.py`` holds it);
* the row-ranged state forms (``snapshot_state_rows``,
  ``restore_state_rows``, ``where_state_rows``) against JAX's on the
  same numbers, exactly, and a softmax cache's rows outside the range
  bit for bit;
* the masked verify window: slots not speculating keep their state bit
  for bit, and a slot's round-start copy plus the varlen rewind equals
  decoding the accepted tokens one at a time;
* every case of JAX's ``tests/test_speculative.py`` within torch, and
  ``serve --mode spec --device cpu`` as a subprocess.

fp32: the verify window sums in another order than the sequential step,
and fp32 keeps the greedy margins above that.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import ModelDraft as JaxModelDraft
from repro.serving import NgramDraft as JaxNgramDraft
from repro.serving import ReplayDraft as JaxReplayDraft
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.serving import (DecodeEngine, DraftProvider, ModelDraft,
                                 NgramDraft, ReplayDraft)

ROOT = Path(__file__).resolve().parents[1]
BACKENDS = ["linear", "gated_linear", "softmax"]
FAMILIES = [("qwen3-0.6b", "linear"), ("qwen3-0.6b", "gated_linear"),
            ("qwen3-0.6b", "softmax"), ("rwkv6-1.6b", None),
            ("zamba2-7b", "linear")]
DRAFTS = ["ngram", "replay", "model"]
ENGINE_KW = dict(n_slots=2, segment_len=4, max_len=64)
# the speculative and lifecycle counters compared with JAX's
COUNTERS = ("segments", "emitted_tokens", "prefills", "admission_batches",
            "prefill_dispatches", "ingest_chunks", "admission_dispatches",
            "spec_rounds", "spec_drafted",
            "spec_accepted", "spec_emitted", "spec_rewinds",
            "spec_rewind_rounds", "spec_rewind_dispatches", "preemptions",
            "resumes", "cancelled", "deadline_evictions", "shed",
            "quarantined", "retries", "failed", "checkpoints",
            "finite_checks", "degrade_transitions", "spec_disables",
            "acceptance_rate", "tokens_per_round", "cache_hits",
            "cache_misses", "cache_evictions", "cached_prefix_tokens",
            "forks")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, backend, dtype="float32"):
    j, t = jax_smoke_config(arch), get_smoke_config(arch)
    if backend is not None:
        j, t = j.with_backend(backend), t.with_backend(backend)
    return (dataclasses.replace(j, dtype=dtype),
            dataclasses.replace(t, dtype=dtype))


def _workload(vocab, n=4, prompt_len=8, seed=0, gens=(20, 13, 20, 7)):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, size=prompt_len,
                            dtype=np.int64).astype(np.int32)
               for _ in range(n)]
    return prompts, list(gens)[:n]


def _run(engine, prompts, gens, speculate_k=0, **submit_kw):
    engine.reset()
    for p, g in zip(prompts, gens):
        engine.submit(p, g, speculate_k=speculate_k, **submit_kw)
    return engine.run("continuous")


def _assert_same(plain, spec):
    assert len(plain) == len(spec)
    for a, b in zip(plain, spec):
        np.testing.assert_array_equal(a.tokens, b.tokens)
        assert a.finish_reason == b.finish_reason


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def families():
    """Per (arch, backend): configs, both packages' target weights and a
    draft model's (the target's, each leaf plus normal noise of a tenth
    of its spread), the workload and JAX's runs: plain, and speculative
    with each draft."""
    out = {}
    rng = np.random.default_rng(7)
    for arch, backend in FAMILIES:
        jcfg, tcfg = _configs(arch, backend)
        pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        dj = jax.tree.map(lambda x: jnp.asarray(
            x + 0.1 * np.std(x) * rng.standard_normal(x.shape), x.dtype), pj)
        pt = convert.params_from_jax(_np_tree(pj), tcfg)
        dt = convert.params_from_jax(_np_tree(dj), tcfg)
        prompts, gens = _workload(jcfg.vocab_size)
        eng = JaxEngine(pj, jcfg, **ENGINE_KW)
        plain = _run(eng, prompts, gens)
        conts = {JaxReplayDraft.key(p): c.tokens
                 for p, c in zip(prompts, plain)}
        runs = {}
        for name in DRAFTS:
            eng.draft = {"ngram": lambda: JaxNgramDraft(),
                         "replay": lambda: JaxReplayDraft(conts),
                         "model": lambda: JaxModelDraft(
                             dj, jcfg, n_slots=2, max_len=64)}[name]()
            runs[name] = (_run(eng, prompts, gens, speculate_k=3),
                          eng.stats.to_dict())
        out[arch, backend] = dict(jcfg=jcfg, tcfg=tcfg, pt=pt, dt=dt,
                                  prompts=prompts, gens=gens, plain=plain,
                                  conts=conts, runs=runs)
    return out


@pytest.mark.parametrize("draft", DRAFTS)
@pytest.mark.parametrize("arch,backend", FAMILIES)
def test_spec_engine_matches_jax_engine(families, arch, backend, draft):
    f = families[arch, backend]
    tcfg = f["tcfg"]
    made = {"ngram": lambda: NgramDraft(),
            "replay": lambda: ReplayDraft(f["conts"]),
            "model": lambda: ModelDraft(f["dt"], tcfg, n_slots=2,
                                        max_len=64)}[draft]()
    eng = DecodeEngine(f["pt"], tcfg, draft=made, **ENGINE_KW)
    comps = _run(eng, f["prompts"], f["gens"], speculate_k=3)
    j_comps, j_stats = f["runs"][draft]
    st = eng.stats.to_dict()
    assert len(comps) == len(j_comps)
    for a, b, p in zip(comps, j_comps, f["plain"]):
        assert (a.uid, a.status, a.finish_reason, a.admitted_step,
                a.finished_step, a.retries) == (
            b.uid, b.status, b.finish_reason, b.admitted_step,
            b.finished_step, b.retries)
        np.testing.assert_array_equal(a.tokens, b.tokens)
        np.testing.assert_array_equal(a.tokens, p.tokens)
    for k in COUNTERS:
        assert st[k] == j_stats[k], k
    assert st["spec_rounds"] > 0
    assert st["spec_rewind_dispatches"] == st["spec_rewind_rounds"]


def test_model_draft_accepts_windows_whole_and_in_part(families):
    """The noisy draft model exercises both of ModelDraft's commits:
    full acceptors (the trailing token) and partial ones (the round-start
    copy and the re-advance)."""
    _, j_stats = families["qwen3-0.6b", "linear"]["runs"]["model"]
    assert 0.0 < j_stats["acceptance_rate"] < 1.0
    assert j_stats["spec_rewinds"] > 0
    assert j_stats["spec_rewind_rounds"] < j_stats["spec_rounds"]


# ---------------------------------------------------------------------------
# the row-ranged state forms against JAX's
# ---------------------------------------------------------------------------

def _random_states(jcfg, batch, rows, seed):
    rng = np.random.default_rng(seed)
    j = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        jlm.init_decode_state(jcfg, batch, rows))
    return j, convert.state_from_jax(_np_tree(j))


def _leaves(state):
    return [(f"{part}[{i}].{f}", getattr(st, f))
            for part in ("stack", "tail") for i, st in enumerate(state[part])
            for f in A.AttnState._fields if getattr(st, f) is not None]


def _assert_equal_to_jax(t_state, j_state):
    j_leaves = jax.tree.leaves(_np_tree(j_state))
    t_leaves = _leaves(t_state)
    assert len(t_leaves) == len(j_leaves)
    for (name, t), j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape, name
        np.testing.assert_array_equal(t.numpy(), j, err_msg=name)


@pytest.mark.parametrize("backend", BACKENDS)
def test_row_forms_match_jax(backend):
    """On the same numbers: a snapshot cut to 5 rows, its restore into
    another slot, and a row-ranged merge at per-slot starts (one clamped
    to max_len - width) equal JAX's exactly; under softmax the slot's
    rows past the snapshot's 5 keep their old contents, and every cache
    row outside a merged slot's range stays bit for bit."""
    jcfg, _ = _configs("qwen3-0.6b", backend)
    j_old, t_old = _random_states(jcfg, 3, 16, 1)
    j_new, t_new = _random_states(jcfg, 3, 16, 2)
    before = {n: x.clone() for n, x in _leaves(t_old)}

    j_snap = jlm.snapshot_state_rows(j_old, 1, 5)
    t_snap = lm.snapshot_state_rows(t_old, 1, 5)
    _assert_equal_to_jax(t_snap, j_snap)
    j_st = jlm.restore_state_rows(j_old, j_snap, 2)
    lm.restore_state_rows(t_old, t_snap, 2)
    _assert_equal_to_jax(t_old, j_st)

    mask = np.asarray([True, False, True])
    start = np.asarray([3, 0, 14], np.int32)
    j_st = jlm.where_state_rows(jnp.asarray(mask), j_new, j_st,
                                jnp.asarray(start), 4)
    lm.where_state_rows(torch.from_numpy(mask), t_new, t_old,
                        torch.from_numpy(start), 4)
    _assert_equal_to_jax(t_old, j_st)
    for name, x in _leaves(t_old):
        axis = 1 if name.startswith("stack") else 0
        old = before[name]
        assert torch.equal(x.select(axis, 1), old.select(axis, 1)), name
        if backend != "softmax":
            continue
        t = x.ndim - 3
        row = lambda y, s: y.select(axis, s)            # noqa: E731
        # slot 0 merged over rows [3, 7): rows outside keep their old
        for r in list(range(3)) + list(range(7, 16)):
            assert torch.equal(row(x, 0).select(t - 1, r),
                               row(old, 0).select(t - 1, r)), (name, r)
        # slot 2 restored over rows [0, 5), merged over [12, 16)
        for r in range(5, 12):
            assert torch.equal(row(x, 2).select(t - 1, r),
                               row(old, 2).select(t - 1, r)), (name, r)


def test_row_forms_keep_fixed_states_whole():
    """Under the linear family the row forms are the plain ones: the
    snapshot is the slot's whole state at any n_rows, 0 included."""
    jcfg, _ = _configs("qwen3-0.6b", "linear")
    _, t_state = _random_states(jcfg, 3, 16, 3)
    for n_rows in (0, 5):
        snap = lm.snapshot_state_rows(t_state, 1, n_rows)
        for (name, a), (_, b) in zip(_leaves(snap),
                                     _leaves(lm.snapshot_state(t_state, 1))):
            assert torch.equal(a, b), name


# ---------------------------------------------------------------------------
# the masked verify and the rewind, within torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_verify_window_masks_other_slots_and_rewind_is_exact(backend):
    """The verify's masked window (lens = K+1 on speculative rows, 0
    elsewhere) leaves the other slots bit for bit; the round-start copy
    of a slot's fixed-size state plus a varlen re-advance of its first
    a+1 tokens equals decoding them one at a time from the round start
    (under softmax the re-advance rewrites the cache rows the verify
    wrote, no copy)."""
    _, tcfg = _configs("qwen3-0.6b", backend)
    params = lm.init_params(torch.Generator().manual_seed(0), tcfg)
    rng = np.random.default_rng(5)
    tokens = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (3, 9)))
    _, state = lm.prefill(params, tokens, tcfg)
    state = lm.pad_decode_state(state, tcfg, 24)
    before = lm.snapshot_state(state, 0), lm.snapshot_state(state, 2)
    pre = lm.snapshot_state_rows(state, 1, 0)
    seq = lm.snapshot_state_rows(state, 1, 24)
    window = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (3, 7)))
    pos = torch.full((3,), 9, dtype=torch.int32)
    lm.decode_window_varlen(params, state, window, pos,
                            torch.tensor([0, 7, 0]), tcfg)
    for slot, snap in zip((0, 2), before):
        for (name, a), (_, b) in zip(_leaves(lm.snapshot_state(state, slot)),
                                     _leaves(snap)):
            assert torch.equal(a, b), (slot, name)
    # rewind slot 1 to 3 of its 7 window tokens
    lm.restore_state_rows(state, pre, 1)
    lm.decode_window_varlen(params, state, window, pos,
                            torch.tensor([0, 3, 0]), tcfg, last_only=True)
    for i in range(3):
        lm.decode_step(params, seq, window[1:2, i], pos[:1] + i, tcfg)
    got = lm.snapshot_state_rows(state, 1, 12)
    want = lm.snapshot_state_rows(seq, 0, 12)     # rows the steps wrote
    for (name, a), (_, b) in zip(_leaves(got), _leaves(want)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6, msg=name)


# ---------------------------------------------------------------------------
# JAX's tests/test_speculative.py within torch
# ---------------------------------------------------------------------------

def _torch_model(backend, seed=0):
    _, tcfg = _configs("qwen3-0.6b", backend)
    return tcfg, lm.init_params(torch.Generator().manual_seed(seed), tcfg)


class TestSpeculativeBitIdentity:
    """spec == plain greedy, token for token, on every backend."""

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_all_accepted(self, backend):
        """Draft model == target model: every draft token matches, every
        round keeps the verify's state (zero rewinds)."""
        cfg, params = _torch_model(backend)
        prompts, gens = _workload(cfg.vocab_size)
        eng = DecodeEngine(params, cfg, **ENGINE_KW)
        plain = _run(eng, prompts, gens)
        eng.draft = ModelDraft(params, cfg, n_slots=2, max_len=64)
        spec = _run(eng, prompts, gens, speculate_k=3)
        _assert_same(plain, spec)
        assert eng.stats.acceptance_rate == 1.0
        assert eng.stats.spec_rewinds == 0
        assert eng.stats.spec_rounds > 0

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_all_rejected(self, backend):
        """An unrelated draft model: (almost) nothing is accepted, every
        round emits the target's own next token after a rewind."""
        cfg, params = _torch_model(backend)
        prompts, gens = _workload(cfg.vocab_size)
        eng = DecodeEngine(params, cfg, **ENGINE_KW)
        plain = _run(eng, prompts, gens)
        _, dparams = _torch_model(backend, seed=123)
        eng.draft = ModelDraft(dparams, cfg, n_slots=2, max_len=64)
        spec = _run(eng, prompts, gens, speculate_k=3)
        _assert_same(plain, spec)
        assert eng.stats.acceptance_rate < 0.2
        assert eng.stats.spec_rewinds > 0

    def test_k_equals_one(self):
        """The smallest window: 1 draft + 1 bonus token per round."""
        cfg, params = _torch_model("linear")
        prompts, gens = _workload(cfg.vocab_size)
        eng = DecodeEngine(params, cfg, **ENGINE_KW,
                           draft=ModelDraft(params, cfg, n_slots=2,
                                            max_len=64))
        plain = _run(eng, prompts, gens)
        spec = _run(eng, prompts, gens, speculate_k=1)
        _assert_same(plain, spec)
        assert eng.stats.acceptance_rate == 1.0

    def test_ngram_draft(self):
        """Prompt-lookup drafting: any acceptance, the same tokens."""
        cfg, params = _torch_model("linear")
        prompts, gens = _workload(cfg.vocab_size)
        eng = DecodeEngine(params, cfg, **ENGINE_KW, draft=NgramDraft())
        plain = _run(eng, prompts, gens)
        spec = _run(eng, prompts, gens, speculate_k=4)
        _assert_same(plain, spec)
        assert eng.stats.spec_drafted > 0

    def test_eos_inside_draft_window(self):
        """EOS emitted as an accepted draft token mid-window ends the
        emission where plain decoding stops (inclusive)."""
        cfg, params = _torch_model("linear")
        prompts, gens = _workload(cfg.vocab_size, gens=(16, 16, 16, 16))
        eng = DecodeEngine(params, cfg, **ENGINE_KW)
        plain = _run(eng, prompts, gens)
        eos_id = next(int(t) for c in plain for t in c.tokens[1:-1])
        eng_eos = DecodeEngine(params, cfg, **ENGINE_KW, eos_id=eos_id)
        refs = _run(eng_eos, prompts, gens)
        assert any(c.finish_reason == "eos" for c in refs)
        eng_eos.draft = ReplayDraft({ReplayDraft.key(p): c.tokens
                                     for p, c in zip(prompts, plain)})
        spec = _run(eng_eos, prompts, gens, speculate_k=5)
        _assert_same(refs, spec)

    def test_budget_exhausted_inside_window(self):
        """A budget that is no multiple of the round's tokens: the last
        round stops mid-window, like plain decode."""
        cfg, params = _torch_model("linear")
        prompts, gens = _workload(cfg.vocab_size, gens=(5, 9, 2, 11))
        eng = DecodeEngine(params, cfg, **ENGINE_KW)
        plain = _run(eng, prompts, gens)
        eng.draft = ReplayDraft({ReplayDraft.key(p): c.tokens
                                 for p, c in zip(prompts, plain)})
        spec = _run(eng, prompts, gens, speculate_k=6)
        _assert_same(plain, spec)
        for c, g in zip(spec, gens):
            assert len(c.tokens) == g and c.finish_reason == "length"

    def test_mixed_speculate_k_values(self):
        """Different K per request in one slot batch: the smaller-K slots
        always rewind."""
        cfg, params = _torch_model("linear")
        prompts, gens = _workload(cfg.vocab_size)
        eng = DecodeEngine(params, cfg, **ENGINE_KW)
        plain = _run(eng, prompts, gens)
        eng.draft = ModelDraft(params, cfg, n_slots=2, max_len=64)
        eng.reset()
        for i, (p, g) in enumerate(zip(prompts, gens)):
            eng.submit(p, g, speculate_k=2 + (i % 2) * 3)
        _assert_same(plain, eng.run("continuous"))


class TestSpeculativeValidation:
    def test_speculate_k_requires_draft(self):
        cfg, params = _torch_model("linear")
        eng = DecodeEngine(params, cfg, **ENGINE_KW)
        with pytest.raises(ValueError, match="draft provider"):
            eng.submit(np.arange(4), 5, speculate_k=2)

    def test_speculate_greedy_only(self):
        cfg, params = _torch_model("linear")
        eng = DecodeEngine(params, cfg, **ENGINE_KW, temperature=0.7,
                           draft=NgramDraft())
        with pytest.raises(ValueError, match="greedy"):
            eng.submit(np.arange(4), 5, speculate_k=2)

    def test_speculate_k_counts_against_max_len(self):
        cfg, params = _torch_model("linear")
        eng = DecodeEngine(params, cfg, n_slots=2, segment_len=4,
                           max_len=16, draft=NgramDraft())
        eng.submit(np.arange(8), 5, speculate_k=4)      # 8+5+4 <= 17
        with pytest.raises(ValueError, match="speculate_k"):
            eng.submit(np.arange(8), 6, speculate_k=4)  # 8+6+4 > 17


class TestNgramDraft:
    def test_copies_repeating_continuation(self):
        d = NgramDraft(max_ngram=3)
        d.admit(0, np.asarray([5, 1, 2, 3, 9, 1, 2, 3], np.int32))
        # the suffix [1, 2, 3] last occurred at the start, followed by 9
        out = d.propose(np.zeros(1, np.int32), np.zeros(1, np.int32),
                        np.asarray([True]), 3)
        np.testing.assert_array_equal(out[0], [9, 1, 2])
        assert isinstance(d, DraftProvider)

    def test_fallback_repeats_last(self):
        d = NgramDraft()
        d.admit(0, np.asarray([1, 2, 3], np.int32))
        out = d.propose(np.zeros(1, np.int32), np.zeros(1, np.int32),
                        np.asarray([True]), 4)
        np.testing.assert_array_equal(out[0], [3, 3, 3, 3])

    def test_commit_extends_history(self):
        d = NgramDraft(max_ngram=2)
        d.admit(0, np.asarray([1, 2], np.int32))
        d.commit(0, np.asarray([3, 1, 2], np.int32))
        out = d.propose(np.zeros(1, np.int32), np.zeros(1, np.int32),
                        np.asarray([True]), 1)
        np.testing.assert_array_equal(out[0], [3])


# ---------------------------------------------------------------------------
# serve --mode spec on the CPU
# ---------------------------------------------------------------------------

def test_serve_spec_cli_on_cpu(tmp_path):
    """``serve --mode spec --smoke --device cpu`` as a subprocess with two
    threads: it asserts the speculative tokens equal plain greedy's,
    prints JAX's summary lines and writes the stats."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    path = tmp_path / "stats.json"
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--mode", "spec",
         "--smoke", "--device", "cpu", "--slots", "3", "--n-requests", "4",
         "--prompt-len", "12", "--gen-len", "12", "--speculate-k", "4",
         "--draft", "replay", "--stats-json", str(path)],
        env=env, capture_output=True, text=True, timeout=300, check=True)
    assert "outputs bit-identical" in out.stdout
    assert "speculate_k=4 draft=replay" in out.stdout
    st = json.loads(path.read_text())
    # the replay runs out at each request's end, where drafts miss
    assert st["acceptance_rate"] > 0.5 and st["spec_rounds"] > 0
