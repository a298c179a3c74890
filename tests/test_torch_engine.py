"""The port's continuous-batching slice against the JAX package on
converted weights, qwen3-0.6b's smoke config in fp32, for ``linear``,
``gated_linear`` and ``softmax`` (the KV-cache baseline,
``SoftmaxKVBackend``):

* the model surface of the engine — ``prefill_varlen``,
  ``decode_step(active=)``, ``generate_segment``,
  ``ingest_window_varlen`` and the per-slot state copies — against
  JAX's: states within 1e-5, logits within 1e-4 (the two frameworks sum
  in different orders), greedy tokens identical; masked rows bit for bit
  within torch (under softmax the KV caches, grown to 24 rows, the gated
  row of a masked slot included);
* the port's ``DecodeEngine`` against JAX's on a mixed workload (prompts
  of 1 to 40 tokens, two beyond the ingest chunk) under both admissions
  and both ingest programs: completions token for token, finish
  reasons, admitted and finished steps and the core's stats equal;
* the JAX engine tests (run-alone identity, batched admission, the
  segment) ported within torch, and ``serve --mode stream`` and
  ``--mode retrieve`` on the CPU.

JAX runs its engine on the CPU through its jnp reference recurrence
(``decode_kernel="auto"`` off a TPU); the JAX runs are module fixtures.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.serving import DecodeEngine as JaxEngine
from repro.serving.backends import backend_for_config as jax_backend_for
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import attention as A
from repro_torch.models import lm
from repro_torch.serving import DecodeEngine, backend_for_config
from repro_torch.serving.backends import DecodeBackend
from repro_torch.serving.engine import PAD_ID

STATE_TOL, LOGIT_TOL = 1e-5, 1e-4
RULES = Rules.null()
BACKENDS = ["linear", "gated_linear", "softmax"]
LINEAR = ["linear", "gated_linear"]
CACHE_ROWS = 24       # the softmax caches' rows in the model-surface tests
# EngineStats fields the port keeps (JAX's core counters), and the
# derived ratios
CORE_STATS = ("segments", "emitted_tokens", "prefills", "n_slots",
              "segment_len", "admission_batches", "prefill_dispatches",
              "ingest_chunks", "ingest_interleaved", "admission_dispatches",
              "prefill_jit_misses", "slot_utilization",
              "mean_admission_batch", "interleave_ratio", "cache_hits",
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


def _configs(backend, dtype="float32"):
    kw = dict(attention_backend=backend, dtype=dtype)
    return (dataclasses.replace(jax_smoke_config("qwen3-0.6b"), **kw),
            dataclasses.replace(get_smoke_config("qwen3-0.6b"), **kw))


@pytest.fixture(scope="module")
def models():
    """Per backend: (JAX cfg, torch cfg, JAX params, torch params)."""
    out = {}
    for backend in BACKENDS:
        jcfg, tcfg = _configs(backend)
        pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        out[backend] = (jcfg, tcfg, pj,
                        convert.params_from_jax(_np_tree(pj), tcfg))
    return out


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _leaves(state):
    """(name, torch leaf) of a port state, in the JAX tree's order."""
    return [(f"{part}[{i}].{f}", getattr(st, f))
            for part in ("stack", "tail") for i, st in enumerate(state[part])
            for f in A.AttnState._fields if getattr(st, f) is not None]


def _assert_state_close(t_state, j_state, tol=STATE_TOL):
    """Every leaf normwise: max|Δ| within ``tol`` times the leaf's max
    magnitude (at least 1). A state sums many k vᵀ terms of either sign,
    so an element near 0 carries the rounding of its large terms; tol 0
    asks for equality."""
    j_leaves = [x for x in jax.tree.leaves(_np_tree(j_state))]
    t_leaves = _leaves(t_state)
    assert len(t_leaves) == len(j_leaves)
    for (name, t), j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape, name
        err = np.abs(t.numpy() - j).max()
        assert err <= tol * max(1.0, np.abs(j).max()), (name, err)


def _clone(state):
    return {part: tuple(A.AttnState(*(None if x is None else x.clone()
                                      for x in st)) for st in state[part])
            for part in ("stack", "tail")}


def _assert_rows_unchanged(new, old, rows):
    """Slots ``rows`` of every leaf bit for bit (stack: slot axis 1)."""
    for (name, n), (_, o) in zip(_leaves(new), _leaves(old)):
        axis = 1 if name.startswith("stack") else 0
        for r in rows:
            assert torch.equal(n.select(axis, r), o.select(axis, r)), \
                f"{name} slot {r}"


def _prefilled(models, backend, lens=(8, 5, 3)):
    """A (3, 8) prompt batch prefilled by both packages (varlen), from
    which the window and step tests continue; softmax caches grown to
    CACHE_ROWS rows (zeros) by each package's ``pad_decode_state``."""
    jcfg, tcfg, pj, pt = models[backend]
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    lens = np.asarray(lens, np.int32)
    j_last, j_st = jlm.prefill_varlen(pj, jnp.asarray(tokens),
                                      jnp.asarray(lens), jcfg, RULES)
    t_last, t_st = lm.prefill_varlen(pt, _t(tokens).long(), _t(lens), tcfg)
    return tokens, lens, (j_last, jlm.pad_decode_state(j_st, jcfg,
                                                       CACHE_ROWS)), (
        t_last, lm.pad_decode_state(t_st, tcfg, CACHE_ROWS))


# ---------------------------------------------------------------------------
# the model surface against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_prefill_varlen_matches_jax(models, backend):
    _, _, (j_last, j_st), (t_last, t_st) = _prefilled(models, backend)
    np.testing.assert_allclose(t_last.numpy(), np.asarray(j_last),
                               rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _assert_state_close(t_st, j_st)


@pytest.mark.parametrize("backend", LINEAR)
def test_prefill_varlen_rows_match_unpadded_prefill(models, backend):
    """Each padded row's state and last logits are those of its prompt
    prefilled alone (within fp32 rounding: the chunking differs), and a
    lens = 0 row is a zero state, bit for bit."""
    _, tcfg, _, pt = models[backend]
    tokens, lens, _, (t_last, t_st) = _prefilled(models, backend,
                                                 lens=(8, 5, 0))
    for b in (0, 1):
        last, st = lm.prefill(pt, _t(tokens[b:b + 1, :lens[b]]).long(), tcfg)
        np.testing.assert_allclose(t_last[b:b + 1].numpy(), last.numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for (name, x), (_, y) in zip(_leaves(t_st), _leaves(st)):
            err = (x[:, b:b + 1] - y).abs().max().item()
            assert err <= STATE_TOL * max(1.0, y.abs().max().item()), name
    for name, x in _leaves(t_st):
        assert not x[:, 2].any(), name


def test_prefill_varlen_cache_rows_match_unpadded_prefill(models):
    """Softmax: each padded row's cache rows below its length and its
    last logits are those of its prompt prefilled alone (causality keeps
    the pad keys from valid queries); the rows past the bucket are the
    zeros ``pad_decode_state`` adds."""
    _, tcfg, _, pt = models["softmax"]
    tokens, lens, _, (t_last, t_st) = _prefilled(models, "softmax")
    for b in range(3):
        last, st = lm.prefill(pt, _t(tokens[b:b + 1, :lens[b]]).long(), tcfg)
        np.testing.assert_allclose(t_last[b:b + 1].numpy(), last.numpy(),
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        for (name, x), (_, y) in zip(_leaves(t_st), _leaves(st)):
            np.testing.assert_allclose(x[:, b:b + 1, :lens[b]].numpy(),
                                       y.numpy(), rtol=STATE_TOL,
                                       atol=STATE_TOL, err_msg=name)
    for name, x in _leaves(t_st):
        assert not x[:, :, 8:].any(), name


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_step_active_matches_jax(models, backend):
    jcfg, tcfg, pj, pt = models[backend]
    tokens, lens, (_, j_st), (_, t_st) = _prefilled(models, backend)
    tok = np.asarray([3, 7, 11], np.int32)
    active = np.asarray([True, False, True])
    j_lg, j_new = jlm.decode_step(pj, j_st, jnp.asarray(tok),
                                  jnp.asarray(lens), jcfg, RULES,
                                  active=jnp.asarray(active))
    before = _clone(t_st)
    t_lg, t_new = lm.decode_step(pt, t_st, _t(tok).long(), _t(lens), tcfg,
                                 active=_t(active))
    np.testing.assert_allclose(t_lg.numpy()[active],
                               np.asarray(j_lg)[active], rtol=LOGIT_TOL,
                               atol=LOGIT_TOL)
    _assert_state_close(t_new, j_new)
    _assert_rows_unchanged(t_new, before, [1])


@pytest.mark.parametrize("backend", BACKENDS)
def test_decode_step_active_rows_equal_unmasked_step(models, backend):
    """A masked step's active rows are bit for bit an unmasked step's
    (the lens-masked recurrence wraps the same arithmetic)."""
    _, tcfg, _, pt = models[backend]
    _, lens, _, (_, t_st) = _prefilled(models, backend)
    tok = torch.tensor([3, 7, 11])
    plain = _clone(t_st)
    lg_a, masked = lm.decode_step(pt, t_st, tok, _t(lens), tcfg,
                                  active=torch.tensor([True, False, True]))
    lg_p, plain = lm.decode_step(pt, plain, tok, _t(lens), tcfg)
    assert torch.equal(lg_a[[0, 2]], lg_p[[0, 2]])
    _assert_rows_unchanged(masked, plain, [0, 2])


@pytest.mark.parametrize("backend", BACKENDS)
def test_generate_segment_matches_jax(models, backend):
    jcfg, tcfg, pj, pt = models[backend]
    _, lens, (_, j_st), (_, t_st) = _prefilled(models, backend)
    tok = np.asarray([3, 7, 11], np.int32)
    active = np.asarray([True, False, True])
    remaining = np.asarray([2, 5, 6], np.int32)
    j_toks, j_carry = jlm.generate_segment(
        pj, j_st, jnp.asarray(tok), jnp.asarray(lens), jnp.asarray(active),
        jnp.asarray(remaining), 6, jcfg, RULES, pad_id=PAD_ID)
    before = _clone(t_st)
    t_toks, t_carry = lm.generate_segment(
        pt, t_st, _t(tok), _t(lens), _t(active), _t(remaining), 6, tcfg,
        pad_id=PAD_ID)
    np.testing.assert_array_equal(t_toks.numpy(), np.asarray(j_toks))
    for k in ("tok", "pos", "active", "remaining"):
        np.testing.assert_array_equal(t_carry[k].numpy(),
                                      np.asarray(j_carry[k]), err_msg=k)
    _assert_state_close(t_carry["state"], j_carry["state"])
    _assert_rows_unchanged(t_carry["state"], before, [1])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("program", ["ingest", "window"])
def test_varlen_windows_match_jax(models, backend, program):
    """``ingest_window_varlen`` (chunk-parallel) and
    ``decode_window_varlen`` (recurrent) continue the prefilled rows by
    per-row counts: logits at valid positions, the last-only logits and
    the states against JAX's; an inert row (lens 0) bit for bit."""
    jcfg, tcfg, pj, pt = models[backend]
    _, lens, (_, j_st), (_, t_st) = _prefilled(models, backend)
    rng = np.random.default_rng(2)
    window = rng.integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    w_lens = np.asarray([8, 3, 0], np.int32)
    j_fn = (jlm.ingest_window_varlen if program == "ingest"
            else jlm.decode_window_varlen)
    t_fn = (lm.ingest_window_varlen if program == "ingest"
            else lm.decode_window_varlen)
    j_lg, j_new = j_fn(pj, j_st, jnp.asarray(window), jnp.asarray(lens),
                       jnp.asarray(w_lens), jcfg, RULES)
    before = _clone(t_st)
    again = _clone(t_st)
    t_lg, t_new = t_fn(pt, t_st, _t(window).long(), _t(lens), _t(w_lens),
                       tcfg)
    last, _ = t_fn(pt, again, _t(window).long(), _t(lens), _t(w_lens), tcfg,
                   last_only=True)
    j_lg = np.asarray(j_lg)
    for b, n in enumerate(w_lens):
        np.testing.assert_allclose(t_lg[b, :n].numpy(), j_lg[b, :n],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
        np.testing.assert_allclose(last[b].numpy(), j_lg[b, max(n - 1, 0)],
                                   rtol=LOGIT_TOL, atol=LOGIT_TOL)
    _assert_state_close(t_new, j_new)
    _assert_rows_unchanged(t_new, before, [2])
    _assert_rows_unchanged(again, t_new, [0, 1, 2])


@pytest.mark.parametrize("backend", BACKENDS)
def test_slot_state_functions_match_jax(models, backend):
    """snapshot / restore / write_slot_state / where_state /
    slot_state_finite against JAX's on the same numbers (copies and
    selects: bitwise), the port writing in place and leaving every other
    slot bit for bit."""
    jcfg, tcfg, _, _ = models[backend]
    rng = np.random.default_rng(7)
    j_eng = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        jlm.init_decode_state(jcfg, 4, 16))
    j_new = jax.tree.map(lambda x: x + 1.0, j_eng)
    t_eng = convert.state_from_jax(_np_tree(j_eng))
    t_new = convert.state_from_jax(_np_tree(j_new))

    snap_j = jlm.snapshot_state(j_eng, 1)
    snap_t = lm.snapshot_state(t_eng, 1)
    _assert_state_close(snap_t, snap_j, tol=0)

    before = _clone(t_eng)
    out = lm.restore_state(t_eng, lm.snapshot_state(t_new, 3), 2)
    assert out is t_eng
    _assert_state_close(
        out, jlm.restore_state(j_eng, jlm.snapshot_state(j_new, 3), 2), tol=0)
    _assert_rows_unchanged(out, before, [0, 1, 3])
    out = lm.write_slot_state(t_eng, snap_t, 0)
    j_eng = jlm.write_slot_state(
        jlm.restore_state(j_eng, jlm.snapshot_state(j_new, 3), 2), snap_j, 0)
    _assert_state_close(out, j_eng, tol=0)

    mask = np.asarray([False, True, False, True])
    before = _clone(t_eng)
    out = lm.where_state(_t(mask), t_new, t_eng)
    assert out is t_eng
    _assert_state_close(out, jlm.where_state(jnp.asarray(mask), j_new,
                                             j_eng), tol=0)
    _assert_rows_unchanged(out, before, [0, 2])

    field = "k_cache" if backend == "softmax" else "s"
    getattr(t_eng["stack"][0], field)[1, 2, 0, 0, 0] = float("nan")
    j_bad = jax.tree.map(np.array, j_eng)        # writable copies
    getattr(j_bad["stack"][0], field)[1, 2, 0, 0, 0] = np.nan
    np.testing.assert_array_equal(
        lm.slot_state_finite(t_eng).numpy(),
        np.asarray(jlm.slot_state_finite(j_bad)))
    assert lm.slot_state_finite(t_eng).tolist() == [True, True, False, True]


@pytest.mark.parametrize("backend", BACKENDS)
def test_backend_matches_jax(models, backend):
    """The registry's choice, the capability flags, the resolved modes
    (ingest 'auto' is 'recurrent', as JAX resolves it off a TPU) and the
    bytes of one slot (from a state on the meta device): constant in
    max_len for the fixed-size state, growing with it for the KV
    cache."""
    jcfg, tcfg, _, _ = models[backend]
    be, jbe = backend_for_config(tcfg), jax_backend_for(jcfg)
    softmax = backend == "softmax"
    assert be.name == jbe.name == ("softmax_kv" if softmax
                                   else "fixed_state")
    assert be.fixed_size_state == jbe.fixed_size_state is not softmax
    assert be.supports_varlen_prefill == jbe.supports_varlen_prefill is True
    assert be.resolve_modes("auto", "auto") == ("batched", "recurrent")
    assert jbe.resolve_modes("auto", "auto") == ("batched", "recurrent")
    sizes = [be.state_bytes_per_slot(n) for n in (16, 4096)]
    assert sizes == [jbe.state_bytes_per_slot(n) for n in (16, 4096)]
    assert (sizes[1] == 256 * sizes[0]) if softmax else sizes[0] == sizes[1]


def test_softmax_backend_validates_its_config():
    from repro_torch.serving.backends import SoftmaxKVBackend
    _, tcfg = _configs("linear")
    with pytest.raises(ValueError, match="softmax"):
        SoftmaxKVBackend(tcfg)
    assert not SoftmaxKVBackend.handles(tcfg)


@pytest.mark.parametrize("decode_kernel,kernel", [("auto", True),
                                                  ("reference", False)])
def test_softmax_backend_prefills_by_decode_kernel(monkeypatch,
                                                   decode_kernel, kernel):
    """decode_kernel="reference" selects the softmax engine's reference
    route as it does the linear family's: both prefills ask for B10's
    plain version (attention_kernel=False); "auto" asks for B10."""
    from repro_torch.serving.backends import softmax_kv
    _, tcfg = _configs("softmax")
    seen = []
    monkeypatch.setattr(softmax_kv.lm, "prefill",
                        lambda *a, **kw: seen.append(kw))
    monkeypatch.setattr(softmax_kv.lm, "prefill_varlen",
                        lambda *a, **kw: seen.append(kw))
    be = softmax_kv.SoftmaxKVBackend(
        dataclasses.replace(tcfg, decode_kernel=decode_kernel))
    be.prefill(None, None)
    be.prefill_varlen(None, None, None)
    assert seen == [{"attention_kernel": kernel}] * 2


def test_modes_follow_the_capability():
    """Without varlen prefill, 'auto' admission is per request and
    'batched' is refused naming the capability; unknown modes raise."""
    _, tcfg = _configs("linear")

    class NoVarlen(DecodeBackend):
        name = "no_varlen"

        def _validate(self, cfg):
            self.supports_varlen_prefill = False

    be = NoVarlen(tcfg)
    assert be.resolve_modes("auto", "parallel") == ("per_request",
                                                    "parallel")
    with pytest.raises(ValueError, match="supports_varlen_prefill"):
        be.resolve_modes("batched", "auto")
    with pytest.raises(ValueError, match="admission"):
        be.resolve_modes("eager", "auto")
    with pytest.raises(ValueError, match="ingest"):
        be.resolve_modes("auto", "eager")


# ---------------------------------------------------------------------------
# the engine against JAX's
# ---------------------------------------------------------------------------

def _mixed_workload(vocab_size):
    """``tests/test_serving.py``'s mixed workload (prompts beyond the
    8-token chunk are ingested chunk by chunk) with a 1-token prompt
    added."""
    rng = np.random.default_rng(3)
    p_lens = [6, 8, 21, 5, 8, 40, 7, 8, 1]
    prompts = [rng.integers(0, vocab_size, size=pl,
                            dtype=np.int64).astype(np.int32)
               for pl in p_lens]
    return prompts, [5, 12, 3, 9, 6, 7, 4, 8, 6]


ENGINE_KW = dict(n_slots=2, segment_len=4, max_len=96, prefill_chunk=8)


def _run(engine, prompts, gens, arrivals=None):
    for i, (p, g) in enumerate(zip(prompts, gens)):
        engine.submit(p, g, arrival=0.0 if arrivals is None else arrivals[i])
    return engine.run("continuous"), engine.stats.to_dict()


@pytest.fixture(scope="module")
def jax_engine_runs(models):
    """JAX's engine on the mixed workload, computed on first use. Under
    per-request admission no ingest chunk runs, so JAX runs it once and
    both ingest settings of the port are held to that run."""
    cache = {}

    def get(backend, admission, ingest):
        key = (backend, admission,
               ingest if admission == "batched" else None)
        if key not in cache:
            jcfg, _, pj, _ = models[backend]
            prompts, gens = _mixed_workload(jcfg.vocab_size)
            cache[key] = _run(JaxEngine(pj, jcfg, admission=admission,
                                        ingest=ingest, **ENGINE_KW),
                              prompts, gens)
        return cache[key]
    return get


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("admission", ["batched", "per_request"])
@pytest.mark.parametrize("ingest", ["recurrent", "parallel"])
def test_engine_matches_jax_engine(models, jax_engine_runs, backend,
                                   admission, ingest):
    _, tcfg, _, pt = models[backend]
    j_comps, j_stats = jax_engine_runs(backend, admission, ingest)
    prompts, gens = _mixed_workload(tcfg.vocab_size)
    eng = DecodeEngine(pt, tcfg, admission=admission, ingest=ingest,
                       **ENGINE_KW)
    t_comps, t_stats = _run(eng, prompts, gens)
    assert len(t_comps) == len(j_comps) == len(prompts)
    for a, b in zip(t_comps, j_comps):
        assert (a.uid, a.prompt_len, a.finish_reason, a.admitted_step,
                a.finished_step) == (b.uid, b.prompt_len, b.finish_reason,
                                     b.admitted_step, b.finished_step)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for k in CORE_STATS:
        assert t_stats[k] == j_stats[k], k
    if admission == "batched":
        assert t_stats["ingest_chunks"] > 0 and t_stats["interleave_ratio"] > 0


# ---------------------------------------------------------------------------
# the JAX engine tests, within torch
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def smoke():
    """Per backend: the smoke config in its own dtype (bf16) and params."""
    out = {}
    for backend in BACKENDS:
        cfg = get_smoke_config("qwen3-0.6b").with_backend(backend)
        out[backend] = (cfg, lm.init_params(torch.Generator().manual_seed(0),
                                            cfg))
    return out


def _standalone(params, cfg, prompt, gen_len, eos_id=None):
    """The request running alone (prefill, greedy generate), truncated at
    the first EOS as the engine truncates."""
    logits, st = lm.prefill(params, _t(prompt).long()[None], cfg)
    st = lm.pad_decode_state(st, cfg, len(prompt) + gen_len)
    tok0 = int(torch.argmax(logits, -1)[0])
    toks = [tok0]
    if gen_len > 1 and not (eos_id is not None and tok0 == eos_id):
        more, _ = lm.generate(params, st, torch.tensor([tok0]), len(prompt),
                              gen_len - 1, cfg)
        toks += more[0].tolist()
    if eos_id is not None and eos_id in toks:
        toks = toks[:toks.index(eos_id) + 1]
    return toks


def _workload(cfg, n=6, prompt_len=8, seed=0):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size, size=prompt_len,
                            dtype=np.int64).astype(np.int32)
               for _ in range(n)]
    return prompts, [5, 12, 3, 9, 1, 7][:n]


def _engine(cfg, params, **kw):
    return DecodeEngine(params, cfg, **{**dict(n_slots=2, segment_len=4,
                                               max_len=64), **kw})


@pytest.mark.parametrize("backend", BACKENDS)
def test_engine_matches_standalone(smoke, backend):
    cfg, params = smoke[backend]
    prompts, gens = _workload(cfg)
    refs = [_standalone(params, cfg, p, g) for p, g in zip(prompts, gens)]
    eng = _engine(cfg, params)
    comps, st = _run(eng, prompts, gens)
    assert len(comps) == len(refs)
    for c, ref in zip(comps, refs):
        np.testing.assert_array_equal(c.tokens, np.asarray(ref))
        assert c.finish_reason == "length"
    assert st["prefills"] == len(refs)
    assert 0.0 < st["slot_utilization"] < 1.0


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ingest", ["recurrent", "parallel"])
def test_mixed_workload_matches_standalone(models, backend, ingest):
    """fp32: every request of the mixed workload (chunked ingest, a
    1-token prompt) gives its run-alone tokens."""
    _, tcfg, _, pt = models[backend]
    prompts, gens = _mixed_workload(tcfg.vocab_size)
    comps, _ = _run(DecodeEngine(pt, tcfg, ingest=ingest, **ENGINE_KW),
                    prompts, gens)
    for c, p, g in zip(comps, prompts, gens):
        np.testing.assert_array_equal(c.tokens,
                                      np.asarray(_standalone(pt, tcfg, p, g)))


def test_static_policy_same_outputs(smoke):
    cfg, params = smoke["linear"]
    prompts, gens = _workload(cfg)
    eng = _engine(cfg, params)
    outs, segments = {}, {}
    for policy in ("continuous", "static"):
        eng.reset()
        for p, g in zip(prompts, gens):
            eng.submit(p, g)
        outs[policy] = eng.run(policy)
        segments[policy] = eng.stats.segments
    for a, b in zip(outs["continuous"], outs["static"]):
        np.testing.assert_array_equal(a.tokens, b.tokens)
    # the batch-synchronous policy waits for the longest request
    assert segments["static"] > segments["continuous"] > 0
    with pytest.raises(ValueError, match="policy"):
        eng.step("eager")


def test_staggered_arrivals(smoke):
    """Arrival times delay admission but never change outputs."""
    cfg, params = smoke["linear"]
    prompts, gens = _workload(cfg, n=4)
    refs = [_standalone(params, cfg, p, g) for p, g in zip(prompts, gens)]
    comps, _ = _run(_engine(cfg, params), prompts, gens,
                    arrivals=[6.0 * i for i in range(4)])
    for c, ref in zip(comps, refs):
        np.testing.assert_array_equal(c.tokens, np.asarray(ref))


@pytest.mark.parametrize("admission", ["batched", "per_request"])
def test_eos_stops_slot_midsegment(smoke, admission):
    """A slot emitting EOS frees itself inside the segment; the output
    is truncated at (and includes) the EOS token."""
    cfg, params = smoke["linear"]
    prompts, _ = _workload(cfg, n=3)
    gens = [12, 12, 12]
    plain = [_standalone(params, cfg, p, g) for p, g in zip(prompts, gens)]
    eos_id = next(t for toks in plain for t in toks[1:-1])
    refs = [_standalone(params, cfg, p, g, eos_id=eos_id)
            for p, g in zip(prompts, gens)]
    assert any(len(r) < g for r, g in zip(refs, gens))
    comps, _ = _run(_engine(cfg, params, eos_id=eos_id, admission=admission),
                    prompts, gens)
    for c, ref in zip(comps, refs):
        np.testing.assert_array_equal(c.tokens, np.asarray(ref))
        assert c.finish_reason == ("eos" if ref[-1] == eos_id else "length")


@pytest.mark.parametrize("admission", ["batched", "per_request"])
def test_instant_completions_dont_waste_slots(smoke, admission):
    """Requests completing at admission (a budget of one token) do not
    take a slot's turn, and the clock never skips past admissible
    work."""
    cfg, params = smoke["linear"]
    prompts, _ = _workload(cfg, n=4)
    comps, _ = _run(_engine(cfg, params, n_slots=1, admission=admission),
                    prompts, [1, 1, 1, 5])
    assert len(comps) == 4
    assert comps[3].admitted_step == 0


def test_out_of_order_arrivals_not_blocked(smoke):
    cfg, params = smoke["linear"]
    prompts, _ = _workload(cfg, n=2)
    eng = _engine(cfg, params)
    late = eng.submit(prompts[0], 5, arrival=100.0)
    early = eng.submit(prompts[1], 5, arrival=0.0)
    comps = {c.uid: c for c in eng.run("continuous")}
    assert comps[early].admitted_step == 0
    assert comps[late].admitted_step >= 100


def test_gen_len_one_completes_at_admission(smoke):
    cfg, params = smoke["linear"]
    prompts, _ = _workload(cfg, n=2)
    eng = _engine(cfg, params)
    comps, st = _run(eng, prompts, [1, 1])
    assert [len(c.tokens) for c in comps] == [1, 1]
    assert st["segments"] == 0
    for c, p in zip(comps, prompts):
        np.testing.assert_array_equal(c.tokens,
                                      np.asarray(_standalone(params, cfg,
                                                             p, 1)))


def test_submit_validates_before_touching_the_engine(smoke):
    cfg, params = smoke["linear"]
    eng = _engine(cfg, params)
    eng.submit([1, 2, 3], 4, uid=5)
    bad = [dict(prompt=[1], max_new_tokens=0),
           dict(prompt=[1], max_new_tokens=2, uid=3),
           dict(prompt=[], max_new_tokens=2),
           dict(prompt=list(range(60)), max_new_tokens=6)]
    for kw in bad:
        with pytest.raises(ValueError):
            eng.submit(**kw)
    assert eng.queue_depth() == 1 and eng.submit([4], 2) == 6


def test_temperature_sampling_is_seeded(smoke):
    cfg, params = smoke["gated_linear"]
    prompts, gens = _workload(cfg, n=4)
    runs = []
    for seed in (5, 5, 6):
        comps, _ = _run(_engine(cfg, params, temperature=0.8, seed=seed),
                        prompts, gens)
        runs.append([c.tokens.tolist() for c in comps])
    assert runs[0] == runs[1] != runs[2]
    assert [len(t) for t in runs[0]] == gens[:4]


class TestGenerateSegment:
    """The slot-masked segment on its own."""

    def test_inactive_slots_frozen(self, smoke):
        """Masked slots emit PAD_ID and their state, pos and tok stay bit
        for bit through the segment."""
        cfg, params = smoke["linear"]
        state = lm.init_decode_state(cfg, 2, max_len=16)
        for _, x in _leaves(state):
            x.normal_(generator=torch.Generator().manual_seed(1))
        before = _clone(state)
        toks, carry = lm.generate_segment(
            params, state, torch.tensor([3, 7]), torch.tensor([0, 5]),
            torch.tensor([True, False]), torch.tensor([8, 8]), 4, cfg)
        assert toks.shape == (2, 4)
        assert (toks[1] == PAD_ID).all() and (toks[0] != PAD_ID).all()
        assert int(carry["pos"][1]) == 5 and int(carry["tok"][1]) == 7
        _assert_rows_unchanged(carry["state"], before, [1])

    def test_budget_stops_inside_segment(self, smoke):
        cfg, params = smoke["linear"]
        state = lm.init_decode_state(cfg, 2, max_len=16)
        toks, carry = lm.generate_segment(
            params, state, torch.zeros(2, dtype=torch.long),
            torch.zeros(2, dtype=torch.int32), torch.tensor([True, True]),
            torch.tensor([2, 6]), 6, cfg)
        row0 = toks[0].numpy()
        assert (row0 != PAD_ID).sum() == 2
        assert (row0[2:] == PAD_ID).all()
        assert not bool(carry["active"][0]) and not bool(carry["active"][1])
        assert int(carry["pos"][0]) == 2

    def test_write_slot_state_roundtrip(self, smoke):
        """write_slot_state targets exactly one slot of every leaf."""
        cfg, _ = smoke["gated_linear"]
        engine_state = lm.init_decode_state(cfg, 3, max_len=8)
        req = lm.init_decode_state(cfg, 1, max_len=8)
        for _, x in _leaves(req):
            x.fill_(1.0)
        out = lm.write_slot_state(engine_state, req, 1)
        for _, leaf in _leaves(out):
            assert (leaf[:, 1] == 1).all()
            assert not leaf[:, 0].any() and not leaf[:, 2].any()


class TestBatchedAdmission:
    """Bucket-padded varlen prefill waves and chunked ingest leave every
    request's tokens as the per-request path gives them."""

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_batched_equals_per_request(self, models, backend):
        _, tcfg, _, pt = models[backend]
        prompts, gens = _mixed_workload(tcfg.vocab_size)
        outs = {}
        for adm in ("per_request", "batched"):
            eng = DecodeEngine(pt, tcfg, admission=adm, **ENGINE_KW)
            outs[adm], st = _run(eng, prompts, gens)
            if adm == "batched":
                assert st["admission_batches"] > 0
                assert st["ingest_chunks"] > 0
                assert st["interleave_ratio"] > 0.0
                assert st["prefills"] == len(prompts)
        for a, b in zip(outs["per_request"], outs["batched"]):
            assert a.uid == b.uid and a.finish_reason == b.finish_reason
            np.testing.assert_array_equal(a.tokens, b.tokens)

    def test_uniform_prompts_bit_identical_bf16(self, smoke):
        """Bucket-width prompts (no row padding) keep the run-alone
        tokens in bf16 too."""
        cfg, params = smoke["linear"]
        prompts, gens = _workload(cfg)
        refs = [_standalone(params, cfg, p, g) for p, g in zip(prompts, gens)]
        comps, _ = _run(_engine(cfg, params, admission="batched"), prompts,
                        gens)
        for c, ref in zip(comps, refs):
            np.testing.assert_array_equal(c.tokens, np.asarray(ref))

    def test_admission_order_deterministic(self, models):
        """Same submissions, same slots, steps and tokens, run after run;
        equal arrivals are admitted in uid order."""
        _, tcfg, _, pt = models["linear"]
        prompts, gens = _mixed_workload(tcfg.vocab_size)
        eng = DecodeEngine(pt, tcfg, admission="batched", **ENGINE_KW)

        def go():
            eng.reset()
            for i, (p, g) in enumerate(zip(prompts, gens)):
                eng.submit(p, g, arrival=2.0 * (i // 3))
            return eng.run("continuous")

        a, b = go(), go()
        for x, y in zip(a, b):
            assert (x.uid, x.admitted_step, x.finished_step) == \
                (y.uid, y.admitted_step, y.finished_step)
            np.testing.assert_array_equal(x.tokens, y.tokens)
        for x, y in zip(a, a[1:]):
            if x.admitted_step == y.admitted_step:
                assert x.uid < y.uid

    @pytest.mark.parametrize("backend", BACKENDS)
    def test_length_one_prompt_bit_identical(self, smoke, backend):
        """A 1-token prompt in a wider wave is encoded unpadded at batch
        1, so batched admission gives the per-request tokens in bf16."""
        cfg, params = smoke[backend]
        rng = np.random.default_rng(5)
        prompts = [rng.integers(0, cfg.vocab_size, size=pl,
                                dtype=np.int64).astype(np.int32)
                   for pl in (1, 8, 8, 1)]
        gens = [6, 9, 4, 7]
        outs = {adm: _run(_engine(cfg, params, admission=adm), prompts,
                          gens)[0]
                for adm in ("per_request", "batched")}
        for a, b in zip(outs["per_request"], outs["batched"]):
            np.testing.assert_array_equal(a.tokens, b.tokens)

    def test_instant_completions_batched(self, smoke):
        cfg, params = smoke["linear"]
        prompts, _ = _workload(cfg, n=4)
        comps, _ = _run(_engine(cfg, params, n_slots=1, admission="batched"),
                        prompts, [1, 1, 1, 5])
        assert len(comps) == 4
        assert comps[3].admitted_step == 0

    @pytest.mark.parametrize("backend", ["gated_linear", "softmax"])
    def test_wave_lands_only_its_rows(self, models, backend):
        """Landing a wave copies its rows into the engine state; a live
        slot's state (under softmax its whole max_len cache) stays bit
        for bit."""
        _, tcfg, _, pt = models[backend]
        eng = DecodeEngine(pt, tcfg, n_slots=3, segment_len=4, max_len=96,
                           prefill_chunk=8)
        prompts, _ = _mixed_workload(tcfg.vocab_size)
        eng.submit(prompts[0], 20)
        eng.step()                            # slot 0 live, decoding
        live = _clone(eng.state)
        eng.submit(prompts[1], 3)
        eng.submit(prompts[3], 3)
        eng._admit_pass("continuous")         # one wave into slots 1, 2
        assert eng.stats.admission_batches == 2
        _assert_rows_unchanged(eng.state, live, [0])


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_stream_smoke(backend, tmp_path):
    """``serve --mode stream --smoke --device cpu``: every request of the
    mix completes with its budget of tokens."""
    path = tmp_path / "stats.json"
    args = serve.parse_args([
        "--mode", "stream", "--smoke", "--device", "cpu", "--backend",
        backend, "--slots", "3", "--segment-len", "4", "--n-requests", "7",
        "--arrival-rate", "0.4", "--prompt-len", "20", "--gen-len", "12",
        "--prefill-chunk", "8", "--stats-json", str(path)])
    out = serve.stream(args)
    mix = serve.make_request_mix(np.random.default_rng(0), 7, 20, 12,
                                 get_smoke_config("qwen3-0.6b").vocab_size,
                                 0.4)
    assert [len(c.tokens) for c in out["completions"]] == \
        [g for _, g, _ in mix]
    assert out["stats"]["ingest_chunks"] > 0
    assert out["mean_latency_steps"] > 0 and out["tokens_per_s"] > 0
    assert path.read_text().startswith("{")


def test_request_mix_matches_jax():
    from repro.launch.serve import make_request_mix as jax_mix
    a = serve.make_request_mix(np.random.default_rng(4), 9, 12, 16, 256, 0.3)
    b = jax_mix(np.random.default_rng(4), 9, 12, 16, 256, 0.3)
    for (pa, ga, ta), (pb, gb, tb) in zip(a, b):
        np.testing.assert_array_equal(pa, pb)
        assert (ga, ta) == (gb, tb)


def test_landing_short_caches_matches_jax_padding(models):
    """A softmax prefill's caches (8 rows) land in the engine's 16-row
    caches as JAX lands them: ``pad_decode_state`` (zeros) then
    ``where_state`` for a wave, ``restore_state`` for one slot; bitwise,
    every other slot untouched, the landed slots' old rows past 8
    zeroed."""
    jcfg, tcfg, pj, pt = models["softmax"]
    rng = np.random.default_rng(8)
    j_eng = jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype),
        jlm.init_decode_state(jcfg, 3, 16))
    t_eng = convert.state_from_jax(_np_tree(j_eng))
    tokens = rng.integers(0, jcfg.vocab_size, (3, 8)).astype(np.int32)
    lens = np.asarray([8, 3, 6], np.int32)
    _, j_new = jlm.prefill_varlen(pj, jnp.asarray(tokens), jnp.asarray(lens),
                                  jcfg, RULES)
    t_new = convert.state_from_jax(_np_tree(j_new))    # the same numbers
    mask = np.asarray([True, False, True])
    before = _clone(t_eng)
    lm.where_state(_t(mask), t_new, t_eng)
    j_eng = jlm.where_state(jnp.asarray(mask),
                            jlm.pad_decode_state(j_new, jcfg, 16), j_eng)
    _assert_state_close(t_eng, j_eng, tol=0)
    _assert_rows_unchanged(t_eng, before, [1])
    one = lm.snapshot_state(t_new, 1)
    lm.restore_state(t_eng, {p: tuple(A.AttnState(
        *(None if x is None else x[:, :, :5] for x in st)) for st in g)
        for p, g in one.items()}, 1)
    j_one = jlm.pad_decode_state(jax.tree.map(
        lambda x: x[:, :, :5], jlm.snapshot_state(j_new, 1)), jcfg, 16)
    _assert_state_close(t_eng, jlm.restore_state(j_eng, j_one, 1), tol=0)


@pytest.mark.parametrize("admission,ones,want", [("batched", 0, 2 * 3),
                                                 ("batched", 2, 2 * 5),
                                                 ("per_request", 0, 2 * 7)])
def test_stream_launch_formula_under_softmax(admission, ones, want):
    """B10 runs once per layer and prefill pass: each batched wave and
    each 1-token prompt that batched admission encodes alone, or each
    per-request prefill."""
    _, tcfg = _configs("softmax")
    stats = {"prefill_dispatches": 3, "prefills": 7, "segments": 9,
             "segment_len": 4, "ingest_chunks": 5}
    assert tcfg.n_layers == 2
    assert serve.stream_launches(tcfg, stats, "recurrent", admission,
                                 ones) == want


def test_serve_retrieve_smoke():
    """``serve --mode retrieve --device cpu``: the store holds one k×k
    state per document (JAX's sizes), and the last wave's answers are
    Hᵀ(Hq) of each document's hidden states."""
    args = serve.parse_args(["--mode", "retrieve", "--device", "cpu",
                             "--batch", "6"])
    out = serve.retrieve(args)
    assert len(out["store"]) == 6 and out["iters"] == 100
    assert out["store_mib"] * 2**20 == 6 * 100 * 100 * 4
    assert out["raw_mib"] * 2**20 == 6 * 750 * 100 * 4
    h, q = out["h"].double(), out["queries"].double()
    want = torch.einsum("bnk,bn->bk", h, torch.einsum("bnk,bk->bn", h, q))
    torch.testing.assert_close(out["answers"].double(), want, rtol=1e-5,
                               atol=1e-3)
    assert out["queries_per_s"] > 0


# ---------------------------------------------------------------------------
# the MoE config through the engine; the cross config refused
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("admission", ["batched", "per_request"])
def test_moe_engine_matches_jax_engine(backend, admission):
    """deepseek-moe-16b's smoke config (fp32) through both engines on the
    mixed workload: completions token for token and the core stats equal.
    Every slot, empty or not, routes through the experts and shares
    their capacity, in both packages alike."""
    kw = dict(attention_backend=backend, dtype="float32")
    jcfg = dataclasses.replace(jax_smoke_config("deepseek-moe-16b"), **kw)
    tcfg = dataclasses.replace(get_smoke_config("deepseek-moe-16b"), **kw)
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pt = convert.params_from_jax(_np_tree(pj), tcfg)
    prompts, gens = _mixed_workload(jcfg.vocab_size)
    j_comps, j_stats = _run(JaxEngine(pj, jcfg, admission=admission,
                                      **ENGINE_KW), prompts, gens)
    t_comps, t_stats = _run(DecodeEngine(pt, tcfg, admission=admission,
                                         **ENGINE_KW), prompts, gens)
    assert len(t_comps) == len(j_comps) == len(prompts)
    for a, b in zip(t_comps, j_comps):
        assert (a.uid, a.finish_reason, a.admitted_step, a.finished_step) \
            == (b.uid, b.finish_reason, b.admitted_step, b.finished_step)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for k in CORE_STATS:
        assert t_stats[k] == j_stats[k], k


@pytest.mark.parametrize("backend", BACKENDS)
def test_cross_config_refused_by_the_engine(backend):
    """A config with cross blocks needs a memory, which the engine has no
    path to pass (JAX's admission passes none either): the backend
    registry and ``serve --mode stream`` refuse it, naming the memory."""
    cfg = get_smoke_config("llama-3.2-vision-90b").with_backend(backend)
    with pytest.raises(ValueError, match="memory"):
        backend_for_config(cfg)
    args = serve.parse_args(["--mode", "stream", "--smoke", "--device",
                             "cpu", "--arch", "llama-3.2-vision-90b",
                             "--backend", backend])
    with pytest.raises(ValueError, match="memory"):
        serve.stream(args)


def test_serve_stream_moe_smoke():
    """``serve --mode stream --arch deepseek-moe-16b --smoke``: every
    request completes with its budget of tokens."""
    args = serve.parse_args([
        "--mode", "stream", "--smoke", "--device", "cpu", "--arch",
        "deepseek-moe-16b", "--slots", "3", "--segment-len", "4",
        "--n-requests", "5", "--prompt-len", "20", "--gen-len", "8",
        "--prefill-chunk", "8"])
    out = serve.stream(args)
    mix = serve.make_request_mix(np.random.default_rng(0), 5, 20, 8, 256,
                                 0.0)
    assert [len(c.tokens) for c in out["completions"]] == \
        [g for _, g, _ in mix]
    assert out["stats"]["ingest_chunks"] > 0
