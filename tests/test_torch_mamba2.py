"""zamba2-7b, the Mamba-2 + shared-attention hybrid, against the JAX
package on the CPU, in fp32, parameters from JAX through
``convert.params_from_jax``:

* ``causal_conv1d`` with and without a cache;
* ``mamba2_apply`` in both forms (the prefill through ``ssd_attention``'s
  plain route, with its state; the training form through
  ``gated_linear_attention``) and ``mamba2_decode``, within 1e-5;
* the smoke LM under linear, gated_linear and softmax: prefill logits and
  every state leaf, 8 greedy steps (tokens identical, logits within
  1e-4), a masked decode window, and the loss and every gradient leaf
  (the shared attention's included) of one training step;
* a 128-token prompt at ``linear_chunk=128``: JAX's chunk of 128 gives
  non-finite logits, the port's 64-token prefill chunk stays finite and
  matches JAX at chunk 64;
* the ``DecodeEngine`` against JAX's under linear and softmax, and
  ``backend_for_config`` against JAX's for zamba2 and a pure-Mamba stack;
* the conversion both ways, and the serving and training entry points.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLMDataset
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.models import mamba2 as jmamba
from repro.serving import DecodeEngine as JaxEngine
from repro.serving import backend_for_config as jax_backend_for_config
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.launch import serve
from repro_torch.launch import train as ttrain
from repro_torch.models import layers as tlayers
from repro_torch.models import lm as tlm
from repro_torch.models import mamba2 as tmamba
from repro_torch.optim import GradAccumulator
from repro_torch.serving import DecodeEngine, backend_for_config
from repro_torch.serving.backends.mamba2 import Mamba2Backend
from repro_torch.tree import leaves

RULES = Rules.null()
TOL = 1e-4
B, T, STEPS = 2, 20, 8           # T: not a multiple of linear_chunk (16)
ARCH = "zamba2-7b"
BACKENDS = ("linear", "gated_linear", "softmax")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _perturbed(pj, seed):
    """JAX's parameters with the vectors moved off their init values (the
    norms' 1, dt_bias 0, d_skip 1; a_log by a little), where a dropped or
    swapped leaf shows nothing."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if any(k in ("scale", "norm_scale", "dt_bias", "d_skip", "a_log",
                     "b_gate", "gn_scale", "gn_bias") for k in keys):
            return x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, pj)


def _models(backend="linear", seed=0, **kw):
    kw = dict(dtype="float32", **kw)
    jcfg = dataclasses.replace(jax_smoke_config(ARCH).with_backend(backend),
                               **kw)
    tcfg = dataclasses.replace(get_smoke_config(ARCH).with_backend(backend),
                               **kw)
    pj = _perturbed(jlm.init_params(jax.random.PRNGKey(seed), jcfg),
                    seed + 100)
    return jcfg, tcfg, pj, convert.params_from_jax(_np(pj), tcfg)


def _close(t, j, tol=TOL, what=""):
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    assert t.shape == j.shape, (what, t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=tol,
                               atol=tol * max(1.0, np.abs(j).max()),
                               err_msg=what)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


# -- the conv and the Mamba-2 block -------------------------------------------

@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_jax(with_cache):
    """y and the new cache (the last K−1 inputs), from zeros or a given
    cache, at T shorter and longer than K."""
    for t in (2, 9):
        x, w = _x(1, 2, t, 6), _x(2, 4, 6)
        cache = _x(3, 2, 3, 6) if with_cache else None
        y_j, c_j = jlayers.causal_conv1d(
            jnp.asarray(x), jnp.asarray(w),
            None if cache is None else jnp.asarray(cache))
        y_t, c_t = tlayers.causal_conv1d(
            torch.from_numpy(x), torch.from_numpy(w),
            None if cache is None else torch.from_numpy(cache))
        _close(y_t, y_j, 1e-6, "y")
        _close(c_t, c_j, 0.0, "cache")


def _layer0(pj, pt):
    return (jax.tree.map(lambda a: a[0], pj["stack"][0]["mamba"]),
            tlm._at(pt["stack"][0], 0)["mamba"])


def test_mamba2_apply_and_decode_match_jax():
    """Layer 0's Mamba-2: the prefill form (output and state), the
    training form, then two decode steps from the prefill's state, the
    second with one slot inactive (its state bit for bit): within 1e-5."""
    jcfg, tcfg, pj, pt = _models(seed=1)
    pj0, pt0 = _layer0(pj, pt)
    x = _x(4, B, T, jcfg.d_model)
    y_j, st_j = jax.jit(lambda p, a: jmamba.mamba2_apply(
        p, a, jcfg, RULES, want_state=True))(pj0, jnp.asarray(x))
    y_t, st_t = tmamba.mamba2_apply(pt0, torch.from_numpy(x), tcfg,
                                    want_state=True)
    assert isinstance(st_t, tmamba.MambaState)
    _close(y_t, y_j, 1e-5, "prefill")
    _close(st_t.conv, st_j.conv, 1e-5, "conv")
    _close(st_t.ssd, st_j.ssd, 1e-5, "ssd")
    y_j2, _ = jax.jit(lambda p, a: jmamba.mamba2_apply(
        p, a, jcfg, RULES))(pj0, jnp.asarray(x))
    y_t2, none = tmamba.mamba2_apply(pt0, torch.from_numpy(x), tcfg)
    assert none is None
    _close(y_t2, y_j2, 1e-5, "training form")
    for step, active in enumerate((None, np.array([True, False]))):
        xt = _x(5 + step, B, jcfg.d_model)
        before = [a.clone() for a in st_t]
        y_j, st_j = jax.jit(lambda p, a, st: jmamba.mamba2_decode(
            p, a, st, jcfg, RULES))(pj0, jnp.asarray(xt), st_j)
        y_t, st_t = tmamba.mamba2_decode(
            pt0, torch.from_numpy(xt), st_t, tcfg,
            active=None if active is None else torch.from_numpy(active))
        if active is None:
            _close(y_t, y_j, 1e-5, f"decode {step}")
            for a, j in zip(st_t, st_j):
                _close(a, j, 1e-5, f"decode state {step}")
        else:
            _close(y_t[0], y_j[0], 1e-5, "decode, active row")
            for a, j, old in zip(st_t, st_j, before):
                _close(a[0], j[0], 1e-5, "decode state, active row")
                assert torch.equal(a[1], old[1])


# -- the LM --------------------------------------------------------------------

def _jit_prefill(jcfg):
    return jax.jit(lambda p, toks: jlm.prefill(p, toks, jcfg, RULES))


@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_prefill_generate_and_window_match_jax(backend):
    """Prefill (last logits, every layer's state), 8 greedy steps (logits
    within 1e-4 at every step, tokens identical), then a decode window
    with per-row lengths 3 and 0 against JAX's ``decode_window_varlen``
    (the masked row's state bit for bit)."""
    jcfg, tcfg, pj, pt = _models(backend, seed=2)
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    j_logits, j_st = _jit_prefill(jcfg)(pj, jnp.asarray(prompt))
    t_logits, t_st = tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)
    _close(t_logits, j_logits, what="prefill logits")
    for t, j in zip([x for part in ("stack", "tail") for st in t_st[part]
                     for x in st if x is not None],
                    jax.tree.leaves(_np(j_st)), strict=True):
        _close(t, j, what="prefill state")
    max_len = T + STEPS + 4
    j_st = jlm.pad_decode_state(j_st, jcfg, max_len) \
        if backend == "softmax" else j_st
    t_st = tlm.pad_decode_state(t_st, tcfg, max_len)
    j_decode = jax.jit(lambda p, st, tok, pos: jlm.decode_step(
        p, st, tok, pos, jcfg, RULES))
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    for i in range(STEPS):
        j_lg, j_st = j_decode(pj, j_st, j_tok, jnp.int32(T + i))
        t_lg, t_st = tlm.decode_step(pt, t_st, t_tok, T + i, tcfg)
        _close(t_lg, j_lg, what=f"step {i}")
        j_tok = jnp.argmax(j_lg, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_lg, -1)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"step {i}")
    toks = prompt[:, :3]
    pos = T + STEPS
    j_lg, j_st = jax.jit(lambda p, st, tk: jlm.decode_window_varlen(
        p, st, tk, jnp.int32(pos), jnp.asarray([3, 0], jnp.int32), jcfg,
        RULES))(pj, j_st, jnp.asarray(toks))
    before = [x.clone() for x, _ in tlm._slot_leaves(t_st)]
    t_lg, t_st = tlm.decode_window_varlen(pt, t_st, torch.from_numpy(toks),
                                          pos, [3, 0], tcfg)
    _close(t_lg[0], j_lg[0], what="window logits")
    for (x, axis), old in zip(tlm._slot_leaves(t_st), before):
        assert torch.equal(x.narrow(axis, 1, 1), old.narrow(axis, 1, 1))


def test_loss_and_gradients_match_jax():
    """``lm_loss`` and every gradient leaf (the shared attention's
    included) against ``jax.value_and_grad`` (T = 24): loss within 1e-5
    relative, leaves within 1e-4 normwise."""
    jcfg, tcfg, pj, pt = _models("linear", seed=3)
    batch = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=24,
                               global_batch=B, seed=0).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, RULES), has_aux=True))(pj)
    t_loss, _, t_grads = GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), pt,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    assert set(t_grads["shared"]) == set(grads["shared"]) >= {"attn", "mlp"}
    t_leaves, j_leaves = leaves(t_grads), jax.tree.leaves(_np(grads))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_long_prompt_prefill_stays_finite_where_jax_chunk_128_does_not():
    """At ``linear_chunk=128`` and a 128-token prompt, JAX's SSD prefill
    (``chunked_gla`` at chunk 128) scales keys by exp(−b) with b down to
    −127 (most heads' decays sit at the clamp, −1 a token) and its logits
    are non-finite; the port prefills in chunks of at most
    ``PREFILL_CHUNK`` (64), stays finite, and matches JAX's prefill at
    ``linear_chunk=64`` within 1e-4."""
    jcfg, tcfg, pj, pt = _models(seed=4, linear_chunk=128)
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, 128)).astype(np.int32)
    j_bad, _ = _jit_prefill(jcfg)(pj, jnp.asarray(prompt))
    assert not np.isfinite(np.asarray(j_bad)).any()
    j64 = dataclasses.replace(jcfg, linear_chunk=tmamba.PREFILL_CHUNK)
    j_logits, j_st = _jit_prefill(j64)(pj, jnp.asarray(prompt))
    t_logits, t_st = tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)
    assert torch.isfinite(t_logits).all()
    _close(t_logits, j_logits, what="prefill logits")
    _close(t_st["tail"][0].ssd, j_st["tail"][0].ssd, what="ssd state")


# -- conversion, backends and the engine ---------------------------------------

def test_convert_round_trip():
    """JAX's parameter tree (the ``shared`` set included) and a JAX decode
    state after a prefill into the port's and back to numpy: every leaf
    equal, in JAX's order and shape; the port's own init has the same
    tree."""
    jcfg, tcfg, pj, pt = _models(seed=5)
    assert set(pt["shared"]) == {"norm1", "norm2", "attn", "mlp"}
    assert pt["stack"][2] == {}
    j_leaves = jax.tree.leaves(_np(pj))
    t_leaves = leaves(pt)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        np.testing.assert_array_equal(t.numpy(), j)
    own = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    assert [tuple(x.shape) for x in leaves(own)] == [x.shape for x in
                                                     j_leaves]
    prompt = np.arange(2 * 9, dtype=np.int32).reshape(2, 9) % 256
    _, j_st = _jit_prefill(jcfg)(pj, jnp.asarray(prompt))
    t_st = convert.state_from_jax(_np(j_st))
    assert isinstance(t_st["stack"][0], tmamba.MambaState)
    t_leaves = [x for part in ("stack", "tail") for st in t_st[part]
                for x in st if x is not None]
    for t, j in zip(t_leaves, jax.tree.leaves(_np(j_st)), strict=True):
        np.testing.assert_array_equal(t.numpy(), j)


def _pure_mamba(cfg):
    return dataclasses.replace(cfg, name="mamba-only", n_layers=3,
                               layer_pattern=("mamba",), n_repeats=0,
                               tail=())


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("pure", [False, True])
def test_backend_for_config_matches_jax(backend, pure):
    """The backend that claims zamba2 (the attention family's, as in JAX)
    and a pure-Mamba stack (``Mamba2Backend``): the same name, modes,
    capabilities and bytes per slot as JAX's."""
    jcfg = jax_smoke_config(ARCH).with_backend(backend)
    tcfg = get_smoke_config(ARCH).with_backend(backend)
    if pure:
        jcfg, tcfg = _pure_mamba(jcfg), _pure_mamba(tcfg)
    j, t = jax_backend_for_config(jcfg), backend_for_config(tcfg)
    assert t.name == j.name
    assert t.name == ("mamba2" if pure else "softmax_kv"
                      if backend == "softmax" else "fixed_state")
    assert isinstance(t, Mamba2Backend) == pure
    assert t.fixed_size_state == j.fixed_size_state
    assert t.supports_varlen_prefill == j.supports_varlen_prefill is False
    assert t.resolve_modes("auto", "recurrent") == \
        j.resolve_modes("auto", "recurrent") == ("per_request", "recurrent")
    for max_len in (16, 64):
        assert t.state_bytes_per_slot(max_len) == \
            j.state_bytes_per_slot(max_len)
    with pytest.raises(ValueError, match="pure mamba"):
        Mamba2Backend(get_smoke_config("qwen3-0.6b"))


def _workload(vocab_size):
    rng = np.random.default_rng(3)
    p_lens = [6, 8, 21, 5, 1, 13]
    prompts = [rng.integers(0, vocab_size, size=pl,
                            dtype=np.int64).astype(np.int32)
               for pl in p_lens]
    return prompts, [5, 9, 3, 7, 4, 6]


ENGINE_KW = dict(n_slots=2, segment_len=4, max_len=64, prefill_chunk=8)
CORE_STATS = ("segments", "emitted_tokens", "prefills", "n_slots",
              "segment_len", "admission_batches", "prefill_dispatches",
              "ingest_chunks", "ingest_interleaved", "admission_dispatches",
              "prefill_jit_misses", "slot_utilization",
              "mean_admission_batch", "interleave_ratio", "cache_hits",
              "cache_misses", "cache_evictions", "cached_prefix_tokens",
              "forks")


@pytest.mark.parametrize("backend", ["linear", "softmax"])
def test_engine_matches_jax_engine(backend):
    """Both engines on one workload (prompts of 1 to 21 tokens): per-request
    admission; completions token for token, finish reasons, admitted and
    finished steps, and the core stats equal."""
    jcfg, tcfg, pj, pt = _models(backend, seed=6)
    prompts, gens = _workload(jcfg.vocab_size)
    outs = []
    for engine in (JaxEngine(pj, jcfg, **ENGINE_KW),
                   DecodeEngine(pt, tcfg, **ENGINE_KW)):
        for p, g in zip(prompts, gens):
            engine.submit(p, g, arrival=0.0)
        outs.append((engine.run("continuous"), engine.stats.to_dict(),
                     engine.admission))
    (j_comps, j_stats, j_adm), (t_comps, t_stats, t_adm) = outs
    assert j_adm == t_adm == "per_request"
    assert len(t_comps) == len(j_comps) == len(prompts)
    for a, b in zip(t_comps, j_comps):
        assert (a.uid, a.finish_reason, a.admitted_step, a.finished_step) \
            == (b.uid, b.finish_reason, b.admitted_step, b.finished_step)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for k in CORE_STATS:
        assert t_stats[k] == j_stats[k], k


# -- the entry points ----------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_generate_and_stream_on_cpu(backend):
    """``serve --arch zamba2-7b --smoke --device cpu`` in generate mode
    under each backend: tokens of the asked shape, the state's bytes,
    no launch on the CPU; linear and softmax also in stream mode: every
    request its budget, per-request admission, the launch formulas
    (attention layers for B1/B10, mamba layers x prefills for B8)."""
    args = serve.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--backend", backend, "--prompt-len", "12",
                             "--gen-len", "4", "--batch", "2"])
    cfg = serve.serving_config(args)
    assert cfg.param_dtype == cfg.dtype == "bfloat16"
    out = serve.generate(args)
    assert out["tokens"].shape == (2, 4)
    assert out["prefill_launches"] == out["decode_launches"] == 0
    counts = serve.layer_counts(cfg)
    assert counts == {"attn": 2, "cross": 0, "mamba": 7, "rwkv": 0}
    assert set(out["prefill_launches_by"]) == (
        {"gated_linear_attention_fwd", "flash_attention_fwd"}
        if backend == "softmax" else {"gated_linear_attention_fwd"})
    assert out["state_mib"] * 2**20 == tlm.state_bytes(
        tlm.pad_decode_state(tlm.init_decode_state(cfg, 2, max_len=16),
                             cfg, 16))
    if backend == "gated_linear":
        return
    args = serve.parse_args([
        "--mode", "stream", "--smoke", "--device", "cpu", "--arch", ARCH,
        "--backend", backend, "--slots", "3", "--segment-len", "4",
        "--n-requests", "5", "--prompt-len", "20", "--gen-len", "8"])
    out = serve.stream(args)
    mix = serve.make_request_mix(np.random.default_rng(0), 5, 20, 8,
                                 cfg.vocab_size, 0.0)
    assert [len(c.tokens) for c in out["completions"]] == \
        [g for _, g, _ in mix]
    st = out["stats"]
    assert out["engine"].admission == "per_request"
    assert out["want_ssd_launches"] == 7 * st["prefills"]
    assert out["want_launches"] == (
        2 * st["prefills"] if backend == "softmax" else
        2 * (st["segment_len"] * st["segments"] + st["ingest_chunks"]))
    assert out["decode_launches"] == out["ssd_launches"] == 0


def test_train_cli_on_cpu():
    """``launch/train.py --arch zamba2-7b --smoke --device cpu``: the
    hybrid trains on the CPU (the SSD through the plain versions of
    B8/B9), the losses finite."""
    loop = ttrain.build(ttrain.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--backend",
         "linear", "--steps", "2", "--seq-len", "16", "--batch", "2"]))
    out = loop.run()
    assert out["step"] == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
