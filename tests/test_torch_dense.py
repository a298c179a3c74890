"""The dense family (yi-34b, internlm2-20b, phi3-mini-3.8b and
musicgen-large) against the JAX package on the CPU, at their smoke
configs in fp32, parameters from JAX through ``convert.params_from_jax``
(the layernorm biases included):

* ``layernorm`` / ``apply_norm`` against JAX's within 1e-6 (fp32 and
  bf16 inputs: both compute in fp32 and round the result once);
* each config under ``linear``, ``gated_linear`` and ``softmax``:
  prefill (every layer's state) and 8 greedy steps, tokens identical and
  logits within 1e-4; ``lm_loss`` within 1e-5 relative and every
  gradient leaf within 1e-4 normwise (max|Δ| over max|g_JAX|);
* the ``DecodeEngine`` on musicgen-large's smoke config against JAX's
  engine on the mixed workload: completions and core stats equal;
* the norm leaves the port builds for each config, ``dense_init``'s
  draws, and ``serve --arch <id> --smoke --device cpu``.

Logits and states compare at 1e-4 because the two frameworks sum in
different orders; greedy tokens must be identical."""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLMDataset
from repro.models import layers as jlayers
from repro.models import lm as jlm
from repro.serving import DecodeEngine as JaxEngine
from repro.sharding import Rules
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.launch import serve
from repro_torch.models import layers as L
from repro_torch.models import lm as tlm
from repro_torch.serving import DecodeEngine
from repro_torch.tree import leaves

RULES = Rules.null()
TOL = 1e-4
B, T, STEPS = 2, 20, 8          # T: not a multiple of linear_chunk (16)
ARCHS = ["yi-34b", "internlm2-20b", "phi3-mini-3.8b", "musicgen-large"]
BACKENDS = ["linear", "gated_linear", "softmax"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(arch, backend, **kw):
    kw = dict(attention_backend=backend, dtype="float32", **kw)
    return (dataclasses.replace(jax_smoke_config(arch), **kw),
            dataclasses.replace(get_smoke_config(arch), **kw))


def _models(arch, backend, seed=0, **kw):
    """JAX's parameters with every norm's scale and bias moved off their
    init values (1 and 0, where a wrong bias or a dropped scale shows
    nothing), and the port's converted from them."""
    jcfg, tcfg = _configs(arch, backend, **kw)
    pj = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed + 100)

    def perturb(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if "scale" in keys or "bias" in keys:
            return x + 0.1 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    pj = jax.tree_util.tree_map_with_path(perturb, pj)
    return jcfg, tcfg, pj, convert.params_from_jax(_np_tree(pj), tcfg)


# ---------------------------------------------------------------------------
# layernorm
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_jax(kind, dtype):
    """``apply_norm`` against JAX's on (3, 5, 48) inputs with a mean far
    from 0 (a variance taken without the mean, or unbiased, shows), the
    scale and bias drawn: within 1e-6 in fp32, and in bf16 the same
    bf16 values (both round one fp32 result) or one ulp apart."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((3, 5, 48)) * 2.0 + 3.0).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    want = jlayers.apply_norm(kind, {k: jnp.asarray(v) for k, v in p.items()},
                              jnp.asarray(x).astype(jdt))
    got = L.apply_norm(kind, {k: torch.from_numpy(v) for k, v in p.items()},
                       torch.from_numpy(x).to(tdt))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        ulp = np.ldexp(1.0, np.frexp(np.abs(want) + 1e-30)[1] - 8)
        assert (np.abs(got.float().numpy() - want) <= ulp).all()


def test_layernorm_uses_population_variance_and_eps():
    """(x − mean) / sqrt(var + 1e-5) with the population variance, times
    the scale plus the bias, against the formula in fp64."""
    x = torch.tensor([[1.0, 2.0, 4.0, 9.0]])
    p = L.layernorm_params(4)
    p["scale"] = torch.tensor([1.0, 2.0, 0.5, -1.0])
    p["bias"] = torch.tensor([0.0, 1.0, -1.0, 3.0])
    xd = x.double()
    want = ((xd - xd.mean()) / torch.sqrt(((xd - xd.mean()) ** 2).mean()
                                          + 1e-5)
            * p["scale"].double() + p["bias"].double())
    torch.testing.assert_close(L.layernorm(p, x).double(), want, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(L.apply_norm("layernorm", p, x), L.layernorm(p, x))


@pytest.mark.parametrize("arch", ARCHS)
def test_norm_leaves_follow_the_config(arch):
    """Block norms with the repeat axis and ``final_norm``: a scale under
    rmsnorm, a scale and a bias under layernorm (musicgen-large), as in
    JAX's tree; the port's tree has JAX's structure leaf for leaf."""
    jcfg, tcfg = _configs(arch, "linear")
    pt = tlm.init_params(torch.Generator().manual_seed(0), tcfg)
    pj = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    want = {"scale", "bias"} if tcfg.norm == "layernorm" else {"scale"}
    _, reps, _ = tcfg.pattern_and_repeats
    assert set(pt["final_norm"]) == want
    for name in ("norm1", "norm2"):
        assert set(pt["stack"][0][name]) == want
        for leaf in pt["stack"][0][name].values():
            assert leaf.shape == (reps, tcfg.d_model)
    assert [tuple(x.shape) for x in leaves(pt)] == [
        x.shape for x in jax.tree.leaves(pj)]


def test_convert_refuses_a_tree_of_the_other_norm():
    jcfg, tcfg = _configs("musicgen-large", "linear")
    pj = _np_tree(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    with pytest.raises(ValueError, match="final_norm"):
        convert.params_from_jax(pj, dataclasses.replace(tcfg,
                                                        norm="rmsnorm"))


def test_dense_init_draws():
    """fp32 weights are the one-shot draw they always were; weights of
    another type are drawn one matrix at a time into that type, each
    matrix the rounding of its own fp32 draw."""
    g = torch.Generator().manual_seed(7)
    w = L.dense_init(g, 12, 5, lead=(3,))
    want = torch.randn((3, 12, 5), generator=torch.Generator().manual_seed(
        7)) / math.sqrt(12)
    assert torch.equal(w, want)
    g = torch.Generator().manual_seed(7)
    wb = L.dense_init(g, 12, 5, lead=(3,), dtype=torch.bfloat16, scale=0.5)
    ref = torch.Generator().manual_seed(7)
    assert wb.dtype == torch.bfloat16 and wb.shape == (3, 12, 5)
    for i in range(3):
        assert torch.equal(wb[i], (torch.randn((12, 5), generator=ref)
                                   * 0.5).bfloat16())


# ---------------------------------------------------------------------------
# each config under each backend against JAX
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_prefill_and_generate_match_jax(arch, backend):
    """Prefill (last logits, every layer's state), then 8 greedy steps
    from the JAX state's tokens: logits within 1e-4 at every step,
    tokens identical."""
    jcfg, tcfg, pj, pt = _models(arch, backend)
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    steps = T + STEPS
    j_logits, j_st = jlm.prefill(pj, jnp.asarray(prompt), jcfg, RULES)
    j_st = jlm.pad_decode_state(j_st, jcfg, steps)
    t_logits, t_st = tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)
    t_st = tlm.pad_decode_state(t_st, tcfg, steps)
    np.testing.assert_allclose(t_logits.numpy(), np.asarray(j_logits),
                               rtol=TOL, atol=TOL)
    j_leaves = jax.tree.leaves(_np_tree(j_st))
    t_leaves = [x for part in ("stack", "tail") for st in t_st[part]
                for x in st if x is not None]
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape
        np.testing.assert_allclose(t.numpy(), j, rtol=TOL,
                                   atol=TOL * max(1.0, np.abs(j).max()))
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    for i in range(STEPS):
        j_lg, j_st = jlm.decode_step(pj, j_st, j_tok, T + i, jcfg, RULES)
        t_lg, t_st = tlm.decode_step(pt, t_st, t_tok, T + i, tcfg)
        np.testing.assert_allclose(t_lg.numpy(), np.asarray(j_lg), rtol=TOL,
                                   atol=TOL, err_msg=f"step {i}")
        j_tok = jnp.argmax(j_lg, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_lg, -1)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"step {i}")


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("arch", ARCHS)
def test_dense_loss_and_gradients_match_jax(arch, backend):
    """``lm_loss`` against ``jax.value_and_grad`` on a batch of the
    synthetic stream (T = 24): the loss and the cross-entropy within
    1e-5 relative, every gradient leaf (the norms' scales and biases
    included) within 1e-4 normwise."""
    jcfg, tcfg, pj, pt = _models(arch, backend, seed=5)
    batch = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=24,
                               global_batch=B, seed=0).batch_at(0)
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, RULES), has_aux=True)(pj)
    t_loss, t_metrics, t_grads = topt.GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), pt,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    np.testing.assert_allclose(t_metrics["xent"].item(),
                               float(metrics["xent"]), rtol=1e-5)
    t_leaves, j_leaves = leaves(t_grads), jax.tree.leaves(_np_tree(grads))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape and t.dtype == torch.float32
        err = np.abs(t.numpy() - j).max()
        assert err <= 1e-4 * np.abs(j).max(), err


# ---------------------------------------------------------------------------
# the engine on musicgen-large (layernorm, GELU, MHA)
# ---------------------------------------------------------------------------

def _mixed_workload(vocab_size):
    rng = np.random.default_rng(3)
    p_lens = [6, 8, 21, 5, 8, 40, 7, 8, 1]
    prompts = [rng.integers(0, vocab_size, size=pl,
                            dtype=np.int64).astype(np.int32)
               for pl in p_lens]
    return prompts, [5, 12, 3, 9, 6, 7, 4, 8, 6]


ENGINE_KW = dict(n_slots=2, segment_len=4, max_len=96, prefill_chunk=8)
CORE_STATS = ("segments", "emitted_tokens", "prefills", "n_slots",
              "segment_len", "admission_batches", "prefill_dispatches",
              "ingest_chunks", "ingest_interleaved", "admission_dispatches",
              "prefill_jit_misses", "slot_utilization",
              "mean_admission_batch", "interleave_ratio", "cache_hits",
              "cache_misses", "cache_evictions", "cached_prefix_tokens",
              "forks")


def _run(engine, prompts, gens):
    for p, g in zip(prompts, gens):
        engine.submit(p, g, arrival=0.0)
    return engine.run("continuous"), engine.stats.to_dict()


@pytest.mark.parametrize("backend", BACKENDS)
def test_musicgen_engine_matches_jax_engine(backend):
    """Both engines on the mixed workload (prompts beyond the 8-token
    chunk ingested chunk by chunk, a 1-token prompt), batched admission:
    completions token for token, finish reasons, admitted and finished
    steps, and the core stats equal."""
    jcfg, tcfg, pj, pt = _models("musicgen-large", backend)
    prompts, gens = _mixed_workload(jcfg.vocab_size)
    j_comps, j_stats = _run(JaxEngine(pj, jcfg, **ENGINE_KW), prompts, gens)
    t_comps, t_stats = _run(DecodeEngine(pt, tcfg, **ENGINE_KW), prompts,
                            gens)
    assert len(t_comps) == len(j_comps) == len(prompts)
    for a, b in zip(t_comps, j_comps):
        assert (a.uid, a.finish_reason, a.admitted_step, a.finished_step) \
            == (b.uid, b.finish_reason, b.admitted_step, b.finished_step)
        np.testing.assert_array_equal(a.tokens, b.tokens)
    for k in CORE_STATS:
        assert t_stats[k] == j_stats[k], k


# ---------------------------------------------------------------------------
# the entry points
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_serve_generate_dense_on_cpu(arch):
    """``serve --arch <id> --smoke --device cpu``: tokens of the asked
    shape, the linear state's bytes, no kernel launch on the CPU; the
    parameters built in the compute type, layernorm biases included."""
    args = serve.parse_args(["--arch", arch, "--smoke", "--device", "cpu",
                             "--prompt-len", "12", "--gen-len", "4",
                             "--batch", "2"])
    cfg = serve.serving_config(args)
    assert cfg.param_dtype == cfg.dtype == "bfloat16"
    out = serve.generate(args)
    assert out["tokens"].shape == (2, 4) and out["decode_launches"] == 0
    assert ((out["tokens"] >= 0) & (out["tokens"] < cfg.vocab_size)).all()
    assert out["state_mib"] * 2**20 == (cfg.n_layers * 2 * cfg.n_heads
                                        * cfg.head_dim
                                        * (cfg.head_dim + 1) * 4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_serve_stream_musicgen_on_cpu(backend):
    """``serve --mode stream --arch musicgen-large --smoke``: every
    request completes with its budget of tokens, chunked ingest runs."""
    args = serve.parse_args([
        "--mode", "stream", "--smoke", "--device", "cpu", "--arch",
        "musicgen-large", "--backend", backend, "--slots", "3",
        "--segment-len", "4", "--n-requests", "5", "--prompt-len", "20",
        "--gen-len", "8", "--prefill-chunk", "8"])
    out = serve.stream(args)
    mix = serve.make_request_mix(np.random.default_rng(0), 5, 20, 8,
                                 get_smoke_config("musicgen-large")
                                 .vocab_size, 0.0)
    assert [len(c.tokens) for c in out["completions"]] == \
        [g for _, g, _ in mix]
    assert out["decode_launches"] == 0


def test_full_configs_head_dims():
    """The widths the card serves: head dims 128, 128, 96 and 64 at full
    size, 8, 8, 16 and 16 in the smoke configs."""
    assert [get_config(a).head_dim for a in ARCHS] == [128, 128, 96, 64]
    assert [get_smoke_config(a).head_dim for a in ARCHS] == [8, 8, 16, 16]


@pytest.mark.parametrize("d", [8, 16, 32, 64, 96, 128])
def test_kernel_wrappers_take_the_dense_head_dims(d):
    """What B1/B7's and B10's wrappers hand to their kernels: D = 16, 64,
    96 and 128; D = 8 and 32 raise ValueError (a CUDA tensor there gets
    no plain route)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.fused_recurrent import ops as fr_ops
    n, w = 4, 2
    s, z = torch.zeros(n, d, d), torch.ones(n, d)
    q = k = v = torch.ones(n, w, d)
    g = torch.zeros(n, w, d)
    checks = (lambda: fr_ops._check(s, q, k, v, z, True, None),
              lambda: fr_ops._check_gated(s, q, k, v, g, None),
              lambda: fa_ops._check(q, k, v))
    for check in checks:
        if d in (8, 32):
            with pytest.raises(ValueError):
                check()
        else:
            check()


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_dense_on_cpu(arch):
    """``launch/train.py --arch <id> --smoke --device cpu``: the loss
    stays finite over the steps (layernorm's scale and bias trained for
    musicgen-large)."""
    from repro_torch.launch import train as ttrain
    loop = ttrain.build(ttrain.parse_args(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--seq-len", "16", "--batch", "2"]))
    out = loop.run()
    assert out["step"] == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
