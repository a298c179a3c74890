"""rwkv6-1.6b, the RWKV-6 family, against the JAX package on the CPU, in
fp32, parameters from JAX through ``convert.params_from_jax``:

* the config copies, field by field;
* ``convert``: JAX's parameters and decode state into the port's and
  back, leaf for leaf;
* ``rwkv6_attention``'s plain route against JAX's jnp
  ``chunked_gla(exclusive=True, u=(H, N))`` (1e-5 normwise);
* ``_time_mix`` (prefill and one decode step), the block, and the LM
  (prefill, 8 greedy steps) at the smoke config and at a 2-layer config
  of head dim 64: logits and states within 1e-4 (the two frameworks sum
  in other orders), greedy tokens identical;
* the loss and every gradient leaf of the smoke config (autograd of the
  plain prefill: on the CPU RWKV-6 trains as JAX's jnp path does);
* a prompt of 128 tokens at ``linear_chunk=128``: JAX's jnp chunk of 128
  gives NaN where the decay reaches -0.9 a token, the port's 64-token
  prefill chunk stays finite and matches JAX at chunk 64;
* the ``DecodeEngine`` under ``RWKV6Backend`` against JAX's engine:
  completions, finish reasons, admitted and finished steps and the core
  stats equal; per-request admission, decode windows that step the
  single-token decode and keep inactive slots bit for bit;
* ``serve --arch rwkv6-1.6b --smoke --device cpu`` in ``generate`` and
  ``stream`` mode.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import gated as jgated
from repro.data import SyntheticLMDataset
from repro.models import blocks as jblocks
from repro.models import lm as jlm
from repro.models import rwkv6 as jrwkv
from repro.serving import DecodeEngine as JaxEngine
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.kernels.gated_linear_attention import ops as gops
from repro_torch.launch import serve
from repro_torch.models import blocks as tblocks
from repro_torch.models import lm as tlm
from repro_torch.models import rwkv6 as trwkv
from repro_torch.optim import GradAccumulator
from repro_torch.serving import DecodeEngine, backend_for_config
from repro_torch.serving.backends.rwkv6 import RWKV6Backend
from repro_torch.tree import leaves, tree_map

RULES = Rules.null()
TOL = 1e-4
B, T, STEPS = 2, 20, 8           # T: not a multiple of linear_chunk (16)
ARCH = "rwkv6-1.6b"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _configs(kind):
    """The smoke config, or a 2-layer config of head dim 64 (2 heads,
    d_model 128), both in fp32."""
    jcfg, tcfg = jax_smoke_config(ARCH), get_smoke_config(ARCH)
    kw = dict(dtype="float32")
    if kind == "d64":
        kw.update(name="rwkv6-d64", d_model=128, n_heads=2, n_kv_heads=2,
                  head_dim=64, d_ff=256, rwkv=type(tcfg.rwkv)(head_dim=64))
        jcfg = dataclasses.replace(jcfg, rwkv=type(jcfg.rwkv)(head_dim=64))
    jkw = {k: v for k, v in kw.items() if k != "rwkv"}
    return (dataclasses.replace(jcfg, **jkw),
            dataclasses.replace(tcfg, **kw))


def _perturbed(pj, seed):
    """JAX's parameters with the vectors moved off their init values
    (mu 0.5, u 0, the norms' 1 and 0, where a dropped or swapped leaf
    shows nothing)."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        keys = [getattr(k, "key", None) for k in path]
        if any(k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck",
                     "mu_cr", "u_bonus", "gn_scale", "gn_bias", "scale",
                     "bias") for k in keys):
            return x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, pj)


def _models(kind="smoke", seed=0, **kw):
    jcfg, tcfg = _configs(kind)
    jcfg = dataclasses.replace(jcfg, **kw)
    tcfg = dataclasses.replace(tcfg, **kw)
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


def _jit_prefill(jcfg):
    """JAX's prefill, jitted: one program instead of hundreds of eagerly
    dispatched ones."""
    return jax.jit(lambda p, toks: jlm.prefill(p, toks, jcfg, RULES))


# -- the config and the conversion -------------------------------------------

@pytest.mark.parametrize("getter", ["full", "smoke"])
def test_config_copy_matches_jax(getter):
    j = (jax_config if getter == "full" else jax_smoke_config)(ARCH)
    t = (get_config if getter == "full" else get_smoke_config)(ARCH)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert t.rwkv.head_dim == (64 if getter == "full" else 16)


def test_convert_round_trip():
    """JAX's parameter tree and a JAX decode state (after a prefill) into
    the port's and back to numpy: every leaf equal, in JAX's order and
    shape; the port's own init has the same tree."""
    jcfg, tcfg, pj, pt = _models()
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
    assert isinstance(t_st["stack"][0], trwkv.RWKVState)
    for t, j in zip([x for st in t_st["stack"] for x in st],
                    jax.tree.leaves(_np(j_st))):
        np.testing.assert_array_equal(t.numpy(), j)


# -- the attention core, the time-mix and the block ------------------------

@pytest.mark.parametrize("t", [48, 40])           # 40: padded to the chunk
def test_rwkv6_attention_plain_route_matches_jax_chunked_gla(t):
    """The exclusive form with a bonus u per head ((H, N), RWKV-6's
    ``u_bonus``) against JAX's jnp ``chunked_gla``: o and the final
    state, normwise 1e-5."""
    rng = np.random.default_rng(1)
    b, h, n = 2, 3, 16
    q, k, v = (rng.standard_normal((b, h, t, n)).astype(np.float32)
               for _ in range(3))
    g = (-0.9 * rng.random((b, h, t, n))).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    o_j, s_j = jax.jit(lambda *a: jgated.chunked_gla(
        *a[:4], chunk_size=16, exclusive=True, u=a[4]))(
            *map(jnp.asarray, (q, k, v, g, u)))
    o_t, s_t = gops.rwkv6_attention(*map(torch.from_numpy, (q, k, v, g, u)),
                                    chunk=16)
    for a, j, what in ((o_t, o_j, "o"), (s_t, s_j, "state")):
        j = np.asarray(j)
        assert a.shape == j.shape
        assert np.abs(a.numpy() - j).max() <= 1e-5 * np.abs(j).max(), what


@pytest.mark.parametrize("kind", ["smoke", "d64"])
def test_time_mix_matches_jax(kind):
    """``_time_mix`` of layer 0 over a sequence (the prefill form, through
    ``rwkv6_attention``) and for one step from a state (the decode form,
    ``gated_decode_step``): the output and the new wkv state."""
    jcfg, tcfg, pj, pt = _models(kind)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    pj0 = jax.tree.map(lambda a: a[0], pj["stack"][0])
    pt0 = tlm._at(pt["stack"][0], 0)
    o_j, s_j = jax.jit(lambda p, a: jrwkv._time_mix(
        p, a, jcfg, RULES, None, None, single=False))(pj0, jnp.asarray(x))
    o_t, s_t = trwkv._time_mix(pt0, torch.from_numpy(x), tcfg, None, None,
                               single=False)
    _close(o_t, o_j, what="prefill out")
    _close(s_t, s_j, what="prefill wkv")
    shift = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
    o_j, s_j2 = jax.jit(lambda p, a, sh, w: jrwkv._time_mix(
        p, a, jcfg, RULES, sh, w, single=True))(
            pj0, jnp.asarray(x[:, 0]), jnp.asarray(shift), s_j)
    o_t, s_t2 = trwkv._time_mix(pt0, torch.from_numpy(x[:, 0]), tcfg,
                                torch.from_numpy(shift),
                                torch.from_numpy(np.asarray(s_j)),
                                single=True)
    _close(o_t, o_j, what="decode out")
    _close(s_t2, s_j2, what="decode wkv")


@pytest.mark.parametrize("kind", ["smoke", "d64"])
def test_block_apply_and_decode_match_jax(kind):
    """The rwkv block through ``blocks``: apply with its state, then two
    decode steps, the second with one slot inactive (its state bit for
    bit)."""
    jcfg, tcfg, pj, pt = _models(kind, seed=1)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, T, jcfg.d_model)).astype(np.float32)
    pj0 = jax.tree.map(lambda a: a[0], pj["stack"][0])
    pt0 = tlm._at(pt["stack"][0], 0)
    y_j, st_j, _ = jax.jit(lambda p, a: jblocks.block_apply(
        "rwkv", p, a, jcfg, RULES, want_state=True))(pj0, jnp.asarray(x))
    y_t, st_t, aux = tblocks.block_apply("rwkv", pt0, torch.from_numpy(x),
                                         tcfg, want_state=True)
    assert aux is None and isinstance(st_t, trwkv.RWKVState)
    _close(y_t, y_j, what="apply")
    for a, j in zip(st_t, st_j):
        _close(a, j, what="state")
    for step, active in enumerate((None, np.array([True, False]))):
        xt = rng.standard_normal((B, jcfg.d_model)).astype(np.float32)
        act_j = None if active is None else jnp.asarray(active)
        act_t = None if active is None else torch.from_numpy(active)
        before = [a.clone() for a in st_t]
        y_j, st_j = jax.jit(lambda p, a, st, pos, act: jblocks.block_decode(
            "rwkv", p, a, st, pos, jcfg, RULES, active=act))(
                pj0, jnp.asarray(xt), st_j, jnp.int32(T + step), act_j)
        y_t, st_t = tblocks.block_decode("rwkv", pt0, torch.from_numpy(xt),
                                         st_t, torch.tensor(T + step), tcfg,
                                         active=act_t)
        _close(y_t, y_j, what=f"decode {step}")
        for a, j, old in zip(st_t, st_j, before):
            _close(a, j, what=f"decode state {step}")
            if active is not None:
                assert torch.equal(a[1], old[1])


@pytest.mark.parametrize("kind", ["smoke", "d64"])
def test_lm_prefill_and_generate_match_jax(kind):
    """Prefill (last logits, every layer's state), then 8 greedy steps:
    logits within 1e-4 at every step, tokens identical."""
    jcfg, tcfg, pj, pt = _models(kind, seed=2)
    prompt = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    j_logits, j_st = _jit_prefill(jcfg)(pj, jnp.asarray(prompt))
    j_decode = jax.jit(lambda p, st, tok, pos: jlm.decode_step(
        p, st, tok, pos, jcfg, RULES))
    t_logits, t_st = tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)
    _close(t_logits, j_logits, what="prefill logits")
    t_leaves = [x for st in t_st["stack"] for x in st]
    for t, j in zip(t_leaves, jax.tree.leaves(_np(j_st)), strict=True):
        _close(t, j, what="prefill state")
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))
    for i in range(STEPS):
        j_lg, j_st = j_decode(pj, j_st, j_tok, jnp.int32(T + i))
        t_lg, t_st = tlm.decode_step(pt, t_st, t_tok, T + i, tcfg)
        _close(t_lg, j_lg, what=f"step {i}")
        j_tok = jnp.argmax(j_lg, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_lg, -1)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok),
                                      err_msg=f"step {i}")
    # lm.generate runs the same steps
    _, t_st = tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)
    toks, _ = tlm.generate(pt, t_st, torch.argmax(t_logits, -1), T, 4, tcfg)
    assert toks.shape == (B, 4)


def test_loss_and_gradients_match_jax():
    """``lm_loss`` and every gradient leaf against ``jax.value_and_grad``
    (T = 24): loss within 1e-5 relative, leaves within 1e-4 normwise."""
    jcfg, tcfg, pj, pt = _models(seed=3)
    batch = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=24,
                               global_batch=B, seed=0).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, RULES), has_aux=True))(pj)
    t_loss, _, t_grads = GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), pt,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    t_leaves, j_leaves = leaves(t_grads), jax.tree.leaves(_np(grads))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_long_prompt_prefill_stays_finite_where_jax_chunk_128_does_not():
    """At ``linear_chunk=128`` and a 128-token prompt, JAX's jnp chunk of
    128 scales keys by exp(-b) with b down to -115 (the decay init
    reaches -0.9 a token) and its logits are NaN; the port prefills in
    chunks of at most ``PREFILL_CHUNK`` (64), stays finite, and matches
    JAX's prefill at ``linear_chunk=64`` within 1e-4."""
    jcfg, tcfg, pj, pt = _models(seed=4, linear_chunk=128)
    prompt = np.random.default_rng(5).integers(
        0, jcfg.vocab_size, (B, 128)).astype(np.int32)
    j_nan, _ = _jit_prefill(jcfg)(pj, jnp.asarray(prompt))
    assert np.isnan(np.asarray(j_nan)).any()
    j64 = dataclasses.replace(jcfg, linear_chunk=trwkv.PREFILL_CHUNK)
    j_logits, _ = _jit_prefill(j64)(pj, jnp.asarray(prompt))
    t_logits, _ = tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)
    assert torch.isfinite(t_logits).all()
    _close(t_logits, j_logits, what="prefill logits")


@pytest.mark.parametrize("kind", ["mamba", "shared_attn"])
def test_blocks_take_rwkv_and_still_refuse_the_unported_kinds(kind):
    """The blocks take ``rwkv`` (its params and state build) and, since
    Mamba-2 and the shared attention were ported, no kind is refused:
    ``mamba`` builds its norm and SSD tree, ``shared_attn`` an attention
    block's (``tests/test_torch_mamba2.py`` holds both against JAX)."""
    cfg = get_smoke_config(ARCH)
    p = tblocks.block_params("rwkv", torch.Generator().manual_seed(0), cfg)
    assert set(p) >= {"u_bonus", "w_decay0", "ln1", "ln2"}
    st = tblocks.block_state_init("rwkv", cfg, 3)
    assert isinstance(st, trwkv.RWKVState)
    assert st.wkv.shape == (3, 4, 16, 16) and st.wkv.dtype == torch.float32
    assert st.shift_att.dtype == getattr(torch, cfg.dtype)
    zcfg = get_smoke_config("zamba2-7b")
    p = tblocks.block_params(kind, torch.Generator().manual_seed(0), zcfg)
    assert set(p) == ({"norm1", "mamba"} if kind == "mamba" else
                      {"norm1", "norm2", "attn", "mlp"})


def test_rwkv6_attention_shared_bonus_is_the_per_head_bonus_repeated():
    """A (Dk,) bonus and the same row repeated per head, (H, Dk), give the
    same output and state on the plain route."""
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, 3, 40, 16))
                                .astype(np.float32)) for _ in range(3))
    g = torch.from_numpy((-0.5 * rng.random((2, 3, 40, 16)))
                         .astype(np.float32))
    u = torch.from_numpy(rng.standard_normal(16).astype(np.float32))
    o1, s1 = gops.rwkv6_attention(q, k, v, g, u, chunk=16)
    o2, s2 = gops.rwkv6_attention(q, k, v, g, u.expand(3, 16), chunk=16)
    torch.testing.assert_close(o1, o2, rtol=0, atol=0)
    torch.testing.assert_close(s1, s2, rtol=0, atol=0)


def test_serve_backend_defaults_to_linear_for_attention_configs():
    """``--backend`` unset: linear for a config with attention layers (the
    entry point's old default); rwkv6 keeps its own."""
    cfg = serve.serving_config(serve.parse_args(["--smoke"]))
    assert cfg.attention_backend == "linear"
    cfg = serve.serving_config(serve.parse_args(["--smoke", "--arch", ARCH]))
    assert cfg.attention_backend == get_smoke_config(ARCH).attention_backend


# -- the engine ---------------------------------------------------------------

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


def test_backend_and_admission_modes():
    """``RWKV6Backend`` claims the pure rwkv stack; admission ``auto`` is
    ``per_request`` (varlen prefill is attention-only) and ``batched``
    raises; the decode state is fixed-size."""
    cfg = get_smoke_config(ARCH)
    be = backend_for_config(cfg)
    assert isinstance(be, RWKV6Backend) and be.fixed_size_state
    assert not be.supports_varlen_prefill
    assert be.resolve_modes("auto", "auto") == ("per_request", "recurrent")
    with pytest.raises(ValueError, match="batched"):
        be.resolve_modes("batched", "auto")
    assert be.state_bytes_per_slot(16) == be.state_bytes_per_slot(4096)
    with pytest.raises(ValueError, match="pure rwkv"):
        RWKV6Backend(get_smoke_config("qwen3-0.6b"))


def test_engine_matches_jax_engine():
    """Both engines on the mixed workload (prompts of 1 to 40 tokens, the
    8-token chunk below most of them): per-request admission prefills
    each prompt whole; completions token for token, finish reasons,
    admitted and finished steps, and the core stats equal."""
    jcfg, tcfg, pj, pt = _models(seed=6)
    prompts, gens = _mixed_workload(jcfg.vocab_size)
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


def test_decode_window_steps_the_decode_and_freezes_masked_rows():
    """``lm.decode_window_varlen`` on an rwkv stack: row 0 consumes its 3
    tokens as 3 decode steps would, row 1 (lens 0) keeps its state bit
    for bit."""
    _, tcfg, _, pt = _models(seed=7)
    toks = torch.tensor([[3, 4, 5], [6, 7, 8]])
    st = tlm.init_decode_state(tcfg, 2)
    _, st = tlm.prefill(pt, torch.tensor([[1, 2], [9, 10]]), tcfg)
    ref = tree_map(torch.clone, st)         # NamedTuple states included
    assert isinstance(ref["stack"][0], trwkv.RWKVState)
    logits, st = tlm.decode_window_varlen(pt, st, toks, 2, [3, 0], tcfg)
    for w in range(3):
        lg, ref = tlm.decode_step(pt, ref, toks[:, w], 2 + w, tcfg)
        torch.testing.assert_close(logits[0, w], lg[0], rtol=1e-5,
                                   atol=1e-5)
    _, st0 = tlm.prefill(pt, torch.tensor([[1, 2], [9, 10]]), tcfg)
    for a, b, c in zip(tlm._slot_leaves(st), tlm._slot_leaves(ref),
                       tlm._slot_leaves(st0)):
        torch.testing.assert_close(a[0][:, 0], b[0][:, 0], rtol=1e-5,
                                   atol=1e-5)
        assert torch.equal(a[0][:, 1], c[0][:, 1])


# -- the entry points ---------------------------------------------------------

def test_serve_generate_and_stream_on_cpu():
    """``serve --arch rwkv6-1.6b --smoke --device cpu``: tokens of the
    asked shape, the state's bytes (two shift rows and the wkv matrices
    per layer), no kernel launch on the CPU; ``--mode stream``: every
    request its budget, per-request admission, the launch formula
    layers x prefills; ``--backend`` refused."""
    args = serve.parse_args(["--arch", ARCH, "--smoke", "--device", "cpu",
                             "--prompt-len", "12", "--gen-len", "4",
                             "--batch", "2"])
    cfg = serve.serving_config(args)
    assert cfg.param_dtype == cfg.dtype == "bfloat16"
    out = serve.generate(args)
    assert out["tokens"].shape == (2, 4)
    assert out["prefill_launches"] == out["decode_launches"] == 0
    h, n = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    assert out["state_mib"] * 2**20 == cfg.n_layers * 2 * (
        2 * cfg.d_model * 2 + h * n * n * 4)
    args = serve.parse_args([
        "--mode", "stream", "--smoke", "--device", "cpu", "--arch", ARCH,
        "--slots", "3", "--segment-len", "4", "--n-requests", "5",
        "--prompt-len", "20", "--gen-len", "8", "--prefill-chunk", "8"])
    out = serve.stream(args)
    mix = serve.make_request_mix(np.random.default_rng(0), 5, 20, 8,
                                 cfg.vocab_size, 0.0)
    assert [len(c.tokens) for c in out["completions"]] == \
        [g for _, g, _ in mix]
    assert out["engine"].admission == "per_request"
    assert out["want_launches"] == cfg.n_layers * out["stats"]["prefills"]
    assert out["decode_launches"] == 0
    with pytest.raises(ValueError, match="no attention layer"):
        serve.serving_config(serve.parse_args(
            ["--arch", ARCH, "--smoke", "--backend", "linear"]))


def test_train_cli_on_cpu():
    """``launch/train.py --arch rwkv6-1.6b --smoke --device cpu``: RWKV-6
    trains on the CPU (autograd of the plain prefill), the losses
    finite."""
    from repro_torch.launch import train as ttrain
    loop = ttrain.build(ttrain.parse_args(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "2",
         "--seq-len", "16", "--batch", "2"]))
    out = loop.run()
    assert out["step"] == 2
    assert all(np.isfinite(m["loss"]) for m in out["metrics"])
