"""The paper's §4 feature gate, f = σ(W h + b) ⊙ h on the keys and values
that enter the state, against the JAX package on the CPU in fp32.

qwen3-0.6b's smoke config with ``feature_gate=True`` under ``linear`` and
``gated_linear`` (JAX gates the linear family only), the gate's bias
drawn off its zero init so that σ varies: the attention layer at each of
JAX's four call sites (prefill and training, single-token decode, the
fused window, the chunk-parallel ingest) at 1e-5, and the LM's prefill,
8 greedy steps, loss and every gradient leaf (the gate's included), on
weights carried over by ``convert.params_from_jax``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLMDataset
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm
from repro_torch.optim import GradAccumulator
from repro_torch.tree import leaves

TOL = 1e-5
LM_TOL = 1e-4
RULES = Rules.null()
B, T, STEPS = 2, 20, 8
BACKENDS = ("linear", "gated_linear")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(backend):
    kw = dict(dtype="float32", feature_gate=True)
    return (dataclasses.replace(
                jax_smoke_config("qwen3-0.6b").with_backend(backend), **kw),
            dataclasses.replace(
                get_smoke_config("qwen3-0.6b").with_backend(backend), **kw))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _params(jcfg):
    """One attention layer's JAX init with the gate's bias off zero (σ
    then spans (0, 1) instead of sitting near 0.5) and, under
    gated_linear, a decay that shows."""
    p = {k: np.asarray(v) for k, v in
         JA.attention_params(jax.random.PRNGKey(3), jcfg).items()}
    p["b_fgate"] = 2.0 * _x(1, *p["b_fgate"].shape)
    if "b_gate" in p:
        p["b_gate"] = 2.0 * _x(2, *p["b_gate"].shape)
        p["w_gate"] = 0.2 * _x(3, *p["w_gate"].shape)
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j), rtol=tol,
                               atol=tol)


def _state(backend, cfg, b, seed=4):
    s = 0.1 * _x(seed, b, cfg.n_heads, cfg.head_dim, cfg.head_dim)
    z = (np.abs(_x(seed + 1, b, cfg.n_heads, cfg.head_dim)) + 1.0
         if backend == "linear" else None)
    return (JA.AttnState(None, None, jnp.asarray(s),
                         None if z is None else jnp.asarray(z)),
            TA.AttnState(s=torch.from_numpy(s.copy()),
                         z=None if z is None else torch.from_numpy(z.copy())))


def _close_state(t, j):
    _close(t.s, j.s)
    assert (t.z is None) == (j.z is None)
    if t.z is not None:
        _close(t.z, j.z)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gate_parameters_match_jax(backend):
    """``w_fgate`` (D, Hkv·Dh) and ``b_fgate`` (Hkv·Dh,) beside the other
    leaves, with JAX's shapes; zero bias at init. Softmax has no gate."""
    jcfg, tcfg = _cfgs(backend)
    pj = JA.attention_params(jax.random.PRNGKey(0), jcfg)
    pt = TA.attention_params(torch.Generator().manual_seed(0), tcfg)
    assert set(pt) == set(pj) >= {"w_fgate", "b_fgate"}
    for name in pj:
        assert tuple(pt[name].shape) == pj[name].shape, name
    assert not pt["b_fgate"].any()
    soft = TA.attention_params(torch.Generator().manual_seed(0),
                               tcfg.with_backend("softmax"))
    assert "w_fgate" not in soft


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("want_state", [True, False])
def test_gate_at_prefill_and_training(backend, want_state):
    """``attention_apply`` (JAX ``:405``): the prefill with its state, and
    the training form, whose gradient reaches ``w_fgate``."""
    jcfg, tcfg = _cfgs(backend)
    pj, pt = _params(jcfg)
    x = _x(5, B, T, jcfg.d_model)
    y_j, st_j = JA.attention_apply(pj, x, jcfg, RULES, want_state=want_state)
    pt["w_fgate"].requires_grad_()
    y_t, st_t = TA.attention_apply(pt, torch.from_numpy(x), tcfg,
                                   want_state=want_state)
    _close(y_t, y_j)
    if want_state:
        _close_state(st_t, st_j)
    else:
        g_j = jax.grad(lambda w: JA.attention_apply(
            {**pj, "w_fgate": w}, x, jcfg, RULES)[0].sum())(pj["w_fgate"])
        y_t.sum().backward()
        _close(pt["w_fgate"].grad, g_j, 1e-4)


@pytest.mark.parametrize("backend", BACKENDS)
def test_gate_at_decode(backend):
    """``attention_decode`` (JAX ``:615``) from a state, then a step with
    one slot inactive (its state bit for bit)."""
    jcfg, tcfg = _cfgs(backend)
    pj, pt = _params(jcfg)
    st_j, st_t = _state(backend, jcfg, B)
    for step, active in enumerate((None, np.array([False, True]))):
        x = _x(6 + step, B, jcfg.d_model)
        old = st_t.s.clone()
        y_j, st_j = JA.attention_decode(
            pj, x, st_j, jnp.int32(7 + step), jcfg, RULES,
            active=None if active is None else jnp.asarray(active))
        y_t, st_t = TA.attention_decode(
            pt, torch.from_numpy(x), st_t, torch.tensor(7 + step), tcfg,
            active=None if active is None else torch.from_numpy(active))
        if active is None:
            _close(y_t, y_j)
        else:
            _close(y_t[1], y_j[1])
            assert torch.equal(st_t.s[0], old[0])
        _close_state(st_t, st_j)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("ingest", [False, True])
def test_gate_at_window_and_ingest(backend, ingest):
    """The fused window (``attention_decode_window``, JAX ``:700``) and
    the chunk-parallel ingest (``attention_ingest_window``, JAX ``:774``)
    with per-row lengths 5 and 2: the rows' outputs at their valid
    positions and the states."""
    jcfg, tcfg = _cfgs(backend)
    pj, pt = _params(jcfg)
    st_j, st_t = _state(backend, jcfg, B, seed=8)
    w = 5
    x = _x(9, B, w, jcfg.d_model)
    pos0 = np.array([3, 11], np.int32)
    lens = np.array([5, 2], np.int32)
    j_fn = JA.attention_ingest_window if ingest else \
        JA.attention_decode_window
    t_fn = TA.attention_ingest_window if ingest else \
        TA.attention_decode_window
    y_j, st_j = j_fn(pj, x, st_j, jnp.asarray(pos0), jcfg, RULES,
                     lens=jnp.asarray(lens))
    y_t, st_t = t_fn(pt, torch.from_numpy(x), st_t, torch.from_numpy(pos0),
                     tcfg, lens=torch.from_numpy(lens))
    for b, n in enumerate(lens):
        _close(y_t[b, :n], np.asarray(y_j)[b, :n])
    _close_state(st_t, st_j)


# -- the LM ----------------------------------------------------------------

def _models(backend, seed=0):
    jcfg, tcfg = _cfgs(backend)
    pj = jlm.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    pj["stack"][0]["attn"]["b_fgate"] = jnp.asarray(
        2.0 * rng.standard_normal(pj["stack"][0]["attn"]["b_fgate"].shape),
        jnp.float32)
    return jcfg, tcfg, pj, convert.params_from_jax(
        jax.tree.map(np.asarray, pj), tcfg)


def _lm_close(t, j):
    j = np.asarray(j)
    np.testing.assert_allclose(t.detach().numpy(), j, rtol=LM_TOL,
                               atol=LM_TOL * max(1.0, np.abs(j).max()))


@pytest.mark.parametrize("backend", BACKENDS)
def test_lm_prefill_and_generate_match_jax(backend):
    """Prefill (last logits and every state) and 8 greedy steps: logits
    within 1e-4, tokens identical."""
    jcfg, tcfg, pj, pt = _models(backend, seed=1)
    prompt = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (B, T)).astype(np.int32)
    j_logits, j_st = jax.jit(lambda p, t: jlm.prefill(p, t, jcfg, RULES))(
        pj, jnp.asarray(prompt))
    t_logits, t_st = tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)
    _lm_close(t_logits, j_logits)
    for t, j in zip([x for st in t_st["stack"] for x in st if x is not None],
                    jax.tree.leaves(j_st), strict=True):
        _lm_close(t, j)
    j_decode = jax.jit(lambda p, st, tok, pos: jlm.decode_step(
        p, st, tok, pos, jcfg, RULES))
    j_tok = jnp.argmax(j_logits, -1).astype(jnp.int32)
    t_tok = torch.argmax(t_logits, -1)
    for i in range(STEPS):
        j_lg, j_st = j_decode(pj, j_st, j_tok, jnp.int32(T + i))
        t_lg, t_st = tlm.decode_step(pt, t_st, t_tok, T + i, tcfg)
        _lm_close(t_lg, j_lg)
        j_tok = jnp.argmax(j_lg, -1).astype(jnp.int32)
        t_tok = torch.argmax(t_lg, -1)
        np.testing.assert_array_equal(t_tok.numpy(), np.asarray(j_tok))


@pytest.mark.parametrize("backend", BACKENDS)
def test_loss_and_gradients_match_jax(backend):
    """``lm_loss`` within 1e-5 relative and every gradient leaf (the
    gate's ``w_fgate`` and ``b_fgate`` included) within 1e-4 normwise."""
    jcfg, tcfg, pj, pt = _models(backend, seed=3)
    batch = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=24,
                               global_batch=B, seed=0).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, RULES), has_aux=True))(pj)
    t_loss, _, t_grads = GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), pt,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    assert t_grads["stack"][0]["attn"]["w_fgate"].abs().max() > 0
    t_leaves = leaves(t_grads)
    j_leaves = jax.tree.leaves(jax.tree.map(np.asarray, grads))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()
