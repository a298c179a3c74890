"""The port's gated (§4 decay) attention and the gated ``generate`` slice
against the JAX package, on converted weights, on the CPU.

qwen3-0.6b smoke config with ``with_backend("gated_linear")`` (GQA 4/2,
qk-norm, RoPE, ``feature_map="elu1"``), fp32; JAX runs with
``decode_kernel="fused"``, i.e. the Pallas ``decode_gated`` through the
interpreter. Layer outputs and states at rtol = atol = 1e-5, the
slice's logits at 1e-4 (the two frameworks sum in different orders),
greedy tokens identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.models import lm as jlm
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm

TOL = 1e-5
LM_TOL = 1e-4
RULES = Rules.null()
B, T, STEPS = 2, 20, 8          # T: not a multiple of linear_chunk (16)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(decay_mode="vector"):
    kw = dict(dtype="float32", decay_mode=decay_mode)
    return (dataclasses.replace(
                jax_smoke_config("qwen3-0.6b").with_backend("gated_linear"),
                decode_kernel="fused", **kw),
            dataclasses.replace(
                get_smoke_config("qwen3-0.6b").with_backend("gated_linear"),
                **kw))


# -- the attention layer -----------------------------------------------------

def _params(jcfg):
    """JAX's init, with the decay bias, the gate projection and the
    groupnorm made non-trivial so that each one's placement matters: the
    log-decay spans roughly [-1, 0] instead of sitting at -0.002."""
    p = {k: np.asarray(v) for k, v in
         JA.attention_params(jax.random.PRNGKey(3), jcfg).items()}
    rng = np.random.default_rng(0)
    r = lambda name, s: rng.standard_normal(p[name].shape).astype(
        np.float32) * s
    for name in ("q_norm", "k_norm"):
        p[name] = 1.0 + r(name, 0.3)
    p["b_gate"] = r("b_gate", 2.0)
    p["w_gate"] = r("w_gate", 0.2)
    p["gn_scale"] = 1.0 + r("gn_scale", 0.3)
    p["gn_bias"] = r("gn_bias", 0.1)
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


def _state(seed, cfg, b):
    h, dh = cfg.n_heads, cfg.head_dim
    return 0.1 * _x(seed, b, h, dh, dh)


def test_attention_params_have_the_gated_leaves():
    jcfg, tcfg = _cfgs()
    pj = JA.attention_params(jax.random.PRNGKey(0), jcfg)
    pt = TA.attention_params(torch.Generator().manual_seed(0), tcfg)
    assert set(pt) == set(pj)
    for name in pj:
        assert tuple(pt[name].shape) == pj[name].shape, name
    assert torch.equal(pt["b_gate"], torch.full_like(pt["b_gate"], 4.0))
    assert torch.equal(pt["gn_scale"], torch.ones_like(pt["gn_scale"]))
    assert not pt["gn_bias"].any()
    assert 0.005 < float(pt["w_gate"].std()) < 0.02        # scale 0.01


@pytest.mark.parametrize("decay_mode", ["vector", "scalar"])
@pytest.mark.parametrize("t", [16, 24])
def test_attention_apply_with_state(t, decay_mode):
    jcfg, tcfg = _cfgs(decay_mode)
    pj, pt = _params(jcfg)
    x = _x(1, 2, t, jcfg.d_model)
    g = np.asarray(JA._decay(pj, x, jcfg))
    _close(TA._decay(pt, torch.from_numpy(x), tcfg), g)
    assert g.shape[-1] == (1 if decay_mode == "scalar" else jcfg.head_dim)
    # a decay that shows, reaching just past the prefill clamp at -1
    assert -1.5 < g.min() < -0.3 and g.max() < 0.0
    y_j, st_j = JA.attention_apply(pj, x, jcfg, RULES, want_state=True)
    y_t, st_t = TA.attention_apply(pt, torch.from_numpy(x), tcfg,
                                   want_state=True)
    _close(y_t, y_j)
    _close(st_t.s, st_j.s)
    assert st_t.z is None and st_j.z is None


@pytest.mark.parametrize("decay_mode", ["vector", "scalar"])
@pytest.mark.parametrize("pos", [5, "per_row"])
def test_attention_decode(pos, decay_mode):
    jcfg, tcfg = _cfgs(decay_mode)
    pj, pt = _params(jcfg)
    b = 3
    x = _x(2, b, jcfg.d_model)
    s = _state(4, jcfg, b)
    pos_np = (np.array([3, 9, 17], np.int32) if pos == "per_row"
              else np.int32(pos))
    y_j, st_j = JA.attention_decode(pj, x, JA.AttnState(None, None, s, None),
                                    pos_np, jcfg, RULES)
    st_t = TA.AttnState(s=torch.from_numpy(s.copy()), z=None)
    y_t, new_t = TA.attention_decode(pt, torch.from_numpy(x), st_t,
                                     torch.from_numpy(np.asarray(pos_np)),
                                     tcfg)
    assert new_t.s is st_t.s and new_t.z is None   # updated in place
    _close(y_t, y_j)
    _close(st_t.s, st_j.s)


@pytest.mark.parametrize("lens", [None, [0, 2, 4], [4, 1, 3]])
def test_attention_decode_window(lens):
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg)
    b, w = 3, 4
    x = _x(5, b, w, jcfg.d_model)
    s = _state(6, jcfg, b)
    pos0 = np.array([0, 7, 30], np.int32)
    lens_np = None if lens is None else np.array(lens, np.int32)
    y_j, st_j = JA.attention_decode_window(
        pj, x, JA.AttnState(None, None, s, None), pos0, jcfg, RULES,
        lens=lens_np)
    st_t = TA.AttnState(s=torch.from_numpy(s.copy()), z=None)
    y_t, _ = TA.attention_decode_window(
        pt, torch.from_numpy(x), st_t, torch.from_numpy(pos0), tcfg,
        lens=None if lens is None else torch.tensor(lens))
    if lens is None:
        _close(y_t, y_j)
    else:                                   # outputs past lens are garbage
        for row, n in enumerate(lens):
            _close(y_t[row, :n], np.asarray(y_j)[row, :n])
            if n == 0:                      # untouched bit for bit
                np.testing.assert_array_equal(st_t.s[row].numpy(), s[row])
    _close(st_t.s, st_j.s)


def test_decode_is_unclamped_and_prefill_is_clamped():
    """A decay far below -1 (b_gate = -40, g < -4): decode scales the
    state by exp(g) as given, prefill by exp(-1) per step (the clamp
    lives in chunked_gla only), in both packages."""
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg)
    pj["b_gate"] = np.full_like(pj["b_gate"], -40.0)
    pt["b_gate"] = torch.from_numpy(pj["b_gate"].copy())
    x = _x(9, 2, 2, jcfg.d_model)
    g = TA._decay(pt, torch.from_numpy(x), tcfg)
    assert float(g.max()) < -4.0
    s = _state(10, jcfg, 2)
    decoded = {}
    for name, s0 in (("carried", s), ("zero", np.zeros_like(s))):
        y_j, st_j = JA.attention_decode_window(
            pj, x, JA.AttnState(None, None, s0, None), np.int32(4), jcfg,
            RULES)
        st_t = TA.AttnState(s=torch.from_numpy(s0.copy()), z=None)
        y_t, _ = TA.attention_decode_window(pt, torch.from_numpy(x), st_t,
                                            torch.tensor(4), tcfg)
        _close(y_t, y_j)
        _close(st_t.s, st_j.s)
        decoded[name] = st_t.s
    # the carried state survives only as exp(g1 + g2) < e^-8 of itself
    carried = (decoded["carried"] - decoded["zero"]).abs().max()
    assert float(carried) < np.exp(-8.0) * float(np.abs(s).max())
    # prefill over the same two tokens: token 1 decays by e^-1, not e^g2
    _, st_p = TA.attention_apply(pt, torch.from_numpy(x), tcfg,
                                 want_state=True)
    _, st_pj = JA.attention_apply(pj, x, jcfg, RULES, want_state=True)
    _close(st_p.s, st_pj.s)
    assert (st_p.s - decoded["zero"]).abs().max() > 1.0


def test_decode_reference_kernel_choice_agrees():
    """decode_kernel="reference" (the plain version asked for explicitly)
    and the kernel wrapper give the same layer output on the CPU."""
    jcfg, tcfg = _cfgs()
    _, pt = _params(jcfg)
    x = torch.from_numpy(_x(7, 2, 3, tcfg.d_model))
    s = _state(8, tcfg, 2)
    outs = []
    for kernel in ("auto", "reference"):
        st = TA.AttnState(s=torch.from_numpy(s.copy()), z=None)
        y, st = TA.attention_decode_window(
            pt, x, st, torch.tensor(4), dataclasses.replace(
                tcfg, decode_kernel=kernel))
        outs.append((y, st.s))
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_feature_gate_is_still_refused():
    _, tcfg = _cfgs()
    with pytest.raises(NotImplementedError):
        TA.init_attn_state(dataclasses.replace(tcfg, feature_gate=True), 1)


# -- the slice ---------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    # a faster decay than the init's (b_gate 4 -> g ≈ -0.002), so that the
    # decay shows in every logit
    pj = jax.tree_util.tree_map_with_path(
        lambda path, x: jnp.full_like(x, 0.5)
        if "b_gate" in jax.tree_util.keystr(path) else x, pj)
    pt = convert.params_from_jax(_np_tree(pj), tcfg)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    return jcfg, tcfg, pj, pt, prompt, forced


@pytest.fixture(scope="module")
def jax_run(setup):
    """Prefill, 8 teacher-forced decode steps, and 8 greedy steps."""
    jcfg, _, pj, _, prompt, forced = setup
    logits, st0 = jlm.prefill(pj, jnp.asarray(prompt), jcfg, RULES)
    step_logits, st = [], st0
    for i in range(STEPS):
        lg, st = jlm.decode_step(pj, st, jnp.asarray(forced[:, i]), T + i,
                                 jcfg, RULES)
        step_logits.append(np.asarray(lg))
    tok0 = jnp.argmax(logits, -1).astype(jnp.int32)
    toks, _ = jlm.generate(pj, st0, tok0, T, STEPS, jcfg, RULES)
    return dict(logits=np.asarray(logits), state=_np_tree(st0),
                steps=step_logits, tokens=np.asarray(toks),
                tok0=np.asarray(tok0))


def _prefill(setup):
    _, tcfg, _, pt, prompt, _ = setup
    return tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg)


def test_params_carry_the_gated_leaves(setup):
    _, _, pj, pt, _, _ = setup
    attn_j = _np_tree(pj)["stack"][0]["attn"]
    attn_t = pt["stack"][0]["attn"]
    assert set(attn_t) == set(attn_j)
    for name in ("w_gate", "b_gate", "gn_scale", "gn_bias"):
        np.testing.assert_array_equal(attn_t[name].numpy(), attn_j[name])


def test_prefill_logits_and_every_layer_state(setup, jax_run):
    logits, st = _prefill(setup)
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"],
                               rtol=LM_TOL, atol=LM_TOL)
    jst = jax_run["state"]
    assert len(st["stack"]) == len(jst["stack"]) and not st["tail"]
    for t_st, j_st in zip(st["stack"], jst["stack"]):
        assert t_st.s.shape == j_st.s.shape          # (R, B, H, Dk, Dv)
        assert t_st.z is None and j_st.z is None
        np.testing.assert_allclose(t_st.s.numpy(), j_st.s, rtol=LM_TOL,
                                   atol=LM_TOL)


def test_forward_logits_match_jax(setup):
    """Every position's logits (JAX's forward runs the gated core through
    its training form, the port's through chunked_gla)."""
    jcfg, tcfg, pj, pt, prompt, _ = setup
    lg_j, _, _ = jlm.forward(pj, jnp.asarray(prompt), jcfg, RULES)
    lg_t, st = tlm.forward(pt, torch.from_numpy(prompt).long(), tcfg)
    assert st is None
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=LM_TOL,
                               atol=LM_TOL)


def test_init_decode_state_has_no_normaliser(setup):
    jcfg, tcfg, _, _, _, _ = setup
    assert tcfg.linear_normalize                 # z None all the same
    j_st = _np_tree(jlm.init_decode_state(jcfg, B, 64))
    t_st = tlm.init_decode_state(tcfg, B)
    for t, j in zip(t_st["stack"], j_st["stack"]):
        assert t.z is None and j.z is None
        assert t.s.shape == j.s.shape and t.s.dtype == torch.float32
        assert not t.s.any()
    assert tlm.state_bytes(t_st) == sum(
        x.nbytes for x in jax.tree.leaves(j_st))


def test_teacher_forced_decode_steps(setup, jax_run):
    _, tcfg, _, pt, _, forced = setup
    _, st = _prefill(setup)
    for i in range(STEPS):
        lg, st = tlm.decode_step(pt, st, torch.from_numpy(forced[:, i]).long(),
                                 T + i, tcfg)
        np.testing.assert_allclose(lg.numpy(), jax_run["steps"][i],
                                   rtol=LM_TOL, atol=LM_TOL,
                                   err_msg=f"step {i}")


def test_decode_from_a_carried_jax_state(setup, jax_run):
    """A JAX gated decode state (z None) converted with state_from_jax
    decodes like the port's own prefill state."""
    _, tcfg, _, pt, _, forced = setup
    st = convert.state_from_jax(jax_run["state"])
    assert all(g.z is None for g in st["stack"])
    lg, _ = tlm.decode_step(pt, st, torch.from_numpy(forced[:, 0]).long(),
                            T, tcfg)
    np.testing.assert_allclose(lg.numpy(), jax_run["steps"][0], rtol=LM_TOL,
                               atol=LM_TOL)


def test_generate_greedy_tokens_identical(setup, jax_run):
    _, tcfg, _, pt, _, _ = setup
    logits, st = _prefill(setup)
    tok0 = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok0.numpy(), jax_run["tok0"])
    toks, _ = tlm.generate(pt, st, tok0, T, STEPS, tcfg)
    assert toks.shape == (B, STEPS)
    np.testing.assert_array_equal(toks.numpy(), jax_run["tokens"])


@pytest.mark.parametrize("lens", [None, [3, 0]])
def test_decode_window_matches_jax(setup, jax_run, lens):
    jcfg, tcfg, pj, pt, _, forced = setup
    toks = forced[:, :4]
    jst = jax.tree.map(jnp.asarray, jax_run["state"])
    tst = convert.state_from_jax(jax_run["state"])
    if lens is None:
        lg_j, st_j = jlm.decode_window(pj, jst, jnp.asarray(toks), T, jcfg,
                                       RULES)
        lg_t, st_t = tlm.decode_window(pt, tst, torch.from_numpy(toks).long(),
                                       T, tcfg)
        valid = [4, 4]
    else:
        pos0 = np.array([T, T + 3], np.int32)
        lg_j, st_j = jlm.decode_window_varlen(
            pj, jst, jnp.asarray(toks), pos0, np.array(lens, np.int32), jcfg,
            RULES)
        lg_t, st_t = tlm.decode_window_varlen(
            pt, tst, torch.from_numpy(toks).long(), torch.from_numpy(pos0),
            torch.tensor(lens), tcfg)
        valid = lens
    for row, n in enumerate(valid):
        np.testing.assert_allclose(lg_t[row, :n].numpy(),
                                   np.asarray(lg_j)[row, :n], rtol=LM_TOL,
                                   atol=LM_TOL)
    for t_st, j_st in zip(st_t["stack"], st_j["stack"]):
        assert t_st.z is None
        np.testing.assert_allclose(t_st.s.numpy(), np.asarray(j_st.s),
                                   rtol=LM_TOL, atol=LM_TOL)
    if lens is not None:                    # lens = 0 row: bitwise frozen
        for t_st, j_st in zip(st_t["stack"], jax_run["state"]["stack"]):
            np.testing.assert_array_equal(t_st.s[:, 1].numpy(), j_st.s[:, 1])


def test_decode_window_equals_decode_steps(setup):
    """Within the port: one W-token window == W single-token steps."""
    _, tcfg, _, pt, _, forced = setup
    _, st_a = _prefill(setup)
    _, st_b = _prefill(setup)
    toks = torch.from_numpy(forced[:, :4]).long()
    lg_w, _ = tlm.decode_window(pt, st_a, toks, T, tcfg)
    for i in range(4):
        lg, _ = tlm.decode_step(pt, st_b, toks[:, i], T + i, tcfg)
        torch.testing.assert_close(lg_w[:, i], lg, rtol=1e-5, atol=1e-5)
    for a, b in zip(st_a["stack"], st_b["stack"]):
        torch.testing.assert_close(a.s, b.s, rtol=1e-5, atol=1e-5)
