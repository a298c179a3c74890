"""The port's slice end to end against the JAX package on converted
weights: prefill (last logits and every layer's (s, z)), teacher-forced
decode steps, greedy generation, and W-token windows. qwen3-0.6b smoke
config, linear backend, fp32. Logits at rtol = atol = 1e-4 (the two
frameworks sum in different orders); greedy tokens identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import lm as tlm

TOL = 1e-4
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


@pytest.fixture(scope="module")
def setup():
    kw = dict(attention_backend="linear", dtype="float32")
    jcfg = dataclasses.replace(jax_smoke_config("qwen3-0.6b"),
                               decode_kernel="fused", **kw)
    tcfg = dataclasses.replace(get_smoke_config("qwen3-0.6b"), **kw)
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
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


def test_prefill_logits_and_every_layer_state(setup, jax_run):
    logits, st = _prefill(setup)
    np.testing.assert_allclose(logits.numpy(), jax_run["logits"], rtol=TOL,
                               atol=TOL)
    jst = jax_run["state"]
    assert len(st["stack"]) == len(jst["stack"]) and not st["tail"]
    for t_st, j_st in zip(st["stack"], jst["stack"]):
        assert t_st.s.shape == j_st.s.shape          # (R, B, H, Dk, Dv)
        np.testing.assert_allclose(t_st.s.numpy(), j_st.s, rtol=TOL,
                                   atol=TOL)
        np.testing.assert_allclose(t_st.z.numpy(), j_st.z, rtol=TOL,
                                   atol=TOL)


def test_forward_logits_match_jax(setup):
    jcfg, tcfg, pj, pt, prompt, _ = setup
    lg_j, _, _ = jlm.forward(pj, jnp.asarray(prompt), jcfg, RULES)
    lg_t, st = tlm.forward(pt, torch.from_numpy(prompt).long(), tcfg)
    assert st is None
    np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), rtol=TOL,
                               atol=TOL)


def test_init_decode_state_matches_jax_layout(setup):
    jcfg, tcfg, _, _, _, _ = setup
    j_st = _np_tree(jlm.init_decode_state(jcfg, B, 64))
    t_st = tlm.init_decode_state(tcfg, B)
    for t, j in zip(t_st["stack"], j_st["stack"]):
        for a, b in ((t.s, j.s), (t.z, j.z)):
            assert a.shape == b.shape and a.dtype == torch.float32
            assert not a.any()
    assert tlm.state_bytes(t_st) == sum(
        x.nbytes for x in jax.tree.leaves(j_st))


def test_teacher_forced_decode_steps(setup, jax_run):
    _, tcfg, _, pt, _, forced = setup
    _, st = _prefill(setup)
    for i in range(STEPS):
        lg, st = tlm.decode_step(pt, st, torch.from_numpy(forced[:, i]).long(),
                                 T + i, tcfg)
        np.testing.assert_allclose(lg.numpy(), jax_run["steps"][i],
                                   rtol=TOL, atol=TOL, err_msg=f"step {i}")


def test_decode_from_a_carried_jax_state(setup, jax_run):
    """A JAX decode state converted with state_from_jax decodes like the
    port's own prefill state (head order under GQA lines up)."""
    _, tcfg, _, pt, _, forced = setup
    st = convert.state_from_jax(jax_run["state"])
    lg, _ = tlm.decode_step(pt, st, torch.from_numpy(forced[:, 0]).long(),
                            T, tcfg)
    np.testing.assert_allclose(lg.numpy(), jax_run["steps"][0], rtol=TOL,
                               atol=TOL)


def test_generate_greedy_tokens_identical(setup, jax_run):
    _, tcfg, _, pt, _, _ = setup
    logits, st = _prefill(setup)
    tok0 = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok0.numpy(), jax_run["tok0"])
    toks, _ = tlm.generate(pt, st, tok0, T, STEPS, tcfg)
    assert toks.shape == (B, STEPS)
    np.testing.assert_array_equal(toks.numpy(), jax_run["tokens"])


def test_generate_temperature_is_seeded(setup):
    _, tcfg, _, pt, _, _ = setup
    runs = []
    for _ in range(2):
        logits, st = _prefill(setup)
        g = torch.Generator().manual_seed(5)
        toks, _ = tlm.generate(pt, st, torch.argmax(logits, -1), T, 4, tcfg,
                               temperature=0.8, generator=g)
        runs.append(toks)
    assert torch.equal(*runs)
    with pytest.raises(ValueError):
        tlm.generate(pt, st, torch.argmax(logits, -1), T, 1, tcfg,
                     temperature=0.8)


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
                                   np.asarray(lg_j)[row, :n], rtol=TOL,
                                   atol=TOL)
    for t_st, j_st in zip(st_t["stack"], st_j["stack"]):
        np.testing.assert_allclose(t_st.s.numpy(), np.asarray(j_st.s),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(t_st.z.numpy(), np.asarray(j_st.z),
                                   rtol=TOL, atol=TOL)
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
