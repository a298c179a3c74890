"""The port's softmax (KV-cache) attention and the softmax ``generate``
slice against the JAX package, on converted weights, on the CPU.

qwen3-0.6b smoke config with ``with_backend("softmax")`` (GQA 4/2,
qk-norm, RoPE), fp32. Prefill attention runs B10's plain version here
(JAX: its jnp pair-list flash forward); decode writes one cache row per
sequence and reads the cache in plain PyTorch (JAX: ``decode_attention``).
Layer outputs and caches at rtol = atol = 1e-5, the slice's logits and
caches at 1e-4 (the two frameworks sum in different orders through two
layers and the head), greedy tokens identical.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

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
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.models import attention as TA
from repro_torch.models import lm as tlm

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-5
LM_TOL = 1e-4
RULES = Rules.null()
B, T, STEPS = 2, 20, 8


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _cfgs(dtype="float32"):
    return (dataclasses.replace(
                jax_smoke_config("qwen3-0.6b").with_backend("softmax"),
                dtype=dtype),
            dataclasses.replace(
                get_smoke_config("qwen3-0.6b").with_backend("softmax"),
                dtype=dtype))


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


# -- the attention layer -----------------------------------------------------

def _params(jcfg):
    """JAX's init with non-trivial qk-norm scales."""
    p = {k: np.asarray(v) for k, v in
         JA.attention_params(jax.random.PRNGKey(3), jcfg).items()}
    rng = np.random.default_rng(0)
    for name in ("q_norm", "k_norm"):
        p[name] = 1.0 + 0.3 * rng.standard_normal(p[name].shape).astype(
            np.float32)
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def test_attention_params_have_the_softmax_leaves():
    jcfg, tcfg = _cfgs()
    pj = JA.attention_params(jax.random.PRNGKey(0), jcfg)
    pt = TA.attention_params(torch.Generator().manual_seed(0), tcfg)
    assert set(pt) == set(pj) == {"wq", "wk", "wv", "wo", "q_norm", "k_norm"}
    for name in pj:
        assert tuple(pt[name].shape) == pj[name].shape, name


@pytest.mark.parametrize("t", [16, 24])
def test_attention_apply_with_state(t):
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg)
    x = _x(1, 2, t, jcfg.d_model)
    y_j, st_j = JA.attention_apply(pj, x, jcfg, RULES, want_state=True)
    y_t, st_t = TA.attention_apply(pt, torch.from_numpy(x), tcfg,
                                   want_state=True)
    _close(y_t, y_j)
    assert st_t.k_cache.shape == st_j.k_cache.shape == (
        2, t, jcfg.n_kv_heads, jcfg.head_dim)          # (B, T, Hkv, Dh)
    _close(st_t.k_cache, st_j.k_cache)
    _close(st_t.v_cache, st_j.v_cache)
    assert st_t.s is None and st_t.z is None


@pytest.mark.parametrize("pos", [5, "per_row"])
def test_attention_decode(pos):
    """One row written in place at pos, then the read over rows ≤ pos."""
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg)
    b, s = 3, 24
    x = _x(2, b, jcfg.d_model)
    kc = 0.5 * _x(3, b, s, jcfg.n_kv_heads, jcfg.head_dim)
    vc = _x(4, b, s, jcfg.n_kv_heads, jcfg.head_dim)
    pos_np = (np.array([3, 9, 17], np.int32) if pos == "per_row"
              else np.int32(pos))
    y_j, st_j = JA.attention_decode(pj, x, JA.AttnState(kc, vc, None, None),
                                    pos_np, jcfg, RULES)
    st_t = TA.AttnState(k_cache=torch.from_numpy(kc.copy()),
                        v_cache=torch.from_numpy(vc.copy()))
    y_t, new_t = TA.attention_decode(pt, torch.from_numpy(x), st_t,
                                     torch.from_numpy(np.asarray(pos_np)),
                                     tcfg)
    assert new_t.k_cache is st_t.k_cache        # written in place
    _close(y_t, y_j)
    _close(st_t.k_cache, st_j.k_cache)
    _close(st_t.v_cache, st_j.v_cache)
    rows = np.broadcast_to(pos_np, (b,))
    untouched = np.ones((b, s), bool)
    untouched[np.arange(b), rows] = False
    np.testing.assert_array_equal(st_t.k_cache.numpy()[untouched],
                                  kc[untouched])


def test_decode_window_and_feature_gate_under_softmax():
    """``attention_decode_window`` under softmax against JAX's scan of
    single-token ``attention_decode`` over the window (what JAX's
    ``block_decode_window`` does for the KV cache): outputs and caches."""
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg)
    b, w, s = 2, 3, 8
    x = _x(5, b, w, jcfg.d_model)
    kc = 0.5 * _x(6, b, s, jcfg.n_kv_heads, jcfg.head_dim)
    vc = _x(7, b, s, jcfg.n_kv_heads, jcfg.head_dim)
    pos0 = np.array([1, 4], np.int32)
    j_st, ys = JA.AttnState(kc, vc, None, None), []
    for i in range(w):
        y, j_st = JA.attention_decode(pj, x[:, i], j_st, pos0 + i, jcfg,
                                      RULES)
        ys.append(np.asarray(y))
    st = TA.AttnState(k_cache=torch.from_numpy(kc.copy()),
                      v_cache=torch.from_numpy(vc.copy()))
    y_t, st_t = TA.attention_decode_window(pt, torch.from_numpy(x), st,
                                           torch.from_numpy(pos0), tcfg)
    assert st_t.k_cache is st.k_cache            # written in place
    _close(y_t, np.stack(ys, axis=1))
    _close(st_t.k_cache, j_st.k_cache)
    _close(st_t.v_cache, j_st.v_cache)
    with pytest.raises(ValueError):              # the cache needs a length
        TA.init_attn_state(tcfg, 2)
    # JAX applies the feature gate to the linear family only: softmax
    # keeps its cache and draws no gate, the linear family both
    gated = dataclasses.replace(tcfg, feature_gate=True)
    assert TA.init_attn_state(gated, 1, max_len=4).k_cache.shape[1] == 4
    gen = torch.Generator().manual_seed(0)
    assert "w_fgate" not in TA.attention_params(gen, gated)
    assert "w_fgate" in TA.attention_params(gen, gated.with_backend("linear"))


# -- the slice ---------------------------------------------------------------

@pytest.fixture(scope="module")
def setup():
    jcfg, tcfg = _cfgs()
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pt = convert.params_from_jax(_np_tree(pj), tcfg)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    forced = rng.integers(0, jcfg.vocab_size, (B, STEPS)).astype(np.int32)
    return jcfg, tcfg, pj, pt, prompt, forced


@pytest.fixture(scope="module")
def jax_run(setup):
    """Prefill, padding to T + STEPS, 8 teacher-forced decode steps, and 8
    greedy steps (through decode_step, keeping the logits, and through
    generate)."""
    jcfg, _, pj, _, prompt, forced = setup
    logits, st0 = jlm.prefill(pj, jnp.asarray(prompt), jcfg, RULES)
    padded = jlm.pad_decode_state(st0, jcfg, T + STEPS)
    step_logits, st = [], padded
    for i in range(STEPS):
        lg, st = jlm.decode_step(pj, st, jnp.asarray(forced[:, i]), T + i,
                                 jcfg, RULES)
        step_logits.append(np.asarray(lg))
    tok0 = jnp.argmax(logits, -1).astype(jnp.int32)
    greedy_logits, tok, st = [], tok0, padded
    for i in range(STEPS):
        lg, st = jlm.decode_step(pj, st, tok, T + i, jcfg, RULES)
        greedy_logits.append(np.asarray(lg))
        tok = jnp.argmax(lg, -1).astype(jnp.int32)
    toks, _ = jlm.generate(pj, padded, tok0, T, STEPS, jcfg, RULES)
    return dict(logits=np.asarray(logits), state=_np_tree(st0),
                padded=_np_tree(padded), steps=step_logits,
                greedy=greedy_logits, tokens=np.asarray(toks),
                tok0=np.asarray(tok0))


def _prefill(setup, **kw):
    _, tcfg, _, pt, prompt, _ = setup
    return tlm.prefill(pt, torch.from_numpy(prompt).long(), tcfg, **kw)


def test_prefill_logits_and_every_layer_cache(setup, jax_run):
    logits, st = _prefill(setup)
    _close(logits, jax_run["logits"], LM_TOL)
    jst = jax_run["state"]
    assert len(st["stack"]) == len(jst["stack"]) and not st["tail"]
    for t_st, j_st in zip(st["stack"], jst["stack"]):
        assert t_st.k_cache.shape == j_st.k_cache.shape   # (R, B, T, Hkv, Dh)
        assert t_st.s is None and j_st.s is None
        _close(t_st.k_cache, j_st.k_cache, LM_TOL)
        _close(t_st.v_cache, j_st.v_cache, LM_TOL)


def test_prefill_routes_agree_on_the_cpu(setup):
    """``attention_kernel=False`` asks for B10's plain version; on CPU
    tensors the kernel route takes it too, and neither counts a launch."""
    before = FA.fwd.launches
    (lg_a, st_a), (lg_b, st_b) = (_prefill(setup, attention_kernel=k)
                                  for k in (True, False))
    assert FA.fwd.launches == before
    assert torch.equal(lg_a, lg_b)
    assert torch.equal(st_a["stack"][0].k_cache, st_b["stack"][0].k_cache)


def test_pad_decode_state_matches_jax(setup, jax_run):
    _, tcfg, _, _, _, _ = setup
    _, st = _prefill(setup)
    padded = tlm.pad_decode_state(st, tcfg, T + STEPS)
    for t_st, j_st, j_pad in zip(padded["stack"], jax_run["state"]["stack"],
                                 jax_run["padded"]["stack"]):
        assert t_st.k_cache.shape == j_pad.k_cache.shape    # S = T + STEPS
        _close(t_st.k_cache, j_pad.k_cache, LM_TOL)
        _close(t_st.v_cache, j_pad.v_cache, LM_TOL)
        assert not t_st.k_cache[:, :, T:].any()
    # long enough already: the same caches, not shrunk
    assert tlm.pad_decode_state(padded, tcfg, T)["stack"][0] is \
        padded["stack"][0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_decode_state_matches_jax_layout(dtype):
    jcfg, tcfg = _cfgs(dtype)
    j_st = _np_tree(jlm.init_decode_state(jcfg, B, 64))
    t_st = tlm.init_decode_state(tcfg, B, max_len=64)
    for t, j in zip(t_st["stack"], j_st["stack"]):
        assert t.k_cache.shape == j.k_cache.shape        # (R, B, S, Hkv, Dh)
        assert t.k_cache.dtype == getattr(torch, dtype)
        assert t.s is None and t.z is None and not t.v_cache.any()
    assert tlm.state_bytes(t_st) == sum(
        x.nbytes for x in jax.tree.leaves(j_st))


def _decode_padded(setup):
    _, tcfg, _, _, _, _ = setup
    logits, st = _prefill(setup)
    return logits, tlm.pad_decode_state(st, tcfg, T + STEPS)


def test_teacher_forced_decode_steps(setup, jax_run):
    _, tcfg, _, pt, _, forced = setup
    _, st = _decode_padded(setup)
    for i in range(STEPS):
        lg, st = tlm.decode_step(pt, st, torch.from_numpy(forced[:, i]).long(),
                                 T + i, tcfg)
        _close(lg, jax_run["steps"][i], LM_TOL)


def test_generate_greedy_tokens_and_logits(setup, jax_run):
    _, tcfg, _, pt, _, _ = setup
    logits, st = _decode_padded(setup)
    tok0 = torch.argmax(logits, -1)
    np.testing.assert_array_equal(tok0.numpy(), jax_run["tok0"])
    toks, st_g = tlm.generate(pt, st, tok0, T, STEPS, tcfg)
    assert toks.shape == (B, STEPS)
    np.testing.assert_array_equal(toks.numpy(), jax_run["tokens"])
    _, st = _decode_padded(setup)
    tok = tok0
    for i in range(STEPS):                 # the same steps, logits kept
        lg, st = tlm.decode_step(pt, st, tok, T + i, tcfg)
        _close(lg, jax_run["greedy"][i], LM_TOL)
        tok = torch.argmax(lg, -1)
    for a, b in zip(st_g["stack"], st["stack"]):      # every row written
        assert torch.equal(a.k_cache, b.k_cache)
        assert a.k_cache[:, :, T:].abs().amin(dim=(-1, -2)).gt(0).all()


def test_decode_from_a_carried_jax_state(setup, jax_run):
    """A JAX KV cache converted with state_from_jax decodes like the
    port's own prefill cache."""
    _, tcfg, _, pt, _, forced = setup
    st = convert.state_from_jax(jax_run["padded"])
    assert all(g.s is None and g.k_cache.dtype == torch.float32
               for g in st["stack"])
    for i in range(2):
        lg, st = tlm.decode_step(pt, st, torch.from_numpy(forced[:, i]).long(),
                                 T + i, tcfg)
        _close(lg, jax_run["steps"][i], LM_TOL)


def test_state_from_jax_keeps_bf16_caches():
    jcfg, _ = _cfgs("bfloat16")
    j_st = jlm.init_decode_state(jcfg, B, 8)
    j_st = jax.tree.map(lambda x: x + jnp.asarray(1.5, x.dtype), j_st)
    st = convert.state_from_jax(_np_tree(j_st))
    for t, j in zip(st["stack"], _np_tree(j_st)["stack"]):
        assert t.k_cache.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.v_cache.float().numpy(),
                                      j.v_cache.astype(np.float32))


def _env():
    import os
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # two intra-op threads, as the test process has: torch's default of
    # one per core, beside the other test workers, oversubscribes the
    # CPU and slows each step by two orders of magnitude
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    return env


def test_serve_softmax_cli_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-0.6b", "--smoke", "--device", "cpu", "--backend", "softmax",
         "--prompt-len", "16", "--gen-len", "6", "--batch", "2"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[0].startswith(
        "arch=qwen3-0.6b-smoke backend=softmax decode_kernel=auto (plain "
        "KV-cache read; prefill kernel flash_attention_fwd)")
    assert lines[1].startswith("prefill 16 toks x2:")
    assert lines[2].startswith("decode  6 toks x2:") and "tok/s" in lines[2]
    assert lines[3].startswith("decode state:") and "KV cache" in lines[3]


def test_serve_softmax_result_on_cpu():
    """Tokens of the asked shape, caches of prompt + generated rows, and
    no kernel launch on the CPU."""
    from repro_torch.launch import serve
    args = serve.parse_args(["--smoke", "--device", "cpu", "--backend",
                             "softmax", "--prompt-len", "8", "--gen-len",
                             "4", "--batch", "2"])
    out = serve.generate(args)
    cfg = get_smoke_config("qwen3-0.6b")
    assert out["tokens"].shape == (2, 4)
    assert out["prefill_launches"] == out["decode_launches"] == 0
    # k and v caches per layer: (B, 8 + 4, Hkv, Dh) in the smoke's bf16
    assert out["state_mib"] * 2**20 == (
        2 * cfg.n_layers * 2 * 12 * cfg.n_kv_heads * cfg.head_dim * 2)
