"""Port's linear attention layer against the JAX package on the same
weights: prefill (``attention_apply`` with its state), one-token decode
and W-token windows with and without ``lens``. JAX runs with
``decode_kernel="fused"``, i.e. the Pallas decode kernel through the
interpreter. qwen3-0.6b smoke config (GQA 4/2, qk-norm, RoPE), fp32,
1e-5."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import attention as JA
from repro.sharding import Rules
from repro_torch.configs import get_smoke_config
from repro_torch.models import attention as TA

TOL = 1e-5
RULES = Rules.null()


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _cfgs(normalize=True):
    kw = dict(attention_backend="linear", dtype="float32",
              linear_normalize=normalize)
    return (dataclasses.replace(jax_smoke_config("qwen3-0.6b"),
                                decode_kernel="fused", **kw),
            dataclasses.replace(get_smoke_config("qwen3-0.6b"), **kw))


def _params(jcfg):
    p = JA.attention_params(jax.random.PRNGKey(3), jcfg)
    # non-trivial qk-norm scales, so the norm's placement matters
    rng = np.random.default_rng(0)
    p = {k: np.asarray(v) for k, v in p.items()}
    for name in ("q_norm", "k_norm"):
        p[name] = (1.0 + 0.3 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    return p, {k: torch.from_numpy(v.copy()) for k, v in p.items()}


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def _state(seed, cfg, b):
    h, dh = cfg.n_heads, cfg.head_dim
    s = 0.1 * _x(seed, b, h, dh, dh)
    z = np.abs(_x(seed + 1, b, h, dh)) + 1.0
    return s, z


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("t", [16, 24])
def test_attention_apply_with_state(t, normalize):
    jcfg, tcfg = _cfgs(normalize)
    pj, pt = _params(jcfg)
    x = _x(1, 2, t, jcfg.d_model)
    y_j, st_j = JA.attention_apply(pj, x, jcfg, RULES, want_state=True)
    y_t, st_t = TA.attention_apply(pt, torch.from_numpy(x), tcfg,
                                   want_state=True)
    if normalize:
        _close(y_t, y_j)
    else:
        # unnormalised outputs grow with T (to ~1e2 here); fp32 rounding
        # is relative to that scale, so the 1e-5 is taken relative to it
        scale = float(np.abs(np.asarray(y_j)).max())
        np.testing.assert_allclose(y_t.numpy() / scale,
                                   np.asarray(y_j) / scale, rtol=TOL,
                                   atol=TOL)
    _close(st_t.s, st_j.s)
    if normalize:
        _close(st_t.z, st_j.z)
    else:
        assert st_t.z is None and st_j.z is None


@pytest.mark.parametrize("pos", [5, "per_row"])
def test_attention_decode(pos):
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg)
    b = 3
    x = _x(2, b, jcfg.d_model)
    s, z = _state(4, jcfg, b)
    pos_np = (np.array([3, 9, 17], np.int32) if pos == "per_row"
              else np.int32(pos))
    y_j, st_j = JA.attention_decode(pj, x, JA.AttnState(None, None, s, z),
                                    pos_np, jcfg, RULES)
    st_t = TA.AttnState(s=torch.from_numpy(s.copy()),
                        z=torch.from_numpy(z.copy()))
    y_t, new_t = TA.attention_decode(pt, torch.from_numpy(x), st_t,
                                     torch.from_numpy(np.asarray(pos_np)),
                                     tcfg)
    assert new_t.s is st_t.s                       # updated in place
    _close(y_t, y_j)
    _close(st_t.s, st_j.s)
    _close(st_t.z, st_j.z)


@pytest.mark.parametrize("lens", [None, [0, 2, 4], [4, 1, 3]])
def test_attention_decode_window(lens):
    jcfg, tcfg = _cfgs()
    pj, pt = _params(jcfg)
    b, w = 3, 4
    x = _x(5, b, w, jcfg.d_model)
    s, z = _state(6, jcfg, b)
    pos0 = np.array([0, 7, 30], np.int32)
    lens_np = None if lens is None else np.array(lens, np.int32)
    y_j, st_j = JA.attention_decode_window(
        pj, x, JA.AttnState(None, None, s, z), pos0, jcfg, RULES,
        lens=lens_np)
    st_t = TA.AttnState(s=torch.from_numpy(s.copy()),
                        z=torch.from_numpy(z.copy()))
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
                np.testing.assert_array_equal(st_t.z[row].numpy(), z[row])
    _close(st_t.s, st_j.s)
    _close(st_t.z, st_j.z)


def test_decode_reference_kernel_choice_agrees():
    """decode_kernel="reference" (the plain version asked for explicitly)
    and the kernel wrapper give the same layer output on the CPU."""
    _, tcfg = _cfgs()
    _, pt = _params(_cfgs()[0])
    x = torch.from_numpy(_x(7, 2, 3, tcfg.d_model))
    s, z = _state(8, tcfg, 2)
    outs = []
    for kernel in ("auto", "reference"):
        st = TA.AttnState(s=torch.from_numpy(s.copy()),
                          z=torch.from_numpy(z.copy()))
        y, st = TA.attention_decode_window(
            pt, x, st, torch.tensor(4), dataclasses.replace(
                tcfg, decode_kernel=kernel))
        outs.append((y, st.s, st.z))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
