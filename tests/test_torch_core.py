"""Port's core linear-attention functions against the JAX package
(``repro.core.linear_attention``), same numpy inputs, fp32, 1e-5."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_attention as jla
from repro_torch.core import linear_attention as tla

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, positive=False):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return np.abs(x) + 0.1 if positive else x


def _close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL, atol=TOL)


def test_safe_denom_matches_including_zero_and_negative():
    d = np.array([0.0, -0.0, 1e-8, -1e-8, 1e-6, -1e-6, 0.5, -0.5, 3e4,
                  -3e4], np.float32)
    out = tla.safe_denom(torch.from_numpy(d))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jla.safe_denom(jnp.asarray(d))))
    assert out[0] == 1e-6 and out[3] < 0


@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("t", [16, 21])           # 21: not a chunk multiple
def test_chunked_matches_jax(t, normalize, carry):
    b, h, dk, dv, chunk = 2, 3, 8, 12, 8
    q = _rand(1, b, h, t, dk, positive=True)
    k = _rand(2, b, h, t, dk, positive=True)
    v = _rand(3, b, h, t, dv)
    s0 = _rand(4, b, h, dk, dv) if carry else None
    z0 = _rand(5, b, h, dk, positive=True) if carry else None
    o_j, s_j = jla.causal_linear_attention_chunked(
        q, k, v, chunk_size=chunk, initial_state=s0, initial_z=z0,
        normalize=normalize)
    as_t = lambda a: None if a is None else torch.from_numpy(a)
    o_t, s_t = tla.causal_linear_attention_chunked(
        as_t(q), as_t(k), as_t(v), chunk_size=chunk, initial_state=as_t(s0),
        initial_z=as_t(z0), normalize=normalize)
    assert o_t.shape == (b, h, t, dv)
    _close(o_t, o_j)
    _close(s_t, s_j)


@pytest.mark.parametrize("normalize", [False, True])
def test_scan_matches_jax_and_chunked(normalize):
    b, h, t, d = 2, 2, 11, 8
    q = _rand(6, b, h, t, d, positive=True)
    k = _rand(7, b, h, t, d, positive=True)
    v = _rand(8, b, h, t, d)
    s0 = _rand(9, b, h, d, d)
    o_j, s_j = jla.causal_linear_attention_scan(
        q, k, v, initial_state=s0, normalize=normalize)
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    o_t, s_t = tla.causal_linear_attention_scan(
        qt, kt, vt, initial_state=torch.from_numpy(s0), normalize=normalize)
    _close(o_t, o_j)
    _close(s_t, s_j)
    o_c, s_c = tla.causal_linear_attention_chunked(
        qt, kt, vt, chunk_size=4, initial_state=torch.from_numpy(s0),
        normalize=normalize)
    torch.testing.assert_close(o_c, o_t, rtol=TOL, atol=TOL)
    torch.testing.assert_close(s_c, s_t, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("normalize", [False, True])
def test_decode_step_matches_jax(normalize):
    b, h, d = 2, 3, 16
    s = _rand(10, b, h, d, d)
    q, k = _rand(11, b, h, d, positive=True), _rand(12, b, h, d, positive=True)
    v, z = _rand(13, b, h, d), _rand(14, b, h, d, positive=True)
    o_j, s_j, z_j = jla.decode_step(s, q, k, v, z=z, normalize=normalize)
    st = torch.from_numpy(s)
    o_t, s_t, z_t = tla.decode_step(
        st, torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        z=torch.from_numpy(z), normalize=normalize)
    _close(o_t, o_j)
    _close(s_t, s_j)
    np.testing.assert_array_equal(st.numpy(), s)       # input untouched
    if normalize:
        _close(z_t, z_j)
    else:
        assert z_t is None and z_j is None
