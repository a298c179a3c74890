"""Port of the fused W-step linear decode (B1) against the JAX package.

On the CPU the port's wrapper runs its plain PyTorch version; it is held
against the JAX wrapper running the Pallas kernel body through the
Pallas interpreter, at rtol = atol = 1e-5 on o, S and z (fp32, sums in
another order). The CUDA kernel itself is held against the plain version
on the card by ``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from repro.kernels.fused_recurrent import ops as jax_ops
from repro_torch.kernels.fused_recurrent import ops

TOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _elu1(x):
    return np.where(x > 0, x + 1.0, np.exp(np.minimum(x, 0.0))).astype(
        np.float32)


def _inputs(seed, b, h, w, d):
    """q, k elu1-positive (the normaliser's operating regime)."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(q=_elu1(f(b, h, w, d)), k=_elu1(f(b, h, w, d)),
                v=f(b, h, w, d), s=f(b, h, d, d),
                z=np.abs(f(b, h, d)) + 0.5)


def _lens(kind, b, w):
    if kind is None:
        return None
    # 0, a value between 0 and W (where W > 1), and W
    return np.array([0, min(2, w), w][:b], np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("lens_kind", [None, "mixed"])
@pytest.mark.parametrize("w", [1, 5])
@pytest.mark.parametrize("normalize", [False, True])
def test_matches_jax_pallas_interpret(normalize, w, lens_kind):
    b, h, d = 3, 2, 16                      # B·H = 6: not a power of two
    x = _inputs(7 + w, b, h, w, d)
    lens = _lens(lens_kind, b, w)
    z = x["z"] if normalize else None
    o_j, s_j, z_j = jax_ops.fused_recurrent_linear(
        x["s"], x["q"], x["k"], x["v"], z=z, normalize=normalize,
        lens=lens, interpret=True)

    s_t, z_t = _t(x["s"]), _t(x["z"]) if normalize else None
    o_t, s_out, z_out = ops.fused_recurrent_linear(
        s_t, _t(x["q"]), _t(x["k"]), _t(x["v"]), z=z_t,
        normalize=normalize, lens=None if lens is None else _t(lens))

    assert s_out is s_t                     # updated in place
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=TOL,
                               atol=TOL)
    if normalize:
        assert z_out is z_t
        np.testing.assert_allclose(z_t.numpy(), np.asarray(z_j), rtol=TOL,
                                   atol=TOL)
    else:
        assert z_out is None and z_j is None


@pytest.mark.parametrize("normalize", [False, True])
def test_lens_zero_rows_bitwise_unchanged(normalize):
    b, h, w, d = 3, 2, 4, 16
    x = _inputs(3, b, h, w, d)
    lens = torch.tensor([0, 2, 0], dtype=torch.int32)
    s0, z0 = _t(x["s"]), _t(x["z"])
    s, z = s0.clone(), z0.clone()
    o, _, _ = ops.fused_recurrent_linear(
        s, _t(x["q"]), _t(x["k"]), _t(x["v"]), z=z if normalize else None,
        normalize=normalize, lens=lens)
    for row in (0, 2):
        assert torch.equal(s[row], s0[row])
        assert torch.equal(z[row], z0[row])
        assert torch.count_nonzero(o[row]) == 0
    assert torch.count_nonzero(o[1, :, 2:]) == 0      # steps w >= lens
    assert not torch.equal(s[1], s0[1])


def _flat(n=4, w=2, d=16, dtype=torch.float32):
    g = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=g)
    pos = lambda *shape: r(*shape).abs() + 0.1   # keeps q·z off zero
    return dict(s=r(n, d, d), q=pos(n, w, d).to(dtype),
                k=pos(n, w, d).to(dtype), v=r(n, w, d).to(dtype),
                z=pos(n, d), lens=None)


@pytest.mark.parametrize("bad,err", [
    (dict(s=torch.zeros(4, 16, 16, dtype=torch.float64)), TypeError),
    (dict(s=torch.zeros(4, 24, 24)), ValueError),          # head dim
    (dict(s=torch.zeros(4, 16, 8)), ValueError),           # Dk != Dv
    (dict(q=torch.zeros(4, 2, 16, dtype=torch.float16)), TypeError),
    (dict(v=torch.zeros(4, 3, 16)), ValueError),           # shape
    (dict(z=torch.zeros(4, 16, dtype=torch.bfloat16)), ValueError),
    (dict(lens=torch.zeros(4, dtype=torch.int64)), ValueError),
    (dict(k=torch.zeros(4, 16, 2).transpose(1, 2)), ValueError),  # strided
])
def test_kernel_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    x = {**_flat(), **bad}
    with pytest.raises(err):
        ops._check(x["s"], x["q"], x["k"], x["v"], x["z"], True, x["lens"])


def test_kernel_wrapper_accepts_the_main_path_types():
    for dtype in (torch.float32, torch.bfloat16):
        x = _flat(dtype=dtype)
        ops._check(x["s"], x["q"], x["k"], x["v"], x["z"], True,
                   torch.zeros(4, dtype=torch.int32))


def test_normalize_needs_z():
    x = _flat()
    with pytest.raises(ValueError):
        ops.decode_linear(x["s"], x["q"], x["k"], x["v"], normalize=True)
