"""Port of the gated (decay) core and the gated W-step decode (B7) against
the JAX package, on the CPU.

- ``core/gated.py``: ``gla_scan``, ``chunked_gla`` (T not a chunk
  multiple, carried ``initial_state``, scalar (B, H, T, 1) decay, the
  exclusive form with ``u``, the [-1, 0] clamp biting at chunk 16) and
  ``gated_decode_step``, fp32, rtol = atol = 1e-5 (sums in another
  order).
- ``fused_recurrent_gated_ref`` and the CPU route of the wrapper against
  JAX's Pallas ``decode_gated`` through the interpreter and against
  JAX's ref, at 1e-5; lens-0 rows bitwise unchanged within the port.
- ``groupnorm_heads`` at 1e-5; the wrapper's refusals.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gated as jg
from repro.kernels.fused_recurrent import ops as jax_ops
from repro.kernels.fused_recurrent import ref as jax_ref
from repro.models import layers as JL
from repro_torch.core import gated as tg
from repro_torch.kernels.fused_recurrent import ops, ref
from repro_torch.models import layers as TL

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


def _qkvg(seed, b, h, t, d, *, scalar=False, g_low=-0.5):
    """elu1-positive q, k (the model's feature map), signed v, and a
    log-decay uniform in [g_low, 0]."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    g = rng.uniform(g_low, 0.0, (b, h, t, 1 if scalar else d)).astype(
        np.float32)
    return _elu1(f(b, h, t, d)), _elu1(f(b, h, t, d)), f(b, h, t, d), g


def _t(a):
    return None if a is None else torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=tol, atol=tol)


# -- core --------------------------------------------------------------------

@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("carry", [False, True])
@pytest.mark.parametrize("exclusive", [False, True])
def test_gla_scan_matches_jax(scalar, carry, exclusive):
    b, h, t, d = 2, 3, 9, 8
    q, k, v, g = _qkvg(1, b, h, t, d, scalar=scalar)
    rng = np.random.default_rng(2)
    s0 = rng.standard_normal((b, h, d, d)).astype(np.float32) if carry \
        else None
    u = rng.standard_normal((h, d)).astype(np.float32) if exclusive \
        else None
    o_j, s_j = jg.gla_scan(q, k, v, g, initial_state=s0,
                           exclusive=exclusive, u=u)
    o_t, s_t = tg.gla_scan(_t(q), _t(k), _t(v), _t(g),
                           initial_state=_t(s0), exclusive=exclusive,
                           u=_t(u))
    _close(o_t, o_j)
    _close(s_t, s_j)


@pytest.mark.parametrize("case", [
    "inclusive", "ragged_tail", "initial_state", "scalar", "exclusive_u",
    "exclusive_no_u", "clamp_bites"])
def test_chunked_gla_matches_jax(case):
    b, h, d = 2, 2, 8
    t, chunk = (20, 8) if case == "ragged_tail" else (32, 16)
    g_low = -3.0 if case == "clamp_bites" else -0.5
    q, k, v, g = _qkvg(3, b, h, t, d, scalar=case == "scalar", g_low=g_low)
    rng = np.random.default_rng(4)
    kw = {}
    if case == "initial_state":
        kw["initial_state"] = rng.standard_normal((b, h, d, d)).astype(
            np.float32)
    if case.startswith("exclusive"):
        kw["exclusive"] = True
        if case == "exclusive_u":
            kw["u"] = rng.standard_normal((h, d)).astype(np.float32)
    if case == "clamp_bites":
        assert (g < -1.0).mean() > 0.5
    o_j, s_j = jg.chunked_gla(q, k, v, g, chunk_size=chunk, **kw)
    o_t, s_t = tg.chunked_gla(_t(q), _t(k), _t(v), _t(g), chunk_size=chunk,
                              **{n: _t(x) if isinstance(x, np.ndarray)
                                 else x for n, x in kw.items()})
    assert np.isfinite(np.asarray(o_j)).all()
    _close(o_t, o_j)
    _close(s_t, s_j)
    if case == "clamp_bites":
        # the clamp changes the answer: chunked_gla is the scan of the
        # clamped decay, not of the decay as given
        o_c, _ = tg.gla_scan(_t(q), _t(k), _t(v), _t(np.maximum(g, -1.0)))
        o_s, _ = tg.gla_scan(_t(q), _t(k), _t(v), _t(g))
        torch.testing.assert_close(o_t, o_c, rtol=1e-4, atol=1e-4)
        assert not torch.allclose(o_t, o_s, rtol=1e-2, atol=1e-2)


def test_chunked_gla_matches_the_scan_inside_the_port():
    """Within the port, with the decay inside the clamp's range, the
    chunk-parallel form and the recurrence agree."""
    q, k, v, g = _qkvg(5, 2, 2, 37, 8)
    o_c, s_c = tg.chunked_gla(_t(q), _t(k), _t(v), _t(g), chunk_size=16)
    o_s, s_s = tg.gla_scan(_t(q), _t(k), _t(v), _t(g))
    torch.testing.assert_close(o_c, o_s, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s_c, s_s, rtol=1e-4, atol=1e-4)


def test_chunk_pads_like_jax():
    x = np.random.default_rng(0).standard_normal((1, 2, 7, 3)).astype(
        np.float32)
    np.testing.assert_array_equal(tg._chunk(_t(x), 4).numpy(),
                                  np.asarray(jg._chunk(x, 4)))
    assert (tg.DEFAULT_CHUNK, tg.MIN_LOG_DECAY) == (jg.DEFAULT_CHUNK,
                                                    jg.MIN_LOG_DECAY)


@pytest.mark.parametrize("mode", ["vector", "scalar", "exclusive_u",
                                  "strong_decay"])
def test_gated_decode_step_matches_jax(mode):
    b, h, d = 2, 3, 8
    rng = np.random.default_rng(6)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    s, q, k, v = f(b, h, d, d), f(b, h, d), f(b, h, d), f(b, h, d)
    g = -np.abs(f(b, h, 1 if mode == "scalar" else d))
    if mode == "strong_decay":
        g = g - 5.0              # no clamp in decode: exp(g) as given
    kw = {}
    if mode == "exclusive_u":
        kw = dict(exclusive=True, u=f(h, d))
    o_j, s_j = jg.gated_decode_step(s, q, k, v, g, **kw)
    s_in = _t(s)
    o_t, s_t = tg.gated_decode_step(s_in, _t(q), _t(k), _t(v), _t(g),
                                    **{n: _t(x) if isinstance(x, np.ndarray)
                                       else x for n, x in kw.items()})
    assert torch.equal(s_in, _t(s))                  # inputs untouched
    _close(o_t, o_j)
    _close(s_t, s_j)


# -- the gated W-step decode (B7): plain version and CPU route -------------

def _decode_inputs(seed, b, h, w, d):
    q, k, v, g = _qkvg(seed, b, h, w, d, g_low=-2.0)
    s = np.random.default_rng(seed + 1).standard_normal((b, h, d, d)
                                                        ).astype(np.float32)
    return s, q, k, v, g


def _lens(kind, b, w):
    if kind is None:
        return None
    return np.array([0, min(2, w), w + 3][:b], np.int32)   # 0, mid, > W


@pytest.mark.parametrize("lens_kind", [None, "mixed"])
@pytest.mark.parametrize("w", [1, 4])
def test_fused_recurrent_gated_matches_jax(w, lens_kind):
    b, h, d = 3, 2, 16                      # B·H = 6: not a power of two
    s, q, k, v, g = _decode_inputs(7 + w, b, h, w, d)
    lens = _lens(lens_kind, b, w)
    o_p, s_p = jax_ops.fused_recurrent_gated(s, q, k, v, g, lens=lens,
                                             interpret=True)
    o_r, s_r = jax_ref.fused_recurrent_gated_ref(
        s, q, k, v, g, lens=None if lens is None else jnp.asarray(lens))

    o_ref, s_ref = ref.fused_recurrent_gated_ref(
        _t(s), _t(q), _t(k), _t(v), _t(g), lens=_t(lens))
    s_t = _t(s)
    o_t, s_out = ops.fused_recurrent_gated(s_t, _t(q), _t(k), _t(v), _t(g),
                                           lens=_t(lens))
    assert s_out is s_t                     # updated in place
    for o_j, s_j in ((o_p, s_p), (o_r, s_r)):
        _close(o_ref, o_j)
        _close(s_ref, s_j)
        _close(o_t, o_j)
        _close(s_t, s_j)


def test_lens_zero_rows_bitwise_unchanged():
    b, h, w, d = 3, 2, 4, 16
    s, q, k, v, g = _decode_inputs(3, b, h, w, d)
    lens = torch.tensor([0, 2, 0], dtype=torch.int32)
    s0 = _t(s)
    st = s0.clone()
    launches = ops.decode_gated.launches
    o, _ = ops.fused_recurrent_gated(st, _t(q), _t(k), _t(v), _t(g),
                                     lens=lens)
    assert ops.decode_gated.launches == launches     # no kernel on the CPU
    for row in (0, 2):
        assert torch.equal(st[row], s0[row])
        assert torch.count_nonzero(o[row]) == 0
    assert torch.count_nonzero(o[1, :, 2:]) == 0      # steps w >= lens
    assert not torch.equal(st[1], s0[1])


def test_window_equals_single_steps():
    """Within the port: a W-step window == W one-step windows, and the W
    == 1 shortcut == the masked loop with lens = 1."""
    s, q, k, v, g = _decode_inputs(11, 2, 2, 3, 16)
    o_w, s_w = ref.fused_recurrent_gated_ref(_t(s), _t(q), _t(k), _t(v),
                                             _t(g))
    st = _t(s)
    for i in range(3):
        o_i, st = ref.fused_recurrent_gated_ref(
            st, _t(q[:, :, i:i + 1]), _t(k[:, :, i:i + 1]),
            _t(v[:, :, i:i + 1]), _t(g[:, :, i:i + 1]))
        assert torch.equal(o_i[:, :, 0], o_w[:, :, i])
    assert torch.equal(st, s_w)
    o_1, s_1 = ref.fused_recurrent_gated_ref(
        _t(s), _t(q[:, :, :1]), _t(k[:, :, :1]), _t(v[:, :, :1]),
        _t(g[:, :, :1]), lens=torch.ones(2, dtype=torch.int32))
    assert torch.equal(s_1, ref.fused_recurrent_gated_ref(
        _t(s), _t(q[:, :, :1]), _t(k[:, :, :1]), _t(v[:, :, :1]),
        _t(g[:, :, :1]))[1])


# -- groupnorm ---------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_groupnorm_heads_matches_jax(dtype):
    rng = np.random.default_rng(8)
    x = (3.0 * rng.standard_normal((2, 5, 4, 16)) + 1.0).astype(np.float32)
    scale = (1.0 + 0.3 * rng.standard_normal((4, 16))).astype(np.float32)
    bias = (0.1 * rng.standard_normal((4, 16))).astype(np.float32)
    if dtype == "bfloat16":
        xj = jnp.asarray(x, jnp.bfloat16)
        xt = torch.from_numpy(x).bfloat16()
        tol = 1e-2                          # one bf16 rounding of the output
    else:
        xj, xt, tol = x, torch.from_numpy(x), TOL
    y_j = JL.groupnorm_heads(xj, scale, bias)
    y_t = TL.groupnorm_heads(xt, torch.from_numpy(scale),
                             torch.from_numpy(bias))
    assert y_t.dtype == xt.dtype
    np.testing.assert_allclose(y_t.float().numpy(),
                               np.asarray(y_j.astype(jnp.float32)),
                               rtol=tol, atol=tol)


# -- the wrapper's checks (what the kernel takes) ---------------------------

def _flat(n=4, w=2, d=16, dtype=torch.float32):
    gen = torch.Generator().manual_seed(0)
    r = lambda *shape: torch.randn(shape, generator=gen)
    return dict(s=r(n, d, d), q=r(n, w, d).to(dtype), k=r(n, w, d).to(dtype),
                v=r(n, w, d).to(dtype), g=-r(n, w, d).abs(), lens=None)


@pytest.mark.parametrize("bad,err", [
    (dict(g=torch.zeros(4, 2, 16, dtype=torch.bfloat16)), ValueError),
    (dict(g=torch.zeros(4, 2, 1)), ValueError),             # not broadcast
    (dict(g=torch.zeros(4, 16, 2).transpose(1, 2)), ValueError),  # strided
    (dict(lens=torch.zeros(4, dtype=torch.int64)), ValueError),
    (dict(lens=torch.zeros(2, dtype=torch.int32)), ValueError),   # shape
    (dict(k=torch.zeros(4, 16, 2).transpose(1, 2)), ValueError),  # strided
    (dict(q=torch.zeros(4, 2, 16, dtype=torch.bfloat16)), TypeError),
    (dict(s=torch.zeros(4, 24, 24)), ValueError),            # head dim
    (dict(s=torch.zeros(4, 16, 16, dtype=torch.float64)), TypeError),
])
def test_gated_wrapper_rejects_what_the_kernel_does_not_take(bad, err):
    x = {**_flat(), **bad}
    with pytest.raises(err):
        ops._check_gated(x["s"], x["q"], x["k"], x["v"], x["g"], x["lens"])


def test_gated_wrapper_accepts_bf16_rows_with_fp32_decay():
    """The main path: q, k, v in bf16, the log-decay in fp32."""
    for dtype in (torch.float32, torch.bfloat16):
        x = _flat(dtype=dtype)
        ops._check_gated(x["s"], x["q"], x["k"], x["v"], x["g"],
                         torch.zeros(4, dtype=torch.int32))
