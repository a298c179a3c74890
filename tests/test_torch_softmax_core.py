"""The port's softmax baseline core and the paper's lookup primitives
against the JAX package, on the CPU.

* ``core/softmax_attention.py`` (``softmax_lookup``,
  ``causal_softmax_attention``, ``softmax_decode_step`` and the Table-1
  counters) and the document/query form of ``core/linear_attention.py``
  (``encode_document``, ``encode_document_streaming``, ``lookup``,
  ``softmax_lookup``): fp32 within 1e-5 relative to each output's
  largest magnitude; the counters equal.
* ``models/xla_attention.flash_attention`` under autograd against
  ``jax.vjp`` of JAX's custom-VJP ``flash_attention`` on K/V broadcast
  to the flat heads (as JAX's model broadcasts them): o and the forward's
  log-sum-exp within 1e-5, dq, dk and dv within 1e-4 of each gradient's
  largest magnitude (fp32 sums in other orders; dk and dv also summed
  over the G query groups), over GQA groups, T ≠ S with and without an
  offset, T below and above the block.
  The same o and gradients also against the port's own unblocked oracle
  ``full_causal_attention`` under autograd. In bf16 the gradients
  against JAX's bf16 vjp, at the bounds of bf16 rounding (see
  ``test_flash_attention_bf16_grads_match_jax``).
* JAX's oracles ``blocked_causal_attention`` and
  ``full_causal_attention`` within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jcore
from repro.core import linear_attention as jla
from repro.core import softmax_attention as jsa
from repro.models import xla_attention as jxa
import repro_torch.core as tcore
from repro_torch.core import linear_attention as tla
from repro_torch.core import softmax_attention as tsa
from repro_torch.kernels.flash_attention import ops
from repro_torch.models import xla_attention as txa

TOL, GRAD_TOL = 1e-5, 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _x(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(t, j, tol=TOL):
    """max|Δ| within ``tol`` of the reference's largest magnitude (at
    least 1)."""
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    assert t.shape == j.shape
    err = np.abs(t - j).max()
    assert err <= tol * max(1.0, np.abs(j).max()), err


# -- the paper's document / query form ---------------------------------------

@pytest.mark.parametrize("shape", [(24, 16), (3, 40, 8)])
def test_encode_document_and_streaming_match_jax(shape):
    h = _x(1, *shape)
    c = tla.encode_document(_t(h))
    _close(c, jla.encode_document(h))
    _close(tla.encode_document_streaming(_t(h)),
           jla.encode_document_streaming(h))
    assert c.shape == shape[:-2] + (shape[-1], shape[-1])


@pytest.mark.parametrize("q_shape", [(5, 16), (5, 3, 16)])
def test_lookup_matches_jax(q_shape):
    c = jla.encode_document(_x(2, 5, 30, 16))
    q = _x(3, *q_shape)
    _close(tla.lookup(_t(c), _t(q)), jla.lookup(c, q))


@pytest.mark.parametrize("q_shape", [(4, 12), (4, 3, 12)])
@pytest.mark.parametrize("module", ["linear_attention", "softmax_attention"])
def test_softmax_lookup_matches_jax(q_shape, module):
    h, q = 0.3 * _x(4, 4, 20, 12), _x(5, *q_shape)
    t_fn, j_fn = {"linear_attention": (tla, jla),
                  "softmax_attention": (tsa, jsa)}[module]
    out = t_fn.softmax_lookup(_t(h), _t(q))
    assert out.shape == q_shape and out.dtype == torch.float32
    _close(out, j_fn.softmax_lookup(h, q))


def test_linear_lookup_is_the_attention_it_compresses():
    """Paper §3.1: C q = Hᵀ(H q) for C = HᵀH, in the port alone."""
    h, q = _t(_x(6, 30, 10)), _t(_x(7, 10))
    torch.testing.assert_close(tla.lookup(tla.encode_document(h), q),
                               h.T @ (h @ q), rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("t,s", [(12, 12), (8, 20)])
@pytest.mark.parametrize("with_bias", [False, True])
def test_causal_softmax_attention_matches_jax(t, s, with_bias):
    q, k, v = _x(8, 2, 3, t, 16), _x(9, 2, 3, s, 16), _x(10, 2, 3, s, 16)
    bias = _x(11, t, s) if with_bias else None
    out = tsa.causal_softmax_attention(
        _t(q), _t(k), _t(v), bias=None if bias is None else _t(bias))
    _close(out, jsa.causal_softmax_attention(q, k, v, bias=bias))


@pytest.mark.parametrize("cache_len", [0, 5, 15])
def test_softmax_decode_step_matches_jax(cache_len):
    """One step at cache_len; 15 is past the 12-row cache, where JAX's
    dynamic update clamps the written row to the last."""
    kc, vc = _x(12, 2, 3, 12, 16), _x(13, 2, 3, 12, 16)
    q, kn, vn = (_x(14 + i, 2, 3, 16) for i in range(3))
    o_j, k_j, v_j = jsa.softmax_decode_step(kc, vc, jnp.int32(cache_len),
                                            q, kn, vn)
    kct = _t(kc)
    o_t, k_t, v_t = tsa.softmax_decode_step(kct, _t(vc), cache_len, _t(q),
                                            _t(kn), _t(vn))
    assert torch.equal(kct, _t(kc))                # the arguments unchanged
    _close(o_t, o_j)
    np.testing.assert_array_equal(k_t.numpy(), np.asarray(k_j))
    np.testing.assert_array_equal(v_t.numpy(), np.asarray(v_j))


@pytest.mark.parametrize("n,k,m", [(750, 100, 1), (10, 64, 7), (1, 1, 3)])
def test_table1_counters_match_jax(n, k, m):
    assert tsa.lookup_flops_softmax(n, k, m) == jsa.lookup_flops_softmax(
        n, k, m)
    assert tsa.lookup_flops_linear(k, m) == jsa.lookup_flops_linear(k, m)
    assert tsa.memory_softmax(n, k) == jsa.memory_softmax(n, k)
    assert tsa.memory_linear(k, 2) == jsa.memory_linear(k, 2)


def test_core_exports_match_jax():
    """``repro_torch.core`` exports what ``repro.core`` does, but for
    the second-order extension (not ported)."""
    names = {n for n in dir(jcore) if not n.startswith("_")
             and callable(getattr(jcore, n))} - {
        "second_order_params", "second_order_scan"}
    assert names <= set(dir(tcore))


# -- flash attention under autograd ------------------------------------------
# (B, G, Hkv, T, S, q_offset, block): GQA with T > block (several causal
# pairs), T < block, T < S with an offset, G = 1 with ragged T, T < S with
# the default offset, and every q head on one kv head

FLASH_CASES = [
    (2, 2, 2, 24, 24, 0, 16),
    (1, 2, 2, 40, 40, 0, 512),
    (2, 3, 1, 24, 56, 10, 16),
    (1, 1, 4, 33, 33, None, 16),
    (2, 2, 2, 20, 48, None, 16),
    (1, 4, 1, 50, 50, 0, 16),
]


def _flash_inputs(seed, b, g, hkv, t, s, d=16):
    q = _x(seed, b, g * hkv, t, d)
    k, v = _x(seed + 1, b, hkv, s, d), _x(seed + 2, b, hkv, s, d)
    do = _x(seed + 3, b, g * hkv, t, d)
    return q, k, v, do


def _jax_flash(q, k, v, do, g, q_offset, block):
    """JAX's custom-VJP flash on K/V broadcast to the flat heads, its
    vjp, and the forward's lse."""
    b, hkv, s, d = k.shape

    def flat(x):
        return jnp.broadcast_to(x[:, None], (b, g, hkv, s, d)).reshape(
            b, g * hkv, s, d)

    def f(q, k, v):
        return jxa.flash_attention(q, flat(k), flat(v), None, block,
                                   q_offset)
    o, vjp = jax.vjp(f, q, k, v)
    off = s - q.shape[2] if q_offset is None else q_offset
    _, lse = jxa._flash_fwd_impl(q, flat(k), flat(v), scale=d ** -0.5,
                                 block=block, off=off)
    return o, lse, vjp(jnp.asarray(do))


@pytest.mark.parametrize("b,g,hkv,t,s,q_offset,block", FLASH_CASES)
def test_flash_attention_o_lse_and_grads_match_jax(b, g, hkv, t, s,
                                                   q_offset, block):
    q, k, v, do = _flash_inputs(20, b, g, hkv, t, s)
    o_j, lse_j, (dq_j, dk_j, dv_j) = _jax_flash(q, k, v, do, g, q_offset,
                                                block)
    qt, kt, vt = (_t(x).requires_grad_() for x in (q, k, v))
    o_t = txa.flash_attention(qt, kt, vt, None, q_offset, block=block)
    o_t.backward(_t(do))
    _close(o_t, o_j)
    _, lse_t = ops.flash_attention(_t(q), _t(k), _t(v), t_off=q_offset,
                                   want_lse=True)
    assert lse_t.shape == (b, g * hkv, t) and lse_t.dtype == torch.float32
    _close(lse_t, lse_j)
    for grad, want in ((qt.grad, dq_j), (kt.grad, dk_j), (vt.grad, dv_j)):
        assert grad.dtype == torch.float32
        _close(grad, want, GRAD_TOL)
    # the port's own oracle, unblocked, differentiated by autograd
    xs = [_t(x).requires_grad_() for x in (q, k, v)]
    o_f = txa.full_causal_attention(xs[0].reshape(b, g, hkv, t, 16), *xs[1:],
                                    q_offset=q_offset).reshape(o_t.shape)
    o_f.backward(_t(do))
    _close(o_t, o_f.detach().numpy())
    for grad, x in zip((qt.grad, kt.grad, vt.grad), xs):
        _close(grad, x.grad.numpy(), GRAD_TOL)


def test_flash_attention_grads_on_both_routes_and_no_launch_on_cpu():
    """On CPU tensors the kernel route and ``kernel=False`` are the same
    plain forward and backward, bit for bit, and count no launch; without
    autograd the call is the forward alone."""
    q, k, v, do = (_t(x) for x in _flash_inputs(30, 2, 2, 2, 24, 24))
    before = ops.fwd.launches
    grads = []
    for kernel in (True, False):
        xs = [x.clone().requires_grad_() for x in (q, k, v)]
        o = txa.flash_attention(*xs, None, 0, block=16, kernel=kernel)
        o.backward(do)
        grads.append([o.detach()] + [x.grad for x in xs])
    assert ops.fwd.launches == before
    for a, b in zip(*grads):
        assert torch.equal(a, b)
    with torch.no_grad():
        assert torch.equal(txa.flash_attention(q, k, v, None, 0),
                           grads[0][0])


def test_flash_backward_of_bf16_inputs_keeps_their_types():
    """bf16 q, k, v: the gradients come back in bf16, close to the fp32
    run's (ds and p rounded to bf16 before their products, as in JAX)."""
    q, k, v, do = (_t(x) for x in _flash_inputs(40, 1, 2, 2, 24, 24))
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        xs = [x.to(dtype).clone().requires_grad_() for x in (q, k, v)]
        txa.flash_attention(*xs, None, 0, block=16).backward(do.to(dtype))
        runs[dtype] = [x.grad for x in xs]
    for a, b in zip(runs[torch.bfloat16], runs[torch.float32]):
        assert a.dtype == torch.bfloat16
        err = (a.float() - b).abs().max() / b.abs().max()
        assert err < 3e-2, err


BF16_ULP = 2.0 ** -8       # bf16's largest relative rounding error


def _normwise(t, want):
    t = t.detach().float().numpy()
    return np.linalg.norm(t - want) / np.linalg.norm(want)


@pytest.mark.parametrize("b,g,hkv,t,s,q_offset,block",
                         FLASH_CASES + [(2, 1, 2, 24, 56, 10, 16)])
def test_flash_attention_bf16_grads_match_jax(b, g, hkv, t, s, q_offset,
                                              block):
    """bf16 q, k, v, do through the port's autograd against ``jax.vjp`` of
    JAX's custom-VJP ``flash_attention`` in bf16 on K/V broadcast to the
    flat heads. Both round ds to k's type before the dq and dk products
    and p to do's type before dv, and accumulate in fp32 in other orders,
    so dq (and dk, dv where G = 1) are the same bf16 roundings: normwise
    within 2^-10, where leaving ds or p unrounded moves them by about
    2^-9. Where G > 1, JAX rounds each flat head's dk and dv to bf16 before
    the broadcast's transpose sums them, and the port sums the G heads in
    fp32 and rounds once: against JAX's per-head gradients summed, within
    the rounding bound 2^-8 · (Σ_g ‖dk_g‖ + ‖Σ_g dk_g‖) / ‖Σ_g dk_g‖."""
    q, k, v, do = _flash_inputs(60, b, g, hkv, t, s)
    h = g * hkv

    def flat(x):
        return jnp.broadcast_to(x[:, None], (b, g, hkv, s, 16)).reshape(
            b, h, s, 16)

    def f(q, kf, vf):
        return jxa.flash_attention(q, kf, vf, None, block, q_offset)
    bf = [jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, do)]
    _, vjp = jax.vjp(f, bf[0], flat(bf[1]), flat(bf[2]))
    dq_j, dkf_j, dvf_j = (np.asarray(x.astype(jnp.float32))
                          for x in vjp(bf[3]))
    xs = [_t(x).to(torch.bfloat16).requires_grad_() for x in (q, k, v)]
    txa.flash_attention(*xs, None, q_offset, block=block).backward(
        _t(do).to(torch.bfloat16))
    assert all(x.grad.dtype == torch.bfloat16 for x in xs)
    assert _normwise(xs[0].grad, dq_j) <= 2.0 ** -10
    for grad, per_head in ((xs[1].grad, dkf_j), (xs[2].grad, dvf_j)):
        per_head = per_head.reshape(b, g, hkv, s, 16)
        want = per_head.sum(1)
        tol = 2.0 ** -10 if g == 1 else BF16_ULP * (
            sum(np.linalg.norm(per_head[:, i]) for i in range(g))
            + np.linalg.norm(want)) / np.linalg.norm(want)
        assert _normwise(grad, want) <= tol


# -- JAX's oracles ------------------------------------------------------------

@pytest.mark.parametrize("t,s,q_offset,kv_len", [(24, 24, None, None),
                                                  (10, 30, 5, None),
                                                  (20, 20, 0, 13)])
def test_blocked_and_full_causal_attention_match_jax(t, s, q_offset,
                                                     kv_len):
    q = _x(50, 2, 2, 3, t, 16)
    k, v = _x(51, 2, 3, s, 16), _x(52, 2, 3, s, 16)
    kw = dict(q_block=8, kv_block=16, q_offset=q_offset)
    out = txa.blocked_causal_attention(_t(q), _t(k), _t(v), kv_len=kv_len,
                                       **kw)
    _close(out, jxa.blocked_causal_attention(
        q, k, v, kv_len=None if kv_len is None else jnp.int32(kv_len), **kw))
    _close(txa.full_causal_attention(_t(q), _t(k), _t(v), q_offset=q_offset),
           jxa.full_causal_attention(q, k, v, q_offset=q_offset))
