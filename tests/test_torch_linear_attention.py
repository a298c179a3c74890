"""The port's chunked linear attention (B2 forward, B3's §3.3 backward)
against the JAX package on the CPU, from the same numpy inputs: the
plain versions against the Pallas ``kernel.fwd``/``kernel.bwd`` in
interpret mode and against ``linear_attention_ref`` /
``linear_attention_grads_ref``; the autograd function against
``jax.vjp`` of the Pallas wrapper and of the jnp
``causal_linear_attention``.

Tolerances, normwise (max|Δ| ≤ TOL · max|JAX|): fp32 1e-5 (the two
frameworks sum in other orders); bf16 8e-3, two bf16 ulps of the largest
element (both sides sum in fp32 and round the result to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import linear_attention as jcore
from repro.kernels.linear_attention import kernel as jkernel
from repro.kernels.linear_attention import ops as jops
from repro.kernels.linear_attention import ref as jref
from repro_torch.core import linear_attention as tcore
from repro_torch.kernels.linear_attention import ops as tops
from repro_torch.kernels.linear_attention import ref as tref

TOL = {"float32": 1e-5, "bfloat16": 8e-3}
CHUNK = 16
BH, D = 3, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, *shape):
    """q, k positive (the model's elu1 regime), v and do signed."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    return [np.abs(x[0]) + 0.1, np.abs(x[1]) + 0.1, x[2], x[3]]


def _as(x, dtype):
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(t, j, tol, what=""):
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = np.abs(t - j).max()
    assert err <= tol * np.abs(j).max(), f"{what}: max|Δ| {err}"


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fwd_matches_pallas_fwd_and_ref(dtype):
    """T a multiple of the chunk: the plain B2 against Pallas ``fwd``
    (interpret mode) and the quadratic direct form."""
    xs = [_as(x, dtype) for x in _inputs(0, BH, 48, D)[:3]]
    o_j, s_j = jkernel.fwd(*(j for j, _ in xs), chunk=CHUNK, interpret=True)
    o_t, s_t = tops.fwd(*(t for _, t in xs), chunk=CHUNK)
    assert o_t.dtype == getattr(torch, dtype) and s_t.dtype == torch.float32
    _close(o_t, o_j, TOL[dtype], "o")
    _close(s_t, s_j, TOL["float32"], "state")
    o_r, s_r = jref.linear_attention_ref(*(j for j, _ in xs))
    _close(o_t, o_r, TOL[dtype], "o vs ref")
    _close(s_t, s_r, TOL["float32"], "state vs ref")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_bwd_and_grads_ref(dtype):
    xs = [_as(x, dtype) for x in _inputs(1, BH, 48, D)]
    got = tops.bwd(*(t for _, t in xs), chunk=CHUNK)
    want = jkernel.bwd(*(j for j, _ in xs), chunk=CHUNK, interpret=True)
    closed = jref.linear_attention_grads_ref(*(j for j, _ in xs))
    for name, t, j, r in zip(("dq", "dk", "dv"), got, want, closed):
        assert t.dtype == getattr(torch, dtype)
        _close(t, j, TOL[dtype], name)
        _close(t, r, TOL[dtype], name + " vs closed form")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [48, 40])       # 40: not a chunk multiple
def test_with_state_matches_jax_wrapper(dtype, t):
    """The (B, H, T, D) wrapper's reshapes and padding rule against the
    JAX wrapper's, forward and final state."""
    xs = [_as(x, dtype) for x in _inputs(2, 1, BH, t, D)[:3]]
    o_j, s_j = jops.linear_attention_with_state(
        *(j for j, _ in xs), chunk=CHUNK, interpret=True)
    o_t, s_t = tops.linear_attention_with_state(*(t for _, t in xs),
                                                chunk=CHUNK)
    _close(o_t, o_j, TOL[dtype], "o")
    _close(s_t, s_j, TOL["float32"], "state")


@pytest.mark.parametrize("t,chunk", [(48, 16), (40, 16), (5, 16), (64, 64),
                                     (100, 64), (1024, 128), (1000, 128)])
def test_chunk_and_padding_rule_is_jax_s(t, chunk):
    c = min(chunk, t) if t % chunk else chunk
    assert tops._chunk_and_pad(t, chunk) == (c, -(-t // c) * c)


def _torch_vjp(fn, xs, do):
    leaves = [x.clone().requires_grad_() for x in xs]
    o = fn(*leaves)
    o.backward(do)
    return [o.detach()] + [x.grad for x in leaves]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [48, 40])
def test_autograd_function_matches_vjp_of_pallas_wrapper(dtype, t):
    """Forward B2 and backward B3 through the wrappers, T a multiple of
    the chunk and not (padded), against ``jax.vjp`` of the Pallas
    wrapper in interpret mode."""
    xs = [_as(x, dtype) for x in _inputs(3, 1, BH, t, D)]
    o_j, vjp = jax.vjp(lambda a, b, c: jops.linear_attention(
        a, b, c, chunk=CHUNK, interpret=True), *(j for j, _ in xs[:3]))
    want = [o_j, *vjp(xs[3][0])]
    got = _torch_vjp(lambda a, b, c: tops.linear_attention(a, b, c,
                                                           chunk=CHUNK),
                     [t for _, t in xs[:3]], xs[3][1])
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        assert a.dtype == getattr(torch, dtype)
        _close(a, b, TOL[dtype], name)


@pytest.mark.parametrize("normalize", [False, True])
@pytest.mark.parametrize("t", [48, 21])
def test_causal_linear_attention_matches_jax_core(normalize, t):
    """The port's ``causal_linear_attention`` (autograd function + fp32
    normaliser epilogue) against ``jax.vjp`` of the jnp one (custom VJP
    ``_cla_core``)."""
    q, k, v, do = _inputs(4, 2, 2, t, D)
    o_j, vjp = jax.vjp(lambda a, b, c: jcore.causal_linear_attention(
        a, b, c, chunk_size=CHUNK, normalize=normalize), q, k, v)
    want = [o_j, *vjp(jnp.asarray(do))]
    got = _torch_vjp(lambda a, b, c: tcore.causal_linear_attention(
        a, b, c, chunk_size=CHUNK, normalize=normalize),
        [torch.from_numpy(x) for x in (q, k, v)], torch.from_numpy(do))
    for name, a, b in zip(("o", "dq", "dk", "dv"), got, want):
        _close(a, b, TOL["float32"], name)


def test_direct_form_and_closed_grads_match_jax_ref():
    q, k, v, do = _inputs(5, BH, 21, D)
    s0 = np.random.default_rng(6).standard_normal((BH, D, D)).astype(
        np.float32)
    o_j, s_j = jref.linear_attention_ref(q, k, v, initial_state=s0)
    o_t, s_t = tref.linear_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v)),
        initial_state=torch.from_numpy(s0))
    _close(o_t, o_j, TOL["float32"], "o")
    _close(s_t, s_j, TOL["float32"], "state")
    for name, a, b in zip(
            ("dq", "dk", "dv"),
            tref.linear_attention_grads_ref(
                *(torch.from_numpy(x) for x in (q, k, v, do))),
            jref.linear_attention_grads_ref(q, k, v, do)):
        _close(a, b, TOL["float32"], name)


@pytest.mark.parametrize("normalize", [False, True])
def test_gradcheck_float64(normalize):
    """Finite differences against B3's recompute backward (and autograd
    through the normaliser), float64, T = 11 with chunk 4 (padded)."""
    rng = np.random.default_rng(7)
    xs = [torch.from_numpy(np.abs(rng.standard_normal((1, 2, 11, 16))) + 0.1)
          .requires_grad_() for _ in range(3)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: tcore.causal_linear_attention(
            q, k, v, chunk_size=4, normalize=normalize), xs)


def test_only_q_k_v_are_saved_for_the_backward():
    """The paper's memory argument: the autograd graph of the core keeps
    q, k and v (padded to the chunk) and no state."""
    xs = [torch.from_numpy(x).requires_grad_()
          for x in _inputs(8, 1, 2, 40, D)[:3]]
    o = tops.linear_attention(*xs, chunk=CHUNK)
    node = o.grad_fn
    while node is not None and "LinearAttention" not in type(node).__name__:
        node = node.next_functions[0][0]
    assert node is not None
    saved = node.saved_tensors
    assert len(saved) == 3 and all(s.shape == (2, 48, D) for s in saved)


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (tops.fwd.launches, tops.bwd_dq.launches,
              tops.bwd_dkv.launches)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(9, BH, 32, D))
    o, s = tops.fwd(q, k, v, chunk=CHUNK)
    o_r, s_r = tref.chunked_fwd_ref(q, k, v, chunk=CHUNK)
    assert torch.equal(o, o_r) and torch.equal(s, s_r)
    assert all(torch.equal(a, b) for a, b in zip(
        tops.bwd(q, k, v, do, chunk=CHUNK),
        tref.chunked_bwd_ref(q, k, v, do, chunk=CHUNK)))
    assert (tops.fwd.launches, tops.bwd_dq.launches,
            tops.bwd_dkv.launches) == before
