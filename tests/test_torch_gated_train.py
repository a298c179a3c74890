"""The port's gated (§4 decay) training path against the JAX package on
the CPU, from the same numpy inputs: the plain versions of B8 and B9
against the Pallas ``kernel.fwd``/``kernel.bwd`` in interpret mode and
the pairwise oracle; the autograd function against ``jax.vjp`` of the
Pallas wrapper and of the jnp ``gated_linear_attention`` (custom VJP
``_gla_core``); ``rwkv6_attention``; the paper's §4 gate and inversion;
and the qwen3-0.6b smoke config's gated loss and gradients.

Tolerances, normwise (max|Δ| ≤ TOL · max|JAX|): fp32 1e-5 (the two
frameworks sum in other orders); bf16 8e-3, two bf16 ulps of the
largest element. The model: loss rtol 1e-5, every gradient leaf
normwise 1e-4 (fp32 sums in other orders through two layers, the head
and the cross-entropy).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import gated as jcore
from repro.data import SyntheticLMDataset
from repro.kernels.gated_linear_attention import kernel as jkernel
from repro.kernels.gated_linear_attention import ops as jops
from repro.kernels.gated_linear_attention import ref as jref
from repro.models import lm as jlm
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.core import gated as tcore
from repro_torch.kernels.gated_linear_attention import ops as tops
from repro_torch.kernels.gated_linear_attention import ref as tref
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.optim import GradAccumulator
from repro_torch.tree import leaves

TOL = {"float32": 1e-5, "bfloat16": 8e-3}
CHUNK = 16
BH, D = 3, 16


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, *shape, g_low=-0.6):
    """q, k positive (the model's elu1 regime), v and do signed, the
    log-decay in [g_low, 0] with a few entries past the clamp (-1)."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]
    g = (g_low * rng.random(shape)).astype(np.float32)
    g.reshape(-1)[::37] = -1.5
    return [np.abs(x[0]) + 0.1, np.abs(x[1]) + 0.1, x[2], x[3], g]


def _as(x, dtype):
    return (jnp.asarray(x, dtype=getattr(jnp, dtype)),
            torch.from_numpy(x).to(getattr(torch, dtype)))


def _close(t, j, tol, what=""):
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = np.abs(t - j).max()
    assert err <= tol * np.abs(j).max(), f"{what}: max|Δ| {err}"


def _torch_vjp(fn, xs, do):
    leaves_ = [x.clone().requires_grad_() for x in xs]
    o = fn(*leaves_)
    o.backward(do)
    return [o.detach()] + [x.grad for x in leaves_]


# -- the plain versions of the kernels, flat rows ------------------------

@pytest.mark.parametrize("exclusive", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_fwd_matches_pallas_fwd(dtype, exclusive):
    """T a multiple of the chunk: the plain B8 against Pallas ``fwd``
    (interpret mode), inclusive and exclusive with the bonus u."""
    q, k, v, _, g = _inputs(0, BH, 48, D)
    xs = [_as(x, dtype) for x in (q, k, v)]
    u = np.random.default_rng(1).standard_normal(D).astype(np.float32)
    uj, ut = (u, torch.from_numpy(u)) if exclusive else (None, None)
    o_j, s_j = jkernel.fwd(*(j for j, _ in xs), g, u=uj, chunk=CHUNK,
                           exclusive=exclusive, interpret=True)
    o_t, s_t = tops.fwd(*(t for _, t in xs), torch.from_numpy(g), u=ut,
                        chunk=CHUNK, exclusive=exclusive)
    assert o_t.dtype == getattr(torch, dtype) and s_t.dtype == torch.float32
    _close(o_t, o_j, TOL[dtype], "o")
    _close(s_t, s_j, TOL["float32"], "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_bwd_matches_pallas_bwd(dtype):
    q, k, v, do, g = _inputs(2, BH, 48, D)
    xs = [_as(x, dtype) for x in (q, k, v, do)]
    got = tops.bwd(*(t for _, t in xs[:3]), torch.from_numpy(g), xs[3][1],
                   chunk=CHUNK)
    want = jkernel.bwd(*(j for j, _ in xs[:3]), g, xs[3][0], chunk=CHUNK,
                       interpret=True)
    for name, t, j in zip(("dq", "dk", "dv", "dg"), got, want):
        assert t.dtype == (torch.float32 if name == "dg"
                           else getattr(torch, dtype)), name
        _close(t, j, TOL[dtype], name)


def test_plain_sweeps_are_the_pallas_bodies():
    """``chunked_bwd_dq_ref`` and ``chunked_bwd_dkv_ref`` in fp32, and the
    epilogue, against the Pallas ``bwd`` (whose dq and dk come out of the
    kernels in fp32)."""
    q, k, v, do, g = (torch.from_numpy(x) for x in _inputs(3, BH, 32, D))
    dq = tref.chunked_bwd_dq_ref(k, v, g, do, chunk=CHUNK)
    dk, dv = tref.chunked_bwd_dkv_ref(q, k, v, g, do, chunk=CHUNK)
    dg = tref.dg_epilogue(q, k, g, dq, dk)
    assert dq.dtype == dk.dtype == torch.float32
    want = jkernel.bwd(*(x.numpy() for x in (q, k, v, g, do)), chunk=CHUNK,
                       interpret=True)
    for name, t, j in zip(("dq", "dk", "dv", "dg"), (dq, dk, dv, dg), want):
        _close(t, j, TOL["float32"], name)


@pytest.mark.parametrize("t", [32, 48])
def test_plain_dq_launch_matches_pallas_bwd(t):
    """``bwd_dq_ref``, the function of B9's dq launch, in fp32: dq against
    the Pallas ``bwd``'s, and q⊙dq against q times it."""
    q, k, v, do, g = (torch.from_numpy(x) for x in _inputs(20 + t, BH, t, D))
    dq, qdq = tref.bwd_dq_ref(q, k, v, g, do, chunk=CHUNK)
    assert dq.dtype == qdq.dtype == torch.float32
    dq_j = jkernel.bwd(*(x.numpy() for x in (q, k, v, g, do)), chunk=CHUNK,
                       interpret=True)[0]
    _close(dq, dq_j, TOL["float32"], "dq")
    _close(qdq, q.numpy() * np.asarray(dq_j), TOL["float32"], "q⊙dq")


@pytest.mark.parametrize("t", [32, 48])
def test_plain_dkv_launch_from_a_given_qdq_matches_pallas_bwd(t):
    """``bwd_dkv_dg_ref``, the function of B9's dk/dv launch, in fp32,
    given q⊙dq formed from the Pallas ``bwd``'s dq: dk, dv and dg against
    the Pallas ``bwd``'s (dg through its jnp epilogue)."""
    q, k, v, do, g = (torch.from_numpy(x) for x in _inputs(30 + t, BH, t, D))
    want = jkernel.bwd(*(x.numpy() for x in (q, k, v, g, do)), chunk=CHUNK,
                       interpret=True)
    qdq = q * torch.from_numpy(np.array(want[0]))
    got = tref.bwd_dkv_dg_ref(q, k, v, g, do, qdq, chunk=CHUNK)
    for name, x, j in zip(("dk", "dv", "dg"), got, want[1:]):
        assert x.dtype == torch.float32, name
        _close(x, j, TOL["float32"], name)


def test_dg_from_qdq_is_the_epilogue():
    """The dk/dv launch's dg from a given q⊙dq is the JAX epilogue's, to
    the bit, when q⊙dq is q times dq."""
    q, k, v, do, g = (torch.from_numpy(x) for x in _inputs(40, BH, 48, D))
    dq = tref.chunked_bwd_dq_ref(k, v, g, do, chunk=CHUNK)
    dk, _ = tref.chunked_bwd_dkv_ref(q, k, v, g, do, chunk=CHUNK)
    assert torch.equal(tref.dg_from_qdq(q * dq, k, g, dk),
                       tref.dg_epilogue(q, k, g, dq, dk))


@pytest.mark.parametrize("mode", ["inclusive", "exclusive_u", "exclusive",
                                  "carry"])
def test_pairwise_oracle_matches_jax_ref(mode):
    q, k, v, _, g = _inputs(4, BH, 21, D)
    g = np.clip(g, -1.0, 0.0)
    rng = np.random.default_rng(5)
    u = rng.standard_normal(D).astype(np.float32) if mode == "exclusive_u" \
        else None
    s0 = rng.standard_normal((BH, D, D)).astype(np.float32) \
        if mode == "carry" else None
    kw = dict(exclusive=mode.startswith("exclusive"))
    o_j, s_j = jref.gated_linear_attention_ref(q, k, v, g, u=u,
                                               initial_state=s0, **kw)
    t = lambda x: None if x is None else torch.from_numpy(x)  # noqa: E731
    o_t, s_t = tref.gated_linear_attention_ref(
        t(q), t(k), t(v), t(g), u=t(u), initial_state=t(s0), **kw)
    _close(o_t, o_j, TOL["float32"], "o")
    _close(s_t, s_j, TOL["float32"], "state")


@pytest.mark.parametrize("exclusive", [False, True])
def test_chunked_fwd_equals_the_oracle(exclusive):
    """Inside the clamp the chunked B8 form is the oracle's function."""
    q, k, v, _, g = (torch.from_numpy(x) for x in _inputs(6, BH, 48, D))
    g = g.clamp(-1.0, 0.0)
    u = torch.linspace(-1, 1, D) if exclusive else None
    o_c, s_c = tref.chunked_fwd_ref(q, k, v, g, u=u, chunk=CHUNK,
                                    exclusive=exclusive)
    o_r, s_r = tref.gated_linear_attention_ref(q, k, v, g, u=u,
                                               exclusive=exclusive)
    torch.testing.assert_close(o_c, o_r, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(s_c, s_r, rtol=1e-5, atol=1e-5)


# -- the differentiable wrapper and the core ------------------------------

@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("t", [48, 40])       # 40: not a chunk multiple
def test_autograd_function_matches_vjp_of_pallas_wrapper(scalar, t):
    """Forward B8 and backward B9 through the wrappers (plain route),
    vector and per-head scalar decay, T a multiple of the chunk and not
    (padded), against ``jax.vjp`` of the Pallas wrapper in interpret
    mode: o and the four gradients (dg summed back to (B, H, T, 1) for
    the scalar decay)."""
    q, k, v, do, g = _inputs(7, 1, BH, t, D)
    if scalar:
        g = g[..., :1]
    o_j, vjp = jax.vjp(lambda a, b, c, e: jops.gated_linear_attention(
        a, b, c, e, chunk=CHUNK, interpret=True), q, k, v, g)
    want = [o_j, *vjp(jnp.asarray(do))]
    got = _torch_vjp(lambda a, b, c, e: tops.gated_linear_attention(
        a, b, c, e, chunk=CHUNK), [torch.from_numpy(x) for x in (q, k, v, g)],
        torch.from_numpy(do))
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg"), got, want):
        _close(a, b, TOL["float32"], name)


@pytest.mark.parametrize("scalar", [False, True])
@pytest.mark.parametrize("t", [48, 21])
def test_core_gated_linear_attention_matches_jax_core(scalar, t):
    """The port's ``core.gated.gated_linear_attention`` against
    ``jax.vjp`` of the jnp one (custom VJP ``_gla_core``)."""
    q, k, v, do, g = _inputs(8, 2, 2, t, D)
    if scalar:
        g = g[..., :1]
    o_j, vjp = jax.vjp(lambda a, b, c, e: jcore.gated_linear_attention(
        a, b, c, e, chunk_size=CHUNK), q, k, v, g)
    want = [o_j, *vjp(jnp.asarray(do))]
    got = _torch_vjp(lambda a, b, c, e: tcore.gated_linear_attention(
        a, b, c, e, chunk_size=CHUNK),
        [torch.from_numpy(x) for x in (q, k, v, g)], torch.from_numpy(do))
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg"), got, want):
        assert a.shape == tuple(b.shape), name
        _close(a, b, TOL["float32"], name)


@pytest.mark.parametrize("t", [48, 40])
def test_rwkv6_attention_matches_jax(t):
    q, k, v, _, g = _inputs(9, 1, BH, t, D)
    u = np.random.default_rng(10).standard_normal(D).astype(np.float32)
    o_j, s_j = jops.rwkv6_attention(q, k, v, g, u, chunk=CHUNK,
                                    interpret=True)
    o_t, s_t = tops.rwkv6_attention(
        *(torch.from_numpy(x) for x in (q, k, v, g, u)), chunk=CHUNK)
    _close(o_t, o_j, TOL["float32"], "o")
    _close(s_t, s_j, TOL["float32"], "state")


def test_chunk_and_padding_rule_is_jax_s():
    """The wrapper pads T to the chunk rule of JAX's ``ops`` and gives
    the padded positions log-decay 0."""
    q, k, v, _, g = (torch.from_numpy(x) for x in _inputs(11, 1, 2, 40, D))
    c, rows = tops._flat_inputs(q, k, v, g[..., :1], CHUNK)
    assert c == CHUNK and all(r.shape == (2, 48, D) for r in rows)
    assert rows[3].dtype == torch.float32
    assert torch.count_nonzero(rows[3][:, 40:]) == 0
    assert torch.equal(rows[3][:, :40], g[0, :, :, :1].expand(2, 40, D))


# -- the paper's §4 instance ----------------------------------------------

def test_paper_gate_matches_jax():
    rng = np.random.default_rng(12)
    h = rng.standard_normal((2, 5, D)).astype(np.float32)
    w = rng.standard_normal((D, D)).astype(np.float32)
    b = rng.standard_normal(D).astype(np.float32)
    _close(tcore.paper_gate(*(torch.from_numpy(x) for x in (h, w, b))),
           jcore.paper_gate(h, w, b), TOL["float32"], "f")


@pytest.mark.parametrize("alpha,beta", [(1.0, 1.0), (0.9, 0.5)])
def test_invert_update_matches_jax(alpha, beta):
    rng = np.random.default_rng(13)
    c = rng.standard_normal((3, D, D)).astype(np.float32)
    f = rng.standard_normal((3, D)).astype(np.float32)
    _close(tcore.invert_update(torch.from_numpy(c), torch.from_numpy(f),
                               alpha, beta),
           jcore.invert_update(c, f, alpha, beta), TOL["float32"], "C_t")


def test_reconstruct_states_backward_matches_jax():
    """The storage-free backward recovers every C_t from the final C, as
    JAX's does; [0] is zero and [n] the final state."""
    f = np.random.default_rng(14).standard_normal((2, 7, 8)).astype(
        np.float32) * 0.3
    c_final = np.einsum("bnk,bnl->bkl", f, f)
    want = jcore.reconstruct_states_backward(c_final, f)
    got = tcore.reconstruct_states_backward(torch.from_numpy(c_final),
                                            torch.from_numpy(f))
    assert got.shape == (8, 2, 8, 8)
    _close(got, want, TOL["float32"], "states")
    assert torch.count_nonzero(got[0]) == 0
    torch.testing.assert_close(got[-1], torch.from_numpy(c_final))
    prefix = np.einsum("bnk,bnl->bkl", f[:, :3], f[:, :3])
    np.testing.assert_allclose(got[3].numpy(), prefix, atol=1e-5)


# -- at the clamp: the chunk-wide forms overflow in both packages ---------

def _clamp_inputs():
    rng = np.random.default_rng(15)
    shape = (2, 128, 8)
    q, k = (np.abs(rng.standard_normal(shape)).astype(np.float32) + 0.1
            for _ in range(2))
    v, do = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    return q, k, v, do, np.full(shape, -1.0, np.float32)


@pytest.fixture
def _flush_subnormals():
    """XLA on the CPU flushes subnormal floats to zero, as the TPU does;
    at the clamp that decides which of exp(b)'s underflowed rows give
    0 · inf = NaN. PyTorch is set to the same mode for the test."""
    torch.set_flush_denormal(True)
    yield
    torch.set_flush_denormal(False)


def _same_nans(a, b, what):
    np.testing.assert_array_equal(torch.isnan(a).numpy(),
                                  np.isnan(np.asarray(b)), err_msg=what)


def test_at_the_clamp_plain_versions_give_nan_where_pallas_does(
        _flush_subnormals):
    """g ≡ −1 over a 128-token chunk: exp(−b) passes fp32's range in the
    Pallas bodies and in the port's plain versions alike. The NaNs of
    the state and of B9's four outputs stand in the same places, and no
    equality of values is asserted there. B8's o: XLA compiles the
    Pallas body's ``scores * mask`` (a mask made of iota comparisons) as
    a select, so its masked inf products give 0, where the jnp source
    and the port multiply and give NaN (JAX's core does too, below): every
    NaN of the Pallas o is a NaN of the port's."""
    q, k, v, do, g = _clamp_inputs()
    t = [torch.from_numpy(x) for x in (q, k, v, do, g)]
    o_j, s_j = jkernel.fwd(q, k, v, g, chunk=128, interpret=True)
    o_t, s_t = tops.fwd(t[0], t[1], t[2], t[4], chunk=128)
    want = jkernel.bwd(q, k, v, g, do, chunk=128, interpret=True)
    got = tops.bwd(t[0], t[1], t[2], t[4], t[3], chunk=128)
    for name, a, b in zip(("s", "dq", "dk", "dv", "dg"), (s_t, *got),
                          (s_j, *want)):
        _same_nans(a, b, name)
    nan_o = np.isnan(np.asarray(o_j))
    assert nan_o.any() and torch.isnan(o_t).numpy()[nan_o].all()
    assert all(torch.isnan(x).any() for x in got)


def test_at_the_clamp_the_oracle_gives_nan_where_jax_s_does(
        _flush_subnormals):
    q, k, v, _, g = _clamp_inputs()
    o_j, s_j = jref.gated_linear_attention_ref(q, k, v, g)
    o_t, s_t = tref.gated_linear_attention_ref(
        *(torch.from_numpy(x) for x in (q, k, v, g)))
    _same_nans(o_t, o_j, "o")
    _same_nans(s_t, s_j, "state")
    assert torch.isnan(o_t).any()


def test_at_the_clamp_core_gives_nan_where_jax_core_does(_flush_subnormals):
    q, k, v, do, g = (x[None] for x in _clamp_inputs())
    o_j, vjp = jax.vjp(lambda a, b, c, e: jcore.gated_linear_attention(
        a, b, c, e, chunk_size=128), q, k, v, g)
    want = [o_j, *vjp(jnp.asarray(do))]
    got = _torch_vjp(lambda a, b, c, e: tcore.gated_linear_attention(
        a, b, c, e, chunk_size=128),
        [torch.from_numpy(x) for x in (q, k, v, g)], torch.from_numpy(do))
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg"), got, want):
        _same_nans(a, b, name)
    assert all(torch.isnan(x).any() for x in got)


def test_at_the_clamp_a_32_token_chunk_matches_the_scan():
    """What the kernels do at the clamp (rescale within 32 tokens), in
    the plain versions: finite and equal to the per-token recurrence and
    its autograd."""
    q, k, v, do, g = (torch.from_numpy(x)[None] for x in _clamp_inputs())
    got = _torch_vjp(lambda a, b, c, e: tcore.gated_linear_attention(
        a, b, c, e, chunk_size=32), [q, k, v, g], do)
    want = _torch_vjp(lambda a, b, c, e: tcore.gla_scan(a, b, c, e)[0],
                      [q, k, v, g], do)
    for name, a, b in zip(("o", "dq", "dk", "dv", "dg"), got, want):
        assert torch.isfinite(a).all(), name
        err = (a - b).abs().max()
        assert err <= TOL["float32"] * b.abs().max(), (name, err)


# -- the autograd graph and the routes -------------------------------------

def _graph(out):
    """Every node of ``out``'s autograd graph."""
    seen, stack = {}, [out.grad_fn]
    while stack:
        node = stack.pop()
        if node is not None and id(node) not in seen:
            seen[id(node)] = node
            stack.extend(n for n, _ in node.next_functions)
    return list(seen.values())


def test_only_q_k_v_g_are_saved_for_the_backward():
    """The paper's memory argument: the autograd graph of the core keeps
    q, k, v and g (padded to the chunk) and no state."""
    xs = [torch.from_numpy(x).requires_grad_()
          for x in _inputs(16, 1, 2, 40, D)]
    o = tops.gated_linear_attention(xs[0], xs[1], xs[2], xs[4], chunk=CHUNK)
    gla = [n for n in _graph(o)
           if "GatedLinearAttention" in type(n).__name__]
    assert len(gla) == 1
    saved = gla[0].saved_tensors
    assert len(saved) == 4 and all(s.shape == (2, 48, D) for s in saved)
    assert saved[3].dtype == torch.float32


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    before = (tops.fwd.launches, tops.bwd_dq.launches,
              tops.bwd_dkv.launches)
    q, k, v, do, g = (torch.from_numpy(x) for x in _inputs(17, BH, 32, D))
    o, s = tops.fwd(q, k, v, g, chunk=CHUNK)
    o_r, s_r = tref.chunked_fwd_ref(q, k, v, g, chunk=CHUNK)
    assert torch.equal(o, o_r) and torch.equal(s, s_r)
    assert all(torch.equal(a, b) for a, b in zip(
        tops.bwd(q, k, v, g, do, chunk=CHUNK),
        tref.chunked_bwd_ref(q, k, v, g, do, chunk=CHUNK)))
    assert (tops.fwd.launches, tops.bwd_dq.launches,
            tops.bwd_dkv.launches) == before



# -- the CUDA routes' limit on min_log_decay -------------------------------

@pytest.mark.parametrize("dtype,limit", [(torch.bfloat16, -1.25),
                                         (torch.float32, -1.5)])
def test_decay_limit_check_takes_the_limit_and_refuses_past_it(dtype, limit):
    """The check every CUDA call of fwd, bwd_dq and bwd_dkv runs:
    min_log_decay down to its type's limit (bf16 −1.25, by overflow of its
    64-token tiles; fp32 −1.5, by dg's accuracy, as the test below shows)
    passes and just past it raises."""
    x = torch.zeros((2, 64, D), dtype=dtype)
    g = torch.zeros((2, 64, D))
    assert tops.DECAY_LIMIT[dtype] == limit
    for inside in (limit, limit + 1e-4, tcore.MIN_LOG_DECAY):
        tops._check_gated("gated_linear_attention_fwd", CHUNK, g, inside,
                          q=x, k=x, v=x)
    for past in (limit - 1e-4, float("nan"), -float("inf")):
        with pytest.raises(ValueError, match="min_log_decay"):
            tops._check_gated("gated_linear_attention_bwd_dq", CHUNK, g,
                              past, q=x, k=x, v=x, do=x)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cpu_route_takes_a_min_log_decay_past_the_cuda_limit(dtype):
    """The CPU route keeps JAX's semantics: no tile, so no limit. At
    min_log_decay = -3 (past both CUDA limits; g down to -3.5) it matches
    the Pallas fwd and bwd at a 16-token chunk."""
    q, k, v, do, g = _inputs(18, BH, 48, D, g_low=-3.5)
    xs = [_as(x, dtype) for x in (q, k, v, do)]
    o_t, s_t = tops.fwd(*(t for _, t in xs[:3]), torch.from_numpy(g),
                        chunk=CHUNK, min_log_decay=-3.0)
    o_j, s_j = jkernel.fwd(*(j for j, _ in xs[:3]), g, chunk=CHUNK,
                           min_log_decay=-3.0, interpret=True)
    _close(o_t, o_j, TOL[dtype], "o")
    _close(s_t, s_j, TOL["float32"], "state")
    got = tops.bwd(*(t for _, t in xs[:3]), torch.from_numpy(g), xs[3][1],
                   chunk=CHUNK, min_log_decay=-3.0)
    want = jkernel.bwd(*(j for j, _ in xs[:3]), g, xs[3][0], chunk=CHUNK,
                       min_log_decay=-3.0, interpret=True)
    for name, t, j in zip(("dq", "dk", "dv", "dg"), got, want):
        _close(t, j, TOL[dtype], name)


def _drift_inputs(seed=21, t=1024, d=128):
    """``scripts/gla_fp32_dg_drift.py``'s inputs, in flat rows (1, t, d):
    q, k positive (elu1), v and do signed."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((1, 1, t, d)) for _ in range(4)]
    elu1 = lambda a: np.where(a > 0, a + 1.0, np.exp(np.minimum(a, 0.0)))  # noqa
    return [a.astype(np.float32)[0] for a in (elu1(x[0]), elu1(x[1]), x[2],
                                             x[3])]


@pytest.mark.parametrize("lo", [-1.0, -1.5, -2.0, -2.5])
def test_fp32_dg_error_is_rounding_amplified_by_the_identity(lo):
    """Why the fp32 CUDA route stops at −1.5 though its 32-token tiles
    stay finite to −2.5. With g ≡ lo, dg = reverse-cumsum(q⊙dq − k⊙dk)
    sums terms near max|q⊙dq| to a dg that shrinks as the decay
    strengthens, so the identity amplifies dq's and dk's rounding by
    κ = max|q⊙dq| / max|dg|. JAX's Pallas bwd and the port's plain version
    (fp32, 32-token chunks: finite) against the scan's autograd in fp64:
    dq, dk, dv within 1e-6 normwise at every lo, dg within 1.5e-6·κ. The
    same rows for the CUDA route: ``scripts/gla_fp32_dg_drift.py``."""
    q, k, v, do = _drift_inputs()
    g = np.full_like(q, lo)
    leaves_ = [torch.from_numpy(x).double()[None] for x in (q, k, v, g)]
    want = _torch_vjp(lambda a, b, c, e: tcore.gla_scan(a, b, c, e)[0],
                      leaves_, torch.from_numpy(do).double()[None])[1:]
    want = [x[0].numpy() for x in want]
    kappa = np.abs(q * want[0]).max() / np.abs(want[3]).max()
    jax_ = jkernel.bwd(q, k, v, g, do, chunk=32, min_log_decay=lo,
                       interpret=True)
    plain = tref.chunked_bwd_ref(*(torch.from_numpy(x)
                                   for x in (q, k, v, g, do)),
                                 chunk=32, min_log_decay=lo)
    for route, got in (("jax", jax_), ("plain", plain)):
        got = [np.asarray(x, np.float64) for x in got]
        err = [np.abs(a - b).max() / np.abs(b).max()
               for a, b in zip(got, want)]
        print(f"lo {lo} {route}: dq dk dv dg {err}, kappa {kappa:.2f}")
        assert max(err[:3]) <= 1e-6, (route, err)
        assert err[3] <= 1.5e-6 * kappa, (route, err[3], kappa)


@pytest.mark.parametrize("t", [16, 24])
def test_training_attention_is_gated_linear_attention(t):
    """``attention_apply`` without the state routes the gated backend
    through the differentiable core; with it (prefill) through
    ``chunked_gla``: the same output."""
    from repro_torch.models import attention as TA
    cfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend("gated_linear"),
        dtype="float32")
    p = TA.attention_params(torch.Generator().manual_seed(0), cfg)
    x = torch.from_numpy(np.random.default_rng(18).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)).requires_grad_()
    y_train, st = TA.attention_apply(p, x, cfg)
    y_pre, st_pre = TA.attention_apply(p, x, cfg, want_state=True)
    assert st is None and st_pre.s is not None
    torch.testing.assert_close(y_train, y_pre, rtol=1e-5, atol=1e-6)
    assert len([n for n in _graph(y_train)
                if "GatedLinearAttention" in type(n).__name__]) == 1


# -- the model: the smoke config's gated loss and gradients ---------------

def test_smoke_gated_loss_and_every_gradient_leaf_match_jax():
    """qwen3-0.6b smoke config, ``gated_linear`` (vector decay), fp32,
    JAX's parameters through ``convert.params_from_jax``, a batch of the
    synthetic stream (T = 24, not a multiple of the chunk 16)."""
    jcfg = dataclasses.replace(
        jax_smoke_config("qwen3-0.6b").with_backend("gated_linear"),
        dtype="float32")
    tcfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend("gated_linear"),
        dtype="float32")
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    batch = SyntheticLMDataset(vocab_size=256, seq_len=24, global_batch=2,
                               seed=0).batch_at(0)
    (loss_j, _), grads_j = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, Rules.null()),
        has_aux=True)(pj)
    params = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg)
    loss_t, _, grads_t = GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), params,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(loss_t.item(), float(loss_j), rtol=1e-5)
    t_leaves, j_leaves = leaves(grads_t), jax.tree.leaves(grads_j)
    assert len(t_leaves) == len(j_leaves) == 17
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert t.shape == j.shape and t.dtype == torch.float32
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


def test_gated_train_entry_point_runs_on_cpu():
    loop = ttrain.build(ttrain.parse_args([
        "--smoke", "--device", "cpu", "--backend", "gated_linear",
        "--steps", "3", "--batch", "2", "--seq-len", "24"]))
    out = loop.run()
    losses = [m["loss"] for m in out["metrics"]]
    assert out["step"] == 3 and all(np.isfinite(losses))
