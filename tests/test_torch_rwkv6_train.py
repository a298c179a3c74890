"""Training RWKV-6 through the exclusive form's hand-written backward,
against the JAX package on the CPU, from the same numpy inputs (fp32):

* the plain exclusive backward (``ref.chunked_bwd_exclusive_ref``, what
  ``ops.bwd_exclusive`` runs on CPU tensors) against ``jax.grad`` of
  ``repro.core.gated.chunked_gla(exclusive=True, u=u)`` at chunk 64, u
  drawn at random one row per head (H, Dk) or shared (Dk,): dq, dk, dv,
  dg and du within 1e-5 normwise; against torch autograd of the port's
  plain exclusive forward (``ref.chunked_fwd_ref``) the same; and its
  two launches' plain versions (q⊙dq handed from the first to the
  second) against the whole;
* the clamp: dg is zero where g lies outside [min_log_decay, 0], as
  JAX's is, and the rest still matches;
* ``rwkv6_attention`` under autograd (the differentiable route) against
  autograd of the plain forward, and one forward call without a
  gradient;
* rwkv6-1.6b's smoke config at ``linear_chunk`` 64, a 128-token batch:
  ``lm_loss`` within 1e-5 relative of JAX's and every gradient leaf
  within 1e-4 normwise.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import gated as jgated
from repro.data import SyntheticLMDataset
from repro.models import lm as jlm
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.gated_linear_attention import ops as gops
from repro_torch.kernels.gated_linear_attention import ref as gref
from repro_torch.models import lm as tlm
from repro_torch.optim import GradAccumulator
from repro_torch.tree import leaves

RULES = Rules.null()
TOL = 1e-5
CHUNK = 64
ARCH = "rwkv6-1.6b"
NAMES = ("dq", "dk", "dv", "dg", "du")


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, b, h, t, d, shared_u=False, decay="rwkv"):
    """q, k, v, do signed; the log-decay in RWKV-6's range (−0.3 to −0.9
    a token: a 64-token chunk reaches b = −57.6) or, ``clamp``, a fifth
    of the entries past the clamp (−1.5 to −3) or above 0; u at random,
    (H, D) or (D,)."""
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32)
                   for _ in range(4))
    g = -(0.3 + 0.6 * rng.random((b, h, t, d))).astype(np.float32)
    if decay == "clamp":
        pick = rng.random(g.shape)
        g = np.where(pick < 0.1, -1.5 - 1.5 * rng.random(g.shape), g)
        g = np.where(pick > 0.9, 0.2 * rng.random(g.shape) + 1e-3, g)
        g = g.astype(np.float32)
    u = rng.standard_normal((d,) if shared_u else (h, d)).astype(np.float32)
    return q, k, v, do, g, u


def _jax_grads(q, k, v, do, g, u):
    """jax.grad of Σ o⊙do through chunked_gla(exclusive, u), jitted."""
    def f(q, k, v, g, u):
        o, _ = jgated.chunked_gla(q, k, v, g, chunk_size=CHUNK,
                                  exclusive=True, u=u)
        return jnp.sum(o * do)
    return jax.jit(jax.grad(f, argnums=(0, 1, 2, 3, 4)))(q, k, v, g, u)


def _rows(x):
    """(B, H, T, D) numpy → flat (B·H, T, D) torch rows."""
    return torch.from_numpy(np.ascontiguousarray(x.reshape(-1, *x.shape[2:])))


def _close(t, j, what, tol=TOL):
    t = t.detach().float().numpy().reshape(np.shape(j))
    j = np.asarray(j, np.float32)
    err = np.abs(t - j).max()
    assert err <= tol * np.abs(j).max(), \
        f"{what}: max|Δ| {err:.3e} > {tol} x {np.abs(j).max():.3e}"


SHAPES = [(2, 3, 128, 16, False), (1, 2, 192, 64, False),
          (2, 2, 64, 16, True)]


@pytest.mark.parametrize("b,h,t,d,shared_u", SHAPES)
def test_plain_exclusive_backward_matches_jax_grad(b, h, t, d, shared_u):
    """dq, dk, dv, dg and du of ``ops.bwd_exclusive`` on CPU rows (its
    plain version) against JAX's autodiff at chunk 64, normwise 1e-5."""
    q, k, v, do, g, u = _inputs(0, b, h, t, d, shared_u)
    want = _jax_grads(q, k, v, do, g, u)
    got = gops.bwd_exclusive(*(_rows(x) for x in (q, k, v, g, do)),
                             torch.from_numpy(u), chunk=CHUNK)
    assert got[4].shape == u.shape
    for name, a, j in zip(NAMES, got, want):
        _close(a, j, name)


@pytest.mark.parametrize("b,h,t,d,shared_u", SHAPES)
def test_plain_exclusive_backward_matches_torch_autograd(b, h, t, d,
                                                         shared_u):
    """The explicit backward against torch autograd of the port's plain
    exclusive forward (``ref.chunked_fwd_ref``), and its two launches'
    plain versions (``bwd_exclusive_dq_ref`` then
    ``bwd_exclusive_dkv_ref``, du summed over each head's rows) against
    the whole."""
    q, k, v, do, g, u = _inputs(1, b, h, t, d, shared_u)
    rows = [_rows(x) for x in (q, k, v, g)]
    dot, ut = _rows(do), torch.from_numpy(u)
    leaves_ = [x.clone().requires_grad_() for x in rows + [ut]]
    o, _ = gref.chunked_fwd_ref(*leaves_[:4], u=leaves_[4], chunk=CHUNK,
                                exclusive=True)
    o.backward(dot)
    got = gref.chunked_bwd_exclusive_ref(*rows, dot, ut, chunk=CHUNK)
    dq, qdq, du_rows = gref.bwd_exclusive_dq_ref(*rows, dot, ut,
                                                 chunk=CHUNK)
    dk, dv, dg = gref.bwd_exclusive_dkv_ref(*rows, dot, ut, qdq, chunk=CHUNK)
    alone = (dq, dk, dv, dg, gref._head_sum(du_rows, ut))
    for name, a, c, x in zip(NAMES, got, alone, leaves_):
        _close(a, x.grad.numpy(), name)
        _close(c, a.numpy(), f"{name} launches", tol=0.0)


def test_exclusive_dg_is_zero_outside_the_clamp_as_jax():
    """g past min_log_decay (−1) or above 0 on a fifth of the entries:
    dg is exactly 0 there in the plain backward and in JAX's autodiff,
    and every gradient still matches JAX's within 1e-5."""
    q, k, v, do, g, u = _inputs(2, 2, 2, 128, 16, decay="clamp")
    want = _jax_grads(q, k, v, do, g, u)
    got = gops.bwd_exclusive(*(_rows(x) for x in (q, k, v, g, do)),
                             torch.from_numpy(u), chunk=CHUNK)
    outside = (g < -1.0) | (g > 0.0)
    assert outside.mean() > 0.15
    dg = got[3].numpy().reshape(g.shape)
    assert (dg[outside] == 0).all()
    assert (np.asarray(want[3])[outside] == 0).all()
    assert (dg[~outside] != 0).mean() > 0.99
    for name, a, j in zip(NAMES, got, want):
        _close(a, j, name)


def test_rwkv6_attention_differentiates_through_the_exclusive_backward():
    """``rwkv6_attention`` on (B, H, T, D) with a gradient wanted: the
    autograd function (T = 100 padded to the chunk, the log-decay
    broadcast, u per head) against autograd of the plain forward on the
    same (B, H, T, D) inputs, normwise 1e-5; without a gradient one
    forward call, and the state carries no gradient."""
    q, k, v, do, g, u = _inputs(3, 2, 3, 100, 16)
    ins = [torch.from_numpy(x) for x in (q, k, v, g, u)]
    got = [x.clone().requires_grad_() for x in ins]
    o, s = gops.rwkv6_attention(*got, chunk=CHUNK)
    assert not s.requires_grad
    o.backward(torch.from_numpy(do))
    want = [x.clone().requires_grad_() for x in ins]
    c, rows = gops._flat_inputs(*want[:4], CHUNK)
    o_r, _ = gref.chunked_fwd_ref(*rows, u=want[4], chunk=c, exclusive=True)
    o_r = o_r[:, :100].reshape(o.shape)
    o_r.backward(torch.from_numpy(do))
    _close(o, o_r.detach().numpy(), "o")
    for name, a, b in zip(("dq", "dk", "dv", "dg", "du"), got, want):
        _close(a.grad, b.grad.numpy(), name)
    with torch.no_grad():
        o2, _ = gops.rwkv6_attention(*ins, chunk=CHUNK)
    _close(o2, o.detach().numpy(), "o without a gradient", tol=0.0)


def _perturbed(pj, seed):
    """JAX's parameters with the vectors moved off their init values (u
    from 0, so the bonus enters the loss; mu, the norms)."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        keys = [getattr(key, "key", None) for key in path]
        if any(key in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck",
                       "mu_cr", "u_bonus", "gn_scale", "gn_bias", "scale",
                       "bias") for key in keys):
            return x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, pj)


def test_smoke_training_step_at_chunk_64_matches_jax():
    """rwkv6-1.6b's smoke config at ``linear_chunk`` 64 (the chunk the
    port trains at on the card, ``min(linear_chunk, PREFILL_CHUNK)``),
    batch 2 x 128 tokens, u off its zero init: the loss within 1e-5
    relative of ``jax.value_and_grad``'s and every gradient leaf within
    1e-4 normwise."""
    kw = dict(dtype="float32", linear_chunk=CHUNK)
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **kw)
    tcfg = dataclasses.replace(get_smoke_config(ARCH), **kw)
    pj = _perturbed(jlm.init_params(jax.random.PRNGKey(5), jcfg), 105)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg)
    batch = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=128,
                               global_batch=2, seed=0).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, RULES), has_aux=True))(pj)
    t_loss, _, t_grads = GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), pt,
        {key: torch.from_numpy(x) for key, x in batch.items()})
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    t_leaves = leaves(t_grads)
    j_leaves = jax.tree.leaves(jax.tree.map(np.asarray, grads))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()
