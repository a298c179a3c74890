"""The training kernels' plain versions and the training slice at head dims
64 and 96 (musicgen-large's and RWKV-6's 64, phi3-mini-3.8b's 96) against
the JAX package on the CPU, from the same numpy inputs:

* B2 and B3 (``linear_attention``), B8 inclusive and exclusive with the
  bonus u and B9 (``gated_linear_attention``), each plain version against
  its Pallas function in interpret mode, fp32 within 1e-5 normwise (the
  two frameworks sum in other orders); B2/B3 and B9 also in bf16 within
  8e-3 (two bf16 ulps of the largest element: both sides sum in fp32 and
  round once); B9's two launches (``bwd_dq_ref``, ``bwd_dkv_dg_ref``)
  against the Pallas backward;
* a 2-layer model of each config's block kind (phi3-mini-3.8b's rmsnorm
  and SwiGLU at head dim 96, musicgen-large's layernorm and GELU at 64,
  d_model 64) under ``linear`` and ``gated_linear``: ``lm_loss`` within
  1e-5 relative of JAX's and every gradient leaf within 1e-4 normwise;
* the wrappers take D = 16, 64, 96 and 128 and refuse 8 and 32.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLMDataset
from repro.kernels.gated_linear_attention import kernel as jgkernel
from repro.kernels.linear_attention import kernel as jlkernel
from repro.models import lm as jlm
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.gated_linear_attention import ops as gops
from repro_torch.kernels.gated_linear_attention import ref as gref
from repro_torch.kernels.linear_attention import ops as lops
from repro_torch.kernels.linear_attention import ref as lref
from repro_torch.models import lm as tlm
from repro_torch.optim import GradAccumulator
from repro_torch.tree import leaves

TOL = 1e-5
BF16_TOL = 8e-3
CHUNK = 16
BH, T = 2, 48
DIMS = [64, 96]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed, d):
    """q, k positive (the model's elu1 regime), v and do signed, the
    log-decay in [-0.6, 0] with a few entries past the clamp (-1)."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((BH, T, d)).astype(np.float32)
         for _ in range(4)]
    g = (-0.6 * rng.random((BH, T, d))).astype(np.float32)
    g.reshape(-1)[::37] = -1.5
    return [np.abs(x[0]) + 0.1, np.abs(x[1]) + 0.1, x[2], x[3], g]


def _close(t, j, tol, what=""):
    t = t.detach().float().numpy()
    j = np.asarray(jnp.asarray(j, jnp.float32))
    assert t.shape == j.shape, (what, t.shape, j.shape)
    err = np.abs(t - j).max()
    assert err <= tol * np.abs(j).max(), f"{what}: max|Δ| {err}"


def _t(xs, dtype="float32"):
    return [torch.from_numpy(x).to(getattr(torch, dtype)) for x in xs]


def _j(xs, dtype="float32"):
    return [jnp.asarray(x, dtype=getattr(jnp, dtype)) for x in xs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", DIMS)
def test_b2_b3_plain_versions_match_pallas(d, dtype):
    """B2's o and final state, B3's dq, dk, dv, and B3's two launches
    alone, against the Pallas ``fwd`` and ``bwd`` in interpret mode (the
    state fp32 in both types)."""
    tol = TOL if dtype == "float32" else BF16_TOL
    q, k, v, do, _ = _inputs(0, d)
    o_j, s_j = jlkernel.fwd(*_j((q, k, v), dtype), chunk=CHUNK,
                            interpret=True)
    o_t, s_t = lops.fwd(*_t((q, k, v), dtype), chunk=CHUNK)
    _close(o_t, o_j, tol, "o")
    _close(s_t, s_j, TOL, "state")
    want = jlkernel.bwd(*_j((q, k, v, do), dtype), chunk=CHUNK,
                        interpret=True)
    qt, kt, vt, dot = _t((q, k, v, do), dtype)
    got = lops.bwd(qt, kt, vt, dot, chunk=CHUNK)
    alone = (lref.chunked_bwd_dq_ref(kt, vt, dot, chunk=CHUNK),
             *lref.chunked_bwd_dkv_ref(qt, kt, vt, dot, chunk=CHUNK))
    for name, a, b, j in zip(("dq", "dk", "dv"), got, alone, want):
        _close(a, j, tol, name)
        _close(b, j, tol, f"{name} launch")


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("u_kind", [None, "shared"])
def test_b8_plain_version_matches_pallas(d, u_kind):
    """B8 inclusive, and exclusive with the bonus u, against the Pallas
    ``fwd`` in interpret mode: o and the final state."""
    q, k, v, _, g = _inputs(1, d)
    exclusive = u_kind is not None
    u = (np.random.default_rng(2).standard_normal(d).astype(np.float32)
         if exclusive else None)
    o_j, s_j = jgkernel.fwd(q, k, v, g, u=u, chunk=CHUNK,
                            exclusive=exclusive, interpret=True)
    o_t, s_t = gops.fwd(*_t((q, k, v, g)),
                        u=None if u is None else torch.from_numpy(u),
                        chunk=CHUNK, exclusive=exclusive)
    _close(o_t, o_j, TOL, "o")
    _close(s_t, s_j, TOL, "state")


@pytest.mark.parametrize("d", DIMS)
def test_b8_per_head_bonus_is_the_pallas_fwd_of_each_head(d):
    """u of one row per head ((H, D), RWKV-6's ``u_bonus``), rows
    batch-major: each head's rows equal the Pallas ``fwd`` of those rows
    with that head's u."""
    heads = 2
    q, k, v, _, g = (np.concatenate([x, x[::-1] * 0.5]) for x in
                     _inputs(3, d))                    # 4 rows: b=2, h=2
    u = np.random.default_rng(4).standard_normal((heads, d)).astype(
        np.float32)
    o_t, s_t = gops.fwd(*_t((q, k, v, g)), u=torch.from_numpy(u),
                        chunk=CHUNK, exclusive=True)
    for h in range(heads):
        rows = slice(h, None, heads)
        o_j, s_j = jgkernel.fwd(q[rows], k[rows], v[rows], g[rows], u=u[h],
                                chunk=CHUNK, exclusive=True, interpret=True)
        _close(o_t[rows], o_j, TOL, f"o head {h}")
        _close(s_t[rows], s_j, TOL, f"state head {h}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("d", DIMS)
def test_b9_plain_version_and_launches_match_pallas(d, dtype):
    """B9's dq, dk, dv, dg through ``bwd`` and through its two launches'
    plain versions (q⊙dq handed from the first to the second) against the
    Pallas ``bwd`` in interpret mode (g fp32 in both types)."""
    tol = TOL if dtype == "float32" else BF16_TOL
    q, k, v, do, g = _inputs(5, d)
    jq, jk, jv, jdo = _j((q, k, v, do), dtype)
    want = jgkernel.bwd(jq, jk, jv, g, jdo, chunk=CHUNK, interpret=True)
    qt, kt, vt, dot = _t((q, k, v, do), dtype)
    gt = torch.from_numpy(g)
    got = gops.bwd(qt, kt, vt, gt, dot, chunk=CHUNK)
    dq, qdq = gref.bwd_dq_ref(qt, kt, vt, gt, dot, chunk=CHUNK)
    dk, dv, dg = gref.bwd_dkv_dg_ref(qt, kt, vt, gt, dot, qdq, chunk=CHUNK)
    for name, a, b, j in zip(("dq", "dk", "dv", "dg"), got,
                             (dq, dk, dv, dg), want):
        _close(a, j, tol, name)
        _close(b, j, tol, f"{name} launch")


@pytest.mark.parametrize("d", [8, 16, 32, 64, 96, 128, 112])
def test_training_kernel_wrappers_take_the_head_dims(d):
    """What B2/B3's and B8/B9's wrappers hand to their kernels: D = 16,
    64, 96, 112 and 128; 8 and 32 raise ValueError (a CUDA tensor there
    gets no plain route)."""
    x = torch.ones(2, 16, d)
    g = torch.zeros(2, 16, d)
    checks = (lambda: lops._check("fwd", 16, q=x, k=x, v=x),
              lambda: gops._check_gated("fwd", 16, g, -1.0, q=x, k=x, v=x))
    assert lops.HEAD_DIMS == gops.HEAD_DIMS == (16, 64, 96, 112, 128)
    for check in checks:
        if d in (8, 32):
            with pytest.raises(ValueError):
                check()
        else:
            check()


# -- the 2-layer training slice at head dims 64 and 96 ----------------------

SLICES = [("phi3-mini-3.8b", 96), ("musicgen-large", 64)]


def _models(arch, d, backend):
    kw = dict(attention_backend=backend, dtype="float32", head_dim=d,
              n_heads=2, n_kv_heads=2, name=f"{arch}-d{d}")
    jcfg = dataclasses.replace(jax_smoke_config(arch), **kw)
    tcfg = dataclasses.replace(get_smoke_config(arch), **kw)
    pj = jlm.init_params(jax.random.PRNGKey(6), jcfg)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg)
    return jcfg, tcfg, pj, pt


@pytest.mark.parametrize("backend", ["linear", "gated_linear"])
@pytest.mark.parametrize("arch,d", SLICES)
def test_two_layer_loss_and_gradients_match_jax(arch, d, backend):
    """``lm_loss`` against ``jax.value_and_grad`` on a batch of the
    synthetic stream (T = 40: not a multiple of the chunk of 16, so both
    pad): the loss within 1e-5 relative, every gradient leaf within 1e-4
    normwise; the attention cores at D = ``d``."""
    jcfg, tcfg, pj, pt = _models(arch, d, backend)
    assert tcfg.n_layers == 2 and tcfg.head_dim == d
    batch = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=40,
                               global_batch=2, seed=1).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, Rules.null()),
        has_aux=True))(pj)
    t_loss, _, t_grads = GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), pt,
        {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    t_leaves = leaves(t_grads)
    j_leaves = jax.tree.leaves(jax.tree.map(np.asarray, grads))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape
        err = np.abs(t.numpy() - j).max()
        assert err <= 1e-4 * np.abs(j).max(), err
