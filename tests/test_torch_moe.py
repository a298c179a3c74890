"""The port's MoE FFN (``models/moe.py``) against the JAX package's on the
CPU, on numpy inputs from a seed and parameters from JAX through
``convert``: ``route`` (weights, experts, aux) and ``capacity`` over a
grid, the kept set of the capacity dispatch against a plain count of
each pair's rank, ``moe_apply`` at a capacity that drops pairs and in
its (B, D) decode form, ``moe_dense_oracle``, and the MoE configs' block
parameters.

Tolerances: fp32 within 1e-5 normwise (max|Δ| over max|JAX|: sums in
other orders), the routing weights within 1e-6; the expert ids and the
kept set equal; bf16 within 8e-3 normwise (the JAX kernel tests' bf16
tolerance: both sides round the products and the sum over the k
choices to bf16, in other places)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro.sharding import Rules
from repro_torch import convert
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models import blocks as B
from repro_torch.models import moe as tmoe

RULES = Rules.null()
ARCHS = ["deepseek-moe-16b", "qwen3-moe-235b-a22b"]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(arch, **moe_kw):
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    return (dataclasses.replace(jcfg, moe=dataclasses.replace(jcfg.moe,
                                                              **moe_kw)),
            dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                              **moe_kw)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _params(jcfg, seed=0, dtype=jnp.float32):
    pj = jmoe.moe_params(jax.random.PRNGKey(seed), jcfg, dtype)
    return pj, convert._tree(_np_tree(pj), None)


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _normwise(t, want, tol):
    t = t.detach().float().numpy()
    want = np.asarray(want, np.float32)
    err = np.abs(t - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


def _rank_by_count(experts):
    """Each (token, choice) pair's rank within its expert: the number of
    earlier pairs, in token then choice order, routed to the same
    expert."""
    flat = experts.reshape(-1)
    return np.array([np.sum(flat[:i] == e) for i, e in enumerate(flat)])


@pytest.mark.parametrize("n", [1, 5, 64])
@pytest.mark.parametrize("e,k", [(8, 1), (8, 2), (64, 6), (128, 8)])
def test_route_matches_jax(n, e, k):
    rng = np.random.default_rng(n * 100 + e + k)
    x = rng.standard_normal((n, 32)).astype(np.float32)
    w = (rng.standard_normal((32, e)) * 0.5).astype(np.float32)
    jw, je, jaux = jmoe.route(jnp.asarray(w), jnp.asarray(x), k)
    tw, te, taux = tmoe.route(torch.from_numpy(w), torch.from_numpy(x), k)
    assert te.dtype == torch.int64 and tw.dtype == torch.float32
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("n", [1, 7, 8, 64, 100, 1000, 4096])
@pytest.mark.parametrize("k,e", [(1, 8), (2, 8), (6, 64), (8, 128)])
@pytest.mark.parametrize("factor", [0.25, 1.0, 1.25, 8.0])
def test_capacity_matches_jax(n, k, e, factor):
    assert tmoe.capacity(n, k, e, factor) == jmoe.capacity(n, k, e, factor)


@pytest.mark.parametrize("cap", [1, 2, 3, 8])
def test_dispatch_keeps_the_first_pairs_of_each_expert(cap):
    """The stable argsort + searchsorted rank is each pair's count of
    earlier pairs of its expert; kept pairs land in expert·cap + rank,
    dropped ones in the trash row E·cap."""
    e = 8
    experts = np.random.default_rng(cap).integers(0, e, (40, 2))
    slot, keep = tmoe.dispatch_slots(torch.from_numpy(experts), e, cap)
    rank = _rank_by_count(experts)
    np.testing.assert_array_equal(keep.numpy(), rank < cap)
    flat = experts.reshape(-1)
    np.testing.assert_array_equal(
        slot.numpy(), np.where(rank < cap, flat * cap + rank, e * cap))
    assert not keep.all() or cap == 8


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_drops_as_jax_does(arch):
    """A capacity factor of 0.5 drops pairs (the kept set, from JAX's own
    routing, is checked against the plain rank count); the outputs and
    the aux match JAX's in fp32."""
    jcfg, tcfg = _configs(arch, capacity_factor=0.5)
    pj, pt = _params(jcfg)
    x = _x((2, 24, jcfg.d_model))
    jout, jaux = jmoe.moe_apply(pj, jnp.asarray(x), jcfg, RULES)
    tout, taux = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg)
    _, je, _ = jmoe.route(pj["router"], jnp.asarray(x.reshape(48, -1)),
                          jcfg.moe.top_k)
    cap = tmoe.capacity(48, tcfg.moe.top_k, tcfg.moe.n_experts, 0.5)
    _, keep = tmoe.dispatch_slots(torch.from_numpy(np.array(je)),
                                  tcfg.moe.n_experts, cap)
    want_keep = _rank_by_count(np.asarray(je)) < cap
    np.testing.assert_array_equal(keep.numpy(), want_keep)
    assert not want_keep.all()                 # pairs do drop
    _normwise(tout, jout, 1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_form_matches_jax(arch):
    """(B, D): one token per sequence, the capacity of B tokens."""
    jcfg, tcfg = _configs(arch)
    pj, pt = _params(jcfg, seed=2)
    x = _x((5, jcfg.d_model), seed=3)
    jout, jaux = jmoe.moe_apply(pj, jnp.asarray(x), jcfg, RULES)
    tout, taux = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg)
    assert tout.shape == (5, tcfg.d_model)
    _normwise(tout, jout, 1e-5)
    np.testing.assert_allclose(taux.item(), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_oracle_matches_jax_and_moe_apply(arch):
    """Where nothing drops (capacity factor 8: the capacity is at least
    every expert's load) ``moe_apply`` equals the dense oracle."""
    jcfg, tcfg = _configs(arch, capacity_factor=8.0)
    pj, pt = _params(jcfg, seed=4)
    x = _x((2, 9, jcfg.d_model), seed=5)
    jref = jmoe.moe_dense_oracle(pj, jnp.asarray(x), jcfg)
    tref = tmoe.moe_dense_oracle(pt, torch.from_numpy(x), tcfg)
    _normwise(tref, jref, 1e-5)
    tout, _ = tmoe.moe_apply(pt, torch.from_numpy(x), tcfg)
    torch.testing.assert_close(tout, tref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_matches_jax(arch):
    """bf16 parameters and inputs (the router cast to bf16 as
    ``cast_params`` does, back to fp32 in ``route``)."""
    jcfg, tcfg = _configs(arch, capacity_factor=0.5)
    pj, _ = _params(jcfg, seed=6)
    pj = jax.tree.map(lambda a: a.astype(jnp.bfloat16), pj)
    pt = convert._tree(_np_tree(pj), None)
    assert pt["w_up"].dtype == torch.bfloat16
    x = jnp.asarray(_x((2, 16, jcfg.d_model), seed=7)).astype(jnp.bfloat16)
    jout, _ = jmoe.moe_apply(pj, x, jcfg, RULES)
    tout, _ = tmoe.moe_apply(pt, convert._tensor(np.asarray(x), None), tcfg)
    assert tout.dtype == torch.bfloat16
    _normwise(tout, np.asarray(jout.astype(jnp.float32)), 8e-3)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_block_params_match_jax_layout(arch, dtype):
    """The port's own MoE block: JAX's leaves and shapes, the router in
    fp32 whatever the dtype, experts' weights of std 1/√D (w_down also
    over √(2·n_layers)), and no dense MLP."""
    jcfg, tcfg = jax_smoke_config(arch), get_smoke_config(arch)
    pt = B.block_params("attn", torch.Generator().manual_seed(0), tcfg,
                        lead=(3,), dtype=dtype)
    pj = jax.eval_shape(lambda k: jax.vmap(
        lambda kk: jblocks.block_params("attn", kk, jcfg, jnp.float32))(
            jax.random.split(k, 3)), jax.random.PRNGKey(0))
    assert "mlp" not in pt and set(pt) == set(pj)
    assert set(pt["moe"]) == set(pj["moe"])
    for name, leaf in pt["moe"].items():
        if isinstance(leaf, dict):
            for k2, l2 in leaf.items():
                assert l2.shape == pj["moe"][name][k2].shape
                assert l2.dtype == dtype
            continue
        assert leaf.shape == pj["moe"][name].shape, name
        assert leaf.dtype == (torch.float32 if name == "router" else dtype)
    d, e = tcfg.d_model, tcfg.moe.n_experts
    w_up = pt["moe"]["w_up"].float()
    w_down = pt["moe"]["w_down"].float()
    assert abs(w_up.std().item() * d ** 0.5 - 1.0) < 0.05
    assert abs(w_down.std().item() * d ** 0.5 * (2 * tcfg.n_layers) ** 0.5
               - 1.0) < 0.05
    assert pt["moe"]["w_gate"].shape == (3, e, d, tcfg.moe.d_ff_expert)


def test_full_width_expert_counts():
    for arch, (e, k, f, shared) in {
            "deepseek-moe-16b": (64, 6, 1408, 2),
            "qwen3-moe-235b-a22b": (128, 8, 1536, 0)}.items():
        m = get_config(arch).moe
        assert (m.n_experts, m.top_k, m.d_ff_expert, m.n_shared) == (
            e, k, f, shared)
