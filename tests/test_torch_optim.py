"""The port's optimizer substrate and synthetic data against the JAX
package, from the same numpy values: AdamW/Adam over three updates
(clipping on and off, schedules, weight decay), the schedules,
``global_norm``, ``clip_by_global_norm``, ``apply_updates`` and
``GradAccumulator``, within 1e-6 relative (fp32 arithmetic in another
order, and XLA's pow against PyTorch's); ``SyntheticLMDataset.batch_at``
bit for bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.data import SyntheticLMDataset as JaxDataset
from repro_torch import optim as topt
from repro_torch.data import SyntheticLMDataset
from repro_torch.tree import leaves

RTOL = 1e-6


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    r = lambda *s: (scale * rng.standard_normal(s)).astype(np.float32)  # noqa
    return {"embed": r(6, 4), "stack": ({"w": r(2, 4, 4), "b": r(2, 4)},),
            "final_norm": {"scale": r(4)}}


def _to_torch(tree):
    return jax.tree.map(lambda x: torch.tensor(np.asarray(x)), tree)


def _close(t_tree, j_tree, rtol=RTOL):
    t_leaves, j_leaves = leaves(t_tree), jax.tree.leaves(j_tree)
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        j = np.asarray(j)
        assert t.shape == j.shape
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=rtol,
                                   atol=rtol * np.abs(j).max())


SCHEDULES = {
    "constant": lambda m: m.constant(3e-2),
    "linear_warmup": lambda m: m.linear_warmup(3e-2, warmup=2),
    "cosine_warmup": lambda m: m.cosine_warmup(3e-2, warmup=2, total=5),
}


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedules_match_jax(schedule):
    jfn, tfn = SCHEDULES[schedule](jopt), SCHEDULES[schedule](topt)
    for step in range(9):
        want = np.asarray(jfn(jnp.int32(step)))
        got = tfn(torch.tensor(step, dtype=torch.int32))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)


@pytest.mark.parametrize("kind,grad_scale", [
    ("adamw", 1.0),       # global norm above clip_norm: clipped
    ("adamw", 0.01),      # below it: not clipped
    ("adam", 1.0),
    ("adamw_noclip", 1.0),
])
def test_three_updates_match_jax(kind, grad_scale):
    def make(m):
        lr = m.cosine_warmup(3e-2, warmup=2, total=5)
        if kind == "adam":
            return m.adam(lr)
        return m.adamw(lr, weight_decay=0.1,
                       clip_norm=None if kind == "adamw_noclip" else 1.0)
    jo, to = make(jopt), make(topt)
    p_j = _tree(0)
    p_t = _to_torch(p_j)
    s_j, s_t = jo.init(p_j), to.init(p_t)
    for i in range(3):
        g = _tree(10 + i, scale=grad_scale)
        p_j, s_j = jo.update(g, s_j, p_j)
        p_t, s_t = to.update(_to_torch(g), s_t, p_t)
        _close(p_t, p_j)
        _close(s_t.mu, s_j.mu)
        _close(s_t.nu, s_j.nu)
        assert int(s_t.step) == int(s_j.step) == i + 1


def test_update_writes_params_and_moments_in_place():
    opt = topt.adamw(1e-2, weight_decay=0.1)
    params = _to_torch(_tree(0))
    state = opt.init(params)
    ptrs = [x.data_ptr() for x in leaves((params, state.mu, state.nu))]
    grads = _to_torch(_tree(1))
    g_before = [g.clone() for g in leaves(grads)]
    new_params, new_state = opt.update(grads, state, params)
    assert new_params is params
    assert ptrs == [x.data_ptr() for x in leaves(
        (new_params, new_state.mu, new_state.nu))]
    assert all(torch.equal(a, b) for a, b in zip(leaves(grads), g_before))


@pytest.mark.parametrize("scale", [1.0, 0.01])
def test_global_norm_clip_and_apply_updates_match_jax(scale):
    g = _tree(3, scale=scale)
    np.testing.assert_allclose(
        topt.global_norm(_to_torch(g)).numpy(),
        np.asarray(jopt.global_norm(g)), rtol=RTOL)
    _close(topt.clip_by_global_norm(_to_torch(g), 1.0),
           jopt.clip_by_global_norm(g, 1.0))
    p = _tree(4)
    _close(topt.apply_updates(_to_torch(p), _to_torch(g)),
           jopt.apply_updates(p, g))


def _quadratic_loss(np_mod):
    """loss(params, batch) = mean((x @ w + b - y)²), metrics {"mse"}."""
    def fn(params, batch):
        pred = batch["x"] @ params["w"] + params["b"]
        mse = np_mod.mean((pred - batch["y"]) ** 2)
        return mse, {"mse": mse}
    return fn


@pytest.mark.parametrize("n_micro", [1, 2, 4])
def test_grad_accumulator_matches_jax(n_micro):
    rng = np.random.default_rng(5)
    params = {"w": rng.standard_normal((3, 2)).astype(np.float32),
              "b": rng.standard_normal(2).astype(np.float32)}
    batch = {"x": rng.standard_normal((8, 3)).astype(np.float32),
             "y": rng.standard_normal((8, 2)).astype(np.float32)}
    loss_j, m_j, g_j = jopt.GradAccumulator(n_micro).run(
        _quadratic_loss(jnp), params, batch)
    loss_t, m_t, g_t = topt.GradAccumulator(n_micro).run(
        _quadratic_loss(torch), _to_torch(params), _to_torch(batch))
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j),
                               rtol=RTOL)
    np.testing.assert_allclose(m_t["mse"].numpy(), np.asarray(m_j["mse"]),
                               rtol=RTOL)
    _close(g_t, g_j)


@pytest.mark.parametrize("structured", [True, False])
@pytest.mark.parametrize("seed,shard,num_shards", [(0, 0, 1), (3, 1, 2)])
def test_synthetic_batches_are_jax_s_bit_for_bit(structured, seed, shard,
                                                 num_shards):
    kw = dict(vocab_size=97, seq_len=33, global_batch=4, seed=seed,
              shard=shard, num_shards=num_shards, structured=structured)
    ours, theirs = SyntheticLMDataset(**kw), JaxDataset(**kw)
    for step in (0, 1, 7, 1000):
        a, b = ours.batch_at(step), theirs.batch_at(step)
        assert a.keys() == b.keys()
        for key in a:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])
    first = next(ours.iter_from(5))
    np.testing.assert_array_equal(first["tokens"],
                                  theirs.batch_at(5)["tokens"])
