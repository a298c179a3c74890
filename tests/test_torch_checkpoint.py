"""The port's checkpoint manager: the JAX package's checkpoint cases
(round trip, atomic ``.tmp``, garbage collection, retention, async,
corrupt steps and the fallback to an older one, bitwise f32 + bf16,
``restore_with``), the async snapshot isolated from in-place updates,
and the on-disk format shared with JAX: a checkpoint written by either
package restores in the other bit for bit, bf16 leaves included."""

import json
import os

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.checkpoint import load_pytree as jax_load_pytree
from repro.checkpoint import save_pytree as jax_save_pytree
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro_torch import convert
from repro_torch.checkpoint import (CheckpointManager, latest_step,
                                    load_pytree, read_extra, read_manifest,
                                    save_pytree)
from repro_torch.configs import get_smoke_config
from repro_torch.optim import AdamState
from repro_torch.tree import leaves, leaves_with_paths, tree_map


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"w": torch.randn((8, 4), generator=g),
                       "b": torch.zeros(4)},
            "opt": {"mu": torch.ones((8, 4)) * 0.5}}


def _bits(x):
    """Dtype name and raw bytes of a leaf of either package."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return "bfloat16", x.view(torch.int16).numpy().tobytes()
        return str(x.numpy().dtype), x.numpy().tobytes()
    x = np.asarray(x)
    return str(x.dtype), x.tobytes()


def _assert_bitwise(a_leaves, b_leaves):
    assert len(a_leaves) == len(b_leaves)
    for a, b in zip(a_leaves, b_leaves):
        assert np.shape(a) == np.shape(b)
        assert _bits(a) == _bits(b)


# -- save / load --------------------------------------------------------------

def test_roundtrip(tmp_path):
    t = _tree()
    save_pytree(str(tmp_path / "ck"), t, extra={"step": 7})
    loaded, extra = load_pytree(str(tmp_path / "ck"), t)
    assert extra["step"] == 7
    _assert_bitwise(leaves(loaded), leaves(t))


def test_atomic_no_partial_dir(tmp_path):
    save_pytree(str(tmp_path / "ck"), _tree())
    assert not os.path.exists(str(tmp_path / "ck.tmp"))
    assert sorted(os.listdir(tmp_path / "ck")) == ["arrays.npz",
                                                   "manifest.json"]


def test_interrupted_tmp_garbage_collected(tmp_path):
    os.makedirs(tmp_path / "d" / "step_3.tmp")
    CheckpointManager(str(tmp_path / "d"))
    assert not os.path.exists(tmp_path / "d" / "step_3.tmp")


def test_leaf_paths_are_jax_s():
    """The manifest keys: JAX's tree paths joined by '/' (dict keys
    sorted, NamedTuple fields by name, sequence items by index)."""
    jcfg = jax_smoke_config("qwen3-0.6b").with_backend("linear")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    jtree = {"params": jp, "opt": jadamw(1e-3).init(jp)}
    want = ["/".join(str(getattr(k, "key", getattr(k, "idx", getattr(
        k, "name", k)))) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(jtree)[0]]
    got = [key for key, _ in leaves_with_paths(_port_lm_tree(jtree))]
    assert got == want and len(got) == 40
    assert got[:3] == ["opt/step", "opt/mu/embed", "opt/mu/final_norm/scale"]


# -- the manager --------------------------------------------------------------

def test_save_restore_latest(tmp_path):
    m = CheckpointManager(str(tmp_path / "d"), keep=2)
    t = _tree()
    m.save(10, t, extra={"step": 10})
    t2 = tree_map(lambda x: x + 1, t)
    m.save(20, t2, extra={"step": 20})
    restored, extra, step = m.restore(t)
    assert step == 20 and extra["step"] == 20
    assert torch.equal(restored["params"]["w"], t2["params"]["w"])


def test_retention(tmp_path):
    m = CheckpointManager(str(tmp_path / "d"), keep=2)
    for s in (1, 2, 3, 4):
        m.save(s, _tree())
    assert m.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path / "d")) == ["step_3", "step_4"]


def test_async_save(tmp_path):
    m = CheckpointManager(str(tmp_path / "d"))
    m.save(5, _tree(), blocking=False)
    m.wait()
    assert latest_step(str(tmp_path / "d")) == 5 and m.has_checkpoint()


def test_async_snapshot_isolated_from_in_place_mutation(tmp_path):
    """The writer persists the values at ``save()`` time although the
    live tensors are updated in place afterwards, as AdamW does."""
    m = CheckpointManager(str(tmp_path / "d"))
    t = {"w": torch.ones(1 << 16), "step": torch.tensor(3, dtype=torch.int32)}
    m.save(1, t, blocking=False)
    t["w"].mul_(100.0)
    t["step"].add_(1)
    m.wait()
    restored, _, _ = m.restore(tree_map(torch.zeros_like, t))
    assert torch.equal(restored["w"], torch.ones(1 << 16))
    assert restored["step"].item() == 3 and restored["step"].shape == ()


def test_restore_empty_raises(tmp_path):
    m = CheckpointManager(str(tmp_path / "d"))
    with pytest.raises(FileNotFoundError):
        m.restore({"w": torch.zeros(1)})


def test_restore_places_leaves_on_the_template_s_dtype(tmp_path):
    save_pytree(str(tmp_path / "ck"), {"w": torch.arange(4.0)})
    out, _ = load_pytree(str(tmp_path / "ck"),
                         {"w": torch.zeros(4, dtype=torch.float64)})
    assert out["w"].dtype == torch.float64
    assert out["w"].tolist() == [0.0, 1.0, 2.0, 3.0]


# -- corrupt checkpoints ------------------------------------------------------

def _saved(tmp_path, steps=(1, 2)):
    m = CheckpointManager(str(tmp_path / "d"), keep=4)
    trees = {}
    for s in steps:
        trees[s] = tree_map(lambda x, s=s: x + s, _tree())
        m.save(s, trees[s], extra={"step": s})
    return m, trees


def test_truncated_npz_raises_naming_path(tmp_path):
    m, _ = _saved(tmp_path)
    npz = tmp_path / "d" / "step_2" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[: npz.stat().st_size // 2])
    with pytest.raises(ValueError, match="step_2"):
        m.restore(_tree(), step=2)


def test_missing_manifest_raises_naming_path(tmp_path):
    m, _ = _saved(tmp_path)
    os.remove(tmp_path / "d" / "step_2" / "manifest.json")
    with pytest.raises(ValueError, match="step_2"):
        m.restore(_tree(), step=2)


def test_undecodable_manifest_raises_naming_path(tmp_path):
    m, _ = _saved(tmp_path)
    (tmp_path / "d" / "step_2" / "manifest.json").write_text("{oops")
    with pytest.raises(ValueError, match="step_2"):
        read_manifest(str(tmp_path / "d" / "step_2"))
    with pytest.raises(ValueError, match="step_2"):
        m.restore(_tree(), step=2)


def test_corrupt_latest_falls_back_to_previous(tmp_path):
    m, trees = _saved(tmp_path)
    npz = tmp_path / "d" / "step_2" / "arrays.npz"
    npz.write_bytes(npz.read_bytes()[:16])
    restored, extra, step = m.restore(_tree())
    assert step == 1 and extra["step"] == 1
    assert torch.equal(restored["params"]["w"], trees[1]["params"]["w"])


def test_all_corrupt_raises_value_error(tmp_path):
    m, _ = _saved(tmp_path)
    for s in (1, 2):
        (tmp_path / "d" / f"step_{s}" / "arrays.npz").write_bytes(b"junk")
    with pytest.raises(ValueError):
        m.restore(_tree())


def test_missing_template_leaf_raises(tmp_path):
    m, _ = _saved(tmp_path)
    bigger = dict(_tree(), extra_leaf=torch.zeros(2))
    with pytest.raises(ValueError, match="step_2"):
        m.restore(bigger, step=2)


# -- mixed-dtype trees, bit for bit -------------------------------------------

def _serving_tree():
    g = torch.Generator().manual_seed(1)
    return {
        "state": {"s": torch.randn((2, 4, 8), generator=g),
                  "conv": torch.randn((2, 3, 8), generator=g)},
        "suspended": (
            {"kv": torch.randn((4, 8), generator=g).bfloat16(),
             "pos": torch.tensor(12, dtype=torch.int32)},
        ),
        "slot_ckpt": {"0": {"h": torch.arange(6, dtype=torch.float32)}},
        "adam": AdamState(step=torch.tensor(5, dtype=torch.int32),
                          mu={"w": torch.randn(3, generator=g)},
                          nu={"w": torch.rand(3, generator=g)}),
    }


def test_bitwise_roundtrip_f32_bf16(tmp_path):
    t = _serving_tree()
    m = CheckpointManager(str(tmp_path / "d"))
    m.save(1, t, extra={"journal_seq": 42})
    restored, extra, step = m.restore(t)
    assert extra["journal_seq"] == 42 and step == 1
    _assert_bitwise(leaves(restored), leaves(t))
    assert isinstance(restored["adam"], AdamState)
    meta = read_manifest(str(tmp_path / "d" / "step_1"))
    assert meta["dtypes"]["suspended/0/kv"] == "bfloat16"
    assert meta["dtypes"]["adam/step"] == "int32"
    assert "adam/mu/w" in meta["keys"]


def test_atomic_tmp_then_replace(tmp_path):
    m = CheckpointManager(str(tmp_path / "d"))
    m.save(3, _serving_tree())
    assert os.listdir(tmp_path / "d") == ["step_3"]


def test_restore_with_data_dependent_template(tmp_path):
    t = _serving_tree()
    m = CheckpointManager(str(tmp_path / "d"))
    m.save(1, t, extra={"n_suspended": 1})
    seen = {}

    def like_fn(extra):
        seen.update(extra)
        return t

    restored, extra, _ = m.restore_with(like_fn)
    assert seen["n_suspended"] == 1 == extra["n_suspended"]
    assert read_extra(str(tmp_path / "d" / "step_1")) == {"n_suspended": 1}
    _assert_bitwise(leaves(restored), leaves(t))


# -- the format shared with the JAX package -----------------------------------

def _jax_lm_tree():
    """A smoke qwen3-0.6b {"params", "opt"} tree of JAX's, the moments
    and step off their zero init."""
    jcfg = jax_smoke_config("qwen3-0.6b").with_backend("linear")
    jp = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    opt = jadamw(1e-3).init(jp)
    keys = iter(jax.random.split(jax.random.PRNGKey(1), 64))
    noise = lambda x: jax.random.normal(next(keys), x.shape)  # noqa: E731
    opt = opt._replace(step=jnp.int32(7), mu=jax.tree.map(noise, opt.mu),
                       nu=jax.tree.map(lambda x: noise(x) ** 2, opt.nu))
    return {"params": jp, "opt": opt}


def _port_lm_tree(jtree):
    cfg = get_smoke_config("qwen3-0.6b").with_backend("linear")
    np_tree = jax.tree.map(np.asarray, jtree)
    return {"params": convert.params_from_jax(np_tree["params"], cfg),
            "opt": convert.opt_state_from_jax(np_tree["opt"], cfg)}


def _zero_like(tree):
    return tree_map(torch.zeros_like, tree)


def test_jax_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    jtree = _jax_lm_tree()
    jax_save_pytree(str(tmp_path / "ck"), jtree, extra={"step": 7})
    template = _zero_like(_port_lm_tree(jtree))
    got, extra = load_pytree(str(tmp_path / "ck"), template)
    assert extra == {"step": 7}
    _assert_bitwise(leaves(got), jax.tree.leaves(jtree))
    assert got["opt"].step.dtype == torch.int32 and got["opt"].step.item() == 7


def test_port_checkpoint_restores_in_jax_bit_for_bit(tmp_path):
    jtree = _jax_lm_tree()
    save_pytree(str(tmp_path / "ck"), _port_lm_tree(jtree),
                extra={"step": 7})
    got, extra = jax_load_pytree(str(tmp_path / "ck"),
                                 jax.tree.map(jnp.zeros_like, jtree))
    assert extra == {"step": 7}
    _assert_bitwise(jax.tree.leaves(got), jax.tree.leaves(jtree))
    meta = json.loads((tmp_path / "ck" / "manifest.json").read_text())
    assert meta["keys"][0] == "opt/step"


def _bf16_trees():
    rng = np.random.default_rng(2)
    a = rng.standard_normal((5, 3)).astype(np.float32)
    v = rng.standard_normal(7).astype(np.float32)
    jtree = {"a": jnp.asarray(a, jnp.bfloat16),
             "b": {"c": jnp.asarray(a[0])},
             "t": (jnp.int32(-4), jnp.asarray(v, jnp.bfloat16))}
    ttree = {"a": torch.from_numpy(a).bfloat16(),
             "b": {"c": torch.from_numpy(a[0].copy())},
             "t": (torch.tensor(-4, dtype=torch.int32),
                   torch.from_numpy(v).bfloat16())}
    return jtree, ttree


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_bf16_tree_crosses_packages_bit_for_bit(tmp_path, writer):
    jtree, ttree = _bf16_trees()
    _assert_bitwise(leaves(ttree), jax.tree.leaves(jtree))
    path = str(tmp_path / "ck")
    if writer == "jax":
        jax_save_pytree(path, jtree)
        got, _ = load_pytree(path, _zero_like(ttree))
        assert got["a"].dtype == torch.bfloat16
        _assert_bitwise(leaves(got), jax.tree.leaves(jtree))
    else:
        save_pytree(path, ttree)
        got, _ = jax_load_pytree(path, jtree)
        assert np.asarray(got["a"]).dtype == ml_dtypes.bfloat16
        _assert_bitwise(jax.tree.leaves(got), leaves(ttree))
    meta = read_manifest(path)
    assert meta["dtypes"]["a"] == meta["dtypes"]["t/1"] == "bfloat16"


def test_jax_float8_leaf_refused_naming_the_path(tmp_path):
    """The port holds no float8 tree: JAX's raw float8 bytes raise a
    ValueError that names the checkpoint and the leaf."""
    jax_save_pytree(str(tmp_path / "ck"), {
        "w": jnp.ones((4,), jnp.float8_e4m3fn)})
    with pytest.raises(ValueError, match="ck.*'w'.*float8"):
        load_pytree(str(tmp_path / "ck"), {"w": torch.zeros(4)})
