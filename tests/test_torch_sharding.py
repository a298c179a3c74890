"""The port's logical sharding rules against the JAX package's, on the
CPU, with no process group:

- ``Rules.spec`` against JAX's ``Rules`` (built from a table, no devices)
  for the same mesh shapes, every case of JAX's ``tests/test_sharding.py``
  run within torch;
- the spec trees (``param_specs``, ``decode_state_specs``,
  ``opt_state_specs``, ``train_state_specs``) equal to JAX's leaf for
  leaf for every config module under every attention backend, and the
  resolved specs (with the divisibility fallback) for each smoke config;
- ``plan_mesh_shape`` and ``accum_for_batch`` equal to JAX's over a grid;
- each rank's block under the placements the port resolves equal to the
  block of JAX's ``NamedSharding.devices_indices_map`` at the same mesh
  coordinates (JAX in one subprocess with four host devices, two
  threads).
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
from jax.sharding import PartitionSpec as P

from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.optim.adamw import opt_state_specs as j_opt_state_specs
from repro.runtime import elastic as jelastic
from repro.runtime.steps import train_state_specs as j_train_state_specs
from repro.sharding import DEFAULT_RULES as J_DEFAULT_RULES
from repro.sharding import Rules as JRules
from repro.sharding import tree_specs as j_tree_specs
from repro_torch import configs as tconfigs
from repro_torch.models import lm as tlm
from repro_torch.models.attention import AttnState
from repro_torch.optim import opt_state_specs
from repro_torch.runtime import accum_for_batch, plan_mesh_shape
from repro_torch.runtime.steps import train_state_specs
from repro_torch.sharding import (
    DEFAULT_RULES, UNEVEN_OK, Rules, constrain, is_logical_spec, placements,
    tree_specs)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-0.6b", "deepseek-moe-16b", "qwen3-moe-235b-a22b",
         "llama-3.2-vision-90b", "musicgen-large", "yi-34b",
         "internlm2-20b", "phi3-mini-3.8b", "rwkv6-1.6b", "zamba2-7b"]
BACKENDS = ["softmax", "linear", "gated_linear"]


def _rules(pod=0, data=16, model=16):
    axes = (("pod",) if pod else ()) + ("data", "model")
    shape = ((pod,) if pod else ()) + (data, model)
    return Rules(table=dict(DEFAULT_RULES), mesh_axes=axes,
                 mesh_shape=dict(zip(axes, shape)))


def _jrules(pod=0, data=16, model=16):
    axes = (("pod",) if pod else ()) + ("data", "model")
    shape = ((pod,) if pod else ()) + (data, model)
    return JRules(table=dict(J_DEFAULT_RULES), mesh_axes=axes,
                  mesh_shape=dict(zip(axes, shape)))


def test_default_tables_equal():
    assert DEFAULT_RULES == J_DEFAULT_RULES
    from repro.sharding import UNEVEN_OK as J_UNEVEN_OK
    assert UNEVEN_OK == J_UNEVEN_OK


# -- JAX's tests/test_sharding.py within torch ------------------------------

class TestResolution:
    def test_batch_maps_to_pod_data(self):
        assert _rules(pod=2).spec("batch", None) == (("pod", "data"), None)

    def test_single_pod_drops_pod_axis(self):
        assert _rules().spec("batch", None) == ("data", None)

    def test_model_axes(self):
        r = _rules()
        assert r.spec("vocab", "embed") == ("model", None)
        assert r.spec("fsdp", "ffn") == ("data", "model")

    def test_unknown_logical_is_replicated(self):
        assert _rules().spec("nonexistent", None) == (None, None)

    def test_divisibility_fallback(self):
        r = _rules()
        assert r.spec("heads", shape=(56,)) == (None,)
        assert r.spec("heads", shape=(64,)) == ("model",)

    def test_fallback_drops_pod_first(self):
        assert _rules(pod=2).spec("fsdp", shape=(48,)) == ("data",)

    def test_uneven_ok_axes_skip_check(self):
        assert _rules().spec("heads_lin", shape=(56,)) == ("model",)

    def test_state_axes_must_divide(self):
        r = _rules()
        assert r.spec("kv_heads_state", shape=(8,)) == (None,)
        assert r.spec("kv_heads_state", shape=(16,)) == ("model",)

    def test_duplicate_axis_dropped(self):
        r = _rules()
        assert r.spec("kv_heads_state", "head_dim_state",
                      shape=(16, 128)) == ("model", None)
        assert r.spec("kv_heads_state", "head_dim_state",
                      shape=(8, 128)) == (None, "model")

    def test_null_rules_noop(self):
        r = Rules.null()
        assert r.spec("batch", "ffn") == (None, None)
        assert r.model_size == 1 and not r.on_mesh


class TestTreeSpecs:
    def test_named_tuple_descent(self):
        assert not is_logical_spec(AttnState(None, None, ("a",), None))
        assert is_logical_spec(("batch", None))
        assert is_logical_spec(())
        assert not is_logical_spec((("batch",),))

    def test_tree_mapping_with_shapes(self):
        specs = tree_specs({"a": ("batch", "ffn"), "b": ("heads",)},
                           _rules(), {"a": (256, 1024), "b": (56,)})
        assert specs["a"] == ("data", "model")
        assert specs["b"] == (None,)

    def test_constrain_noop_off_mesh(self):
        import torch
        x = torch.ones(4, 4)
        assert constrain(x, Rules.null(), "batch", None) is x


# -- Rules.spec against JAX's over meshes, names and shapes ------------------

MESHES = [dict(pod=0, data=16, model=16), dict(pod=2, data=16, model=16),
          dict(pod=0, data=2, model=2), dict(pod=0, data=4, model=1),
          dict(pod=0, data=1, model=4), dict(pod=2, data=1, model=2)]
NAMES = sorted(J_DEFAULT_RULES) + ["nonexistent"]
SIZES = [1, 2, 6, 8, 16, 48, 56, 64, 96, 4096]


@pytest.mark.parametrize("mesh", MESHES, ids=lambda m: "x".join(
    str(v) for v in m.values()))
def test_spec_against_jax(mesh):
    r, jr = _rules(**mesh), _jrules(**mesh)
    for a in NAMES:
        assert r.spec(a) == tuple(jr.spec(a)), a
        for n in SIZES:
            assert r.spec(a, shape=(n,)) == tuple(jr.spec(a, shape=(n,))), \
                (a, n)
        for b in NAMES:
            for shape in ((8, 128), (16, 56), (6, 6)):
                assert r.spec(a, b, shape=shape) == tuple(
                    jr.spec(a, b, shape=shape)), (a, b, shape)


# -- spec trees ----------------------------------------------------------------

def _canon(tree):
    """A tree as nested plain values: NamedTuples by class name and
    fields (AttnState vs AttnState of the other package), JAX's
    PartitionSpec as a tuple. A dict entry that holds no leaf (JAX's
    ``"shared": {}``, which the port's tree leaves out) is dropped: the
    trees are compared leaf for leaf."""
    if isinstance(tree, dict):
        return {k: _canon(v) for k, v in tree.items() if v != {}}
    if isinstance(tree, P):
        return tuple(tree)
    if hasattr(tree, "_fields"):
        return (type(tree).__name__,) + tuple(
            (f, _canon(getattr(tree, f))) for f in tree._fields)
    if isinstance(tree, (tuple, list)) and not is_logical_spec(tree):
        return tuple(_canon(v) for v in tree)
    return tree


def _config_pairs():
    for arch in ARCHS:
        jc, tc = jconfigs.get_config(arch), tconfigs.get_config(arch)
        attn = "attn" in jc.layer_pattern + jc.tail or \
            "shared_attn" in jc.layer_pattern + jc.tail or \
            "cross" in jc.layer_pattern + jc.tail
        for backend in (BACKENDS if attn else [None]):
            if backend is None:
                yield f"{arch}", jc, tc
            else:
                yield (f"{arch}-{backend}", jc.with_backend(backend),
                       tc.with_backend(backend))


PAIRS = list(_config_pairs())


@pytest.mark.parametrize("name,jc,tc", PAIRS, ids=[p[0] for p in PAIRS])
def test_spec_trees_equal_jax(name, jc, tc):
    assert _canon(tlm.param_specs(tc)) == _canon(jlm.param_specs(jc))
    assert _canon(tlm.decode_state_specs(tc)) == \
        _canon(jlm.decode_state_specs(jc))
    assert _canon(opt_state_specs(tlm.param_specs(tc))) == \
        _canon(j_opt_state_specs(jlm.param_specs(jc)))
    assert _canon(train_state_specs(tc, Rules.null())) == \
        _canon(j_train_state_specs(jc, JRules.null()))


@pytest.mark.parametrize("arch", ARCHS)
def test_resolved_param_specs_equal_jax(arch):
    """The specs resolved with each smoke parameter's shape on a (2, 4)
    mesh: the divisibility fallback picks the same axes."""
    import jax
    import torch
    jc, tc = jconfigs.get_smoke_config(arch), tconfigs.get_smoke_config(arch)
    tparams = tlm.init_params(torch.Generator().manual_seed(0), tc)
    jshapes = jax.tree.map(lambda x: x.shape, jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jc)))
    r, jr = _rules(data=2, model=4), _jrules(data=2, model=4)
    from repro_torch.tree import tree_map
    tshapes = tree_map(lambda x: tuple(x.shape), tparams)
    assert _canon(tree_specs(tlm.param_specs(tc), r, tshapes)) == _canon(
        j_tree_specs(jlm.param_specs(jc), jr, jshapes))


# -- elastic planning ------------------------------------------------------------

def test_plan_mesh_shape_and_accum_equal_jax():
    for n in range(1, 600, 7):
        for model in (1, 2, 4, 8, 16):
            for pods in (None, 1, 2, 3):
                try:
                    want = jelastic.plan_mesh_shape(n, model=model,
                                                    prefer_pods=pods)
                except ValueError:
                    with pytest.raises(ValueError):
                        plan_mesh_shape(n, model=model, prefer_pods=pods)
                    continue
                assert plan_mesh_shape(n, model=model,
                                       prefer_pods=pods) == want
    for gb in range(1, 130, 3):
        for dp in range(1, 40, 3):
            for per in (1, 2, 4):
                assert accum_for_batch(gb, dp, per) == \
                    jelastic.accum_for_batch(gb, dp, per)


# -- local blocks against JAX's devices_indices_map -------------------------------

BLOCK_CASES = [
    ((2, 2), ("data", "model"), (8, 12), ("fsdp", "ffn")),
    ((2, 2), ("data", "model"), (12, 8), ("vocab", "embed")),
    ((2, 2), ("data", "model"), (4, 6, 8), ("batch", "seq_sp", None)),
    ((4, 1), ("data", "model"), (8, 12), ("fsdp", "ffn")),
    ((1, 4), ("data", "model"), (8, 12), ("fsdp", "ffn")),
    ((1, 4), ("data", "model"), (2, 8, 5, 16), ("batch", "heads_lin",
                                                 None, None)),
    ((1, 4), ("data", "model"), (4, 10, 2, 16), ("batch", None,
                                                 "kv_heads_state",
                                                 "head_dim_state")),
    ((2, 1, 2), ("pod", "data", "model"), (8, 6), ("batch", "heads")),
    ((2, 2, 1), ("pod", "data", "model"), (12, 6), ("fsdp", None)),
    ((2, 2, 1), ("pod", "data", "model"), (6, 6), ("fsdp", None)),
]

_JAX_BLOCKS = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh, NamedSharding
from repro.sharding import DEFAULT_RULES, Rules
out = []
for mesh_shape, axes, shape, names in json.loads(sys.argv[1]):
    n = int(np.prod(mesh_shape))
    devs = np.array(jax.devices()[:n]).reshape(mesh_shape)
    mesh = Mesh(devs, tuple(axes))
    rules = Rules.for_mesh(mesh)
    spec = rules.spec(*names, shape=shape)
    idx = NamedSharding(mesh, spec).devices_indices_map(tuple(shape))
    blocks = {}
    for coord in np.ndindex(*mesh_shape):
        sl = idx[devs[coord]]
        blocks[",".join(map(str, coord))] = [
            list(s.indices(d))[:2] for s, d in zip(sl, shape)]
    out.append(blocks)
print(json.dumps(out))
"""


def test_local_blocks_equal_jax_devices_indices_map():
    import numpy as np
    from torch.distributed.tensor._utils import (
        _compute_local_shape_and_global_offset)
    env = dict(os.environ)
    env["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                        "--xla_cpu_multi_thread_eigen=false "
                        "intra_op_parallelism_threads=2")
    env["PYTHONPATH"] = str(ROOT / "src")
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_BLOCKS, json.dumps(BLOCK_CASES)],
        env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    jax_blocks = json.loads(proc.stdout.strip().splitlines()[-1])
    for (mesh_shape, axes, shape, names), want in zip(BLOCK_CASES,
                                                      jax_blocks):
        rules = Rules(table=dict(DEFAULT_RULES), mesh_axes=axes,
                      mesh_shape=dict(zip(axes, mesh_shape)))
        pl = placements(rules.spec(*names, shape=shape), axes)
        for coord in np.ndindex(*mesh_shape):
            local, offset = _compute_local_shape_and_global_offset(
                shape, mesh_shape, list(coord), pl)
            got = [[o, o + n] for o, n in zip(offset, local)]
            # an empty block: JAX's slice is (n, n), DTensor's offset may
            # be anywhere; both hold nothing
            exp = want[",".join(map(str, coord))]
            for g, e, d in zip(got, exp, shape):
                if e[0] >= e[1]:
                    assert g[1] - g[0] == 0, (names, coord)
                else:
                    assert g == e, (mesh_shape, names, coord, got, exp)
