"""The port's dry run (``launch/dryrun.py``) on a fake process group of
256 ranks, against the JAX package's sharding rules and dry-run
contract.

One subprocess (two threads) starts the fake process group, traces
``run_cell`` on the single-pod mesh (data 16, model 16) at full width
and cut depth, and writes what it saw while this process computes JAX's
specs:

- qwen3-0.6b at 2 layers, ``train_4k`` (softmax: B10 with its lse and
  JAX's blockwise backward) and ``decode_32k``;
- rwkv6-1.6b at 2 layers, ``train_4k``: B8's exclusive route and its
  backward on each rank's heads, fake;
- zamba2-7b at one unit (5 Mamba-2 blocks and the shared attention),
  ``decode_32k``, under the model axis of 16.

Each cell must be ``ok``; each parameter leaf's per-device shape must
be its global shape divided by the mesh axes that JAX's ``tree_specs``
names for it (the serving profile's rules, fsdp off, for decode); the
``long_500k`` softmax cell is skipped as JAX skips it; the artifact has
JAX's keys (``t_trace_s`` in place of the lowering and compile times;
no HLO cost dictionary).

The sandbox's torch is built without CUDA, where Python indexing of a
fake CUDA tensor fails, so the cells trace on fake CPU tensors: the
kernel wrappers take the same fake route (shapes and work, no launch)
on either device. On the card, ``chip_smoke.py`` phase 48 runs the dry
run on fake CUDA tensors.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from repro.configs import get_config as jax_config
from repro.models import lm as jlm
from repro.sharding import DEFAULT_RULES as J_DEFAULT_RULES
from repro.sharding import Rules as JRules
from repro.sharding import tree_specs as jtree_specs

ROOT = Path(__file__).resolve().parents[1]
CELLS = [("qwen3-0.6b", "train_4k", 2), ("qwen3-0.6b", "decode_32k", 2),
         ("rwkv6-1.6b", "train_4k", 2), ("zamba2-7b", "decode_32k", 6)]
# (arch, layers, the serving profile's rules)
PLACED = [("qwen3-0.6b", 2, False), ("qwen3-0.6b", 2, True),
          ("rwkv6-1.6b", 2, False), ("zamba2-7b", 6, True)]
MESH = {"data": 16, "model": 16}

_RANK0 = r'''
import json, sys
import torch
from repro_torch.configs import get_config
from repro_torch.configs.base import with_depth
from repro_torch.launch import dryrun, specs as S
from repro_torch.models import lm
from repro_torch.sharding import Rules, distribute_tree
from repro_torch.tree import leaves_with_paths

cells, placed = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {"cells": [], "placed": []}
for arch, shape, n in cells:
    out["cells"].append(dryrun.run_cell(arch, shape, "single", save=False,
                                        device="cpu", n_layers=n))
out["skip"] = dryrun.run_cell("qwen3-0.6b", "long_500k", "single",
                              save=False, device="cpu", n_layers=2)
mesh = dryrun.make_mesh("single", "cpu")
for arch, n, serving in placed:
    cfg = with_depth(get_config(arch), n)
    rules = Rules.for_mesh(mesh, overrides={"fsdp": None} if serving
                           else None)
    with dryrun._fake_mode():
        p = distribute_tree(S.abstract_params(cfg, device="cpu"),
                            lm.param_specs(cfg), rules)
        out["placed"].append([(path, list(x.shape),
                               list(x.to_local().shape))
                              for path, x in leaves_with_paths(p)])
json.dump(out, open(sys.argv[3], "w"))
'''

# JAX's artifact keys (``repro/launch/dryrun.py`` ``run_cell``) that the
# port keeps, and what it has in place of the rest
JAX_KEYS = {"arch", "shape", "mesh", "backend", "n_devices", "status",
            "t_lower_s", "t_compile_s", "cost", "flops_per_device",
            "hbm_bytes_per_device", "hbm_bytes_upper_per_device",
            "spmd_dump_found", "memory", "collectives", "model_flops",
            "roofline"}
HLO_ONLY = {"t_lower_s", "t_compile_s", "cost", "hbm_bytes_upper_per_device",
            "spmd_dump_found"}


def _cut(cfg, n):
    """``with_depth`` on a JAX config: whole pattern repeats, no tail."""
    pattern = cfg.layer_pattern
    return dataclasses.replace(cfg, n_layers=n,
                               n_repeats=n // len(pattern) if cfg.n_repeats
                               else 0, tail=())


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun")
    (tmp / "rank0.py").write_text(_RANK0)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, str(tmp / "rank0.py"), json.dumps(CELLS),
         json.dumps(PLACED), str(tmp / "out.json")], env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # JAX's per-device shapes meanwhile
    want = []
    for arch, n, serving in PLACED:
        cfg = _cut(jax_config(arch), n)
        table = dict(J_DEFAULT_RULES)
        if serving:
            table["fsdp"] = None
        rules = JRules(table=table, mesh_axes=tuple(MESH),
                       mesh_shape=dict(MESH))
        shapes = jax.eval_shape(lambda k, cfg=cfg: jlm.init_params(k, cfg),
                                jax.ShapeDtypeStruct((2,), np.uint32))
        shape_tree = jax.tree.map(lambda x: x.shape, shapes)
        specs = jtree_specs(jlm.param_specs(cfg), rules, shape_tree)
        flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
        spec_leaves = jax.tree.leaves(
            specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
        local = []
        for (_, leaf), spec in zip(flat, spec_leaves):
            dims = list(leaf.shape)
            for d, ax in enumerate(tuple(spec)):
                for a in ((ax,) if isinstance(ax, str) else (ax or ())):
                    dims[d] //= MESH[a]
            local.append((list(leaf.shape), dims))
        want.append(local)
    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-4000:]
    return json.loads((tmp / "out.json").read_text()), want


@pytest.mark.parametrize("i", range(len(CELLS)),
                         ids=[f"{a}-{s}" for a, s, _ in CELLS])
def test_cell_traces_ok(run, i):
    out, _ = run
    r = out["cells"][i]
    assert r["status"] == "ok", r.get("traceback", r)
    assert r["n_devices"] == 256
    assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
    assert r["memory"]["peak_bytes_per_device"] > 0
    arch, shape, _ = CELLS[i]
    kernels = r["kernels"]
    if arch == "rwkv6-1.6b":      # B8's exclusive route and its backward
        assert kernels == {"gated_linear_attention_fwd": 4,
                           "gated_linear_attention_bwd_exclusive_dq": 2,
                           "gated_linear_attention_bwd_exclusive_dkv": 2}
    if (arch, shape) == ("qwen3-0.6b", "train_4k"):   # B10 and its remat
        assert kernels == {"flash_attention_fwd": 4}
    if shape == "train_4k":       # the gradients' reductions over the mesh
        assert r["collectives"]["count"] > 0


@pytest.mark.parametrize("i", range(len(PLACED)),
                         ids=[f"{a}-{'serving' if s else 'train'}"
                              for a, _, s in PLACED])
def test_per_device_parameter_shapes_follow_jax_specs(run, i):
    out, want = run
    got = out["placed"][i]
    assert len(got) == len(want[i])
    for (path, shape, local), (jshape, jlocal) in zip(got, want[i]):
        assert shape == jshape, path
        assert local == jlocal, path


def test_long_500k_softmax_is_skipped_as_jax_skips_it(run):
    out, _ = run
    r = out["skip"]
    assert r["status"] == "skipped"
    assert r["reason"].startswith("pure softmax attention at 500k context")


def test_artifact_has_jax_keys(run):
    out, _ = run
    r = out["cells"][0]
    assert set(r) - {"traceback"} >= (JAX_KEYS - HLO_ONLY) | {"t_trace_s"}
    assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                "temp_bytes", "alias_bytes",
                                "peak_bytes_per_device"}
    assert set(r["collectives"]) == {"count", "wire_bytes", "payload_bytes",
                                     "by_kind"}
    m = r["memory"]
    assert m["peak_bytes_per_device"] == (
        m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
        - m["alias_bytes"])
    # the train step updates parameters and moments in place: donated
    assert m["alias_bytes"] > 0
