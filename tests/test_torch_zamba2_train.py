"""Training zamba2-7b's shapes against the JAX package on the CPU, from
the same numpy inputs (fp32 unless said):

* the training kernels' plain versions at zamba2-7b's attention head dim
  of 112, 2 rows, T = 64: B2's o and state and B3's dq, dk, dv; B8
  inclusive and exclusive with u; B9's dq, dk, dv, dg; each against its
  Pallas function in interpret mode within 1e-5 normwise (bf16 B2/B3 and
  B9 within 8e-3);
* zamba2-7b's smoke config with one attention head of 112 (the full
  config's head dim; d_model 112) under linear, gated_linear and softmax:
  ``lm_loss`` within 1e-5 relative of JAX's and every gradient leaf (the
  shared attention's included) within 1e-4 normwise;
* ``with_depth`` on zamba2-7b: whole units, the tail dropped, the widths
  unchanged, a depth that is not whole units refused;
* ``launch/train.py --arch zamba2-7b --smoke --n-layers 6 --device cpu``
  in a subprocess on two threads: the cut printed, the losses finite.
"""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

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
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import depth_cut, with_depth
from repro_torch.kernels.gated_linear_attention import ops as gops
from repro_torch.kernels.linear_attention import ops as lops
from repro_torch.models import lm as tlm
from repro_torch.optim import GradAccumulator
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
RULES = Rules.null()
TOL = 1e-5
BF16_TOL = 8e-3
D, BH, T, CHUNK = 112, 2, 64, 16
ARCH = "zamba2-7b"


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _inputs(seed):
    """q, k positive (the elu1 regime), v and do signed, the log-decay in
    [-0.6, 0] with a few entries past the clamp (-1)."""
    rng = np.random.default_rng(seed)
    x = [rng.standard_normal((BH, T, D)).astype(np.float32)
         for _ in range(4)]
    g = (-0.6 * rng.random((BH, T, D))).astype(np.float32)
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
def test_b2_b3_plain_versions_at_head_dim_112_match_pallas(dtype):
    """B2's o and state (fp32 in both types) and B3's dq, dk, dv against
    the Pallas ``fwd`` and ``bwd`` in interpret mode."""
    tol = TOL if dtype == "float32" else BF16_TOL
    q, k, v, do, _ = _inputs(0)
    o_j, s_j = jlkernel.fwd(*_j((q, k, v), dtype), chunk=CHUNK,
                            interpret=True)
    o_t, s_t = lops.fwd(*_t((q, k, v), dtype), chunk=CHUNK)
    _close(o_t, o_j, tol, "o")
    _close(s_t, s_j, TOL, "state")
    want = jlkernel.bwd(*_j((q, k, v, do), dtype), chunk=CHUNK,
                        interpret=True)
    got = lops.bwd(*_t((q, k, v, do), dtype), chunk=CHUNK)
    for name, a, j in zip(("dq", "dk", "dv"), got, want):
        _close(a, j, tol, name)


@pytest.mark.parametrize("exclusive", [False, True])
def test_b8_plain_version_at_head_dim_112_matches_pallas(exclusive):
    """B8 inclusive, and exclusive with a bonus u, against the Pallas
    ``fwd`` in interpret mode: o and the final state."""
    q, k, v, _, g = _inputs(1)
    u = (np.random.default_rng(2).standard_normal(D).astype(np.float32)
         if exclusive else None)
    o_j, s_j = jgkernel.fwd(q, k, v, g, u=u, chunk=CHUNK,
                            exclusive=exclusive, interpret=True)
    o_t, s_t = gops.fwd(*_t((q, k, v, g)),
                        u=None if u is None else torch.from_numpy(u),
                        chunk=CHUNK, exclusive=exclusive)
    _close(o_t, o_j, TOL, "o")
    _close(s_t, s_j, TOL, "state")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_b9_plain_version_at_head_dim_112_matches_pallas(dtype):
    """B9's dq, dk, dv and dg against the Pallas ``bwd`` in interpret mode
    (g fp32 in both types)."""
    tol = TOL if dtype == "float32" else BF16_TOL
    q, k, v, do, g = _inputs(3)
    jq, jk, jv, jdo = _j((q, k, v, do), dtype)
    want = jgkernel.bwd(jq, jk, jv, g, jdo, chunk=CHUNK, interpret=True)
    qt, kt, vt, dot = _t((q, k, v, do), dtype)
    got = gops.bwd(qt, kt, vt, torch.from_numpy(g), dot, chunk=CHUNK)
    for name, a, j in zip(("dq", "dk", "dv", "dg"), got, want):
        _close(a, j, tol, name)


def _perturbed(pj, seed):
    """JAX's parameters with the vectors moved off their init values."""
    rng = np.random.default_rng(seed)

    def perturb(path, x):
        keys = [getattr(key, "key", None) for key in path]
        if any(key in ("scale", "norm_scale", "dt_bias", "d_skip", "a_log",
                       "b_gate", "gn_scale", "gn_bias") for key in keys):
            return x + 0.3 * rng.standard_normal(x.shape).astype(np.float32)
        return x
    return jax.tree_util.tree_map_with_path(perturb, pj)


@pytest.mark.parametrize("backend", ["linear", "gated_linear", "softmax"])
def test_head_dim_112_model_loss_and_gradients_match_jax(backend):
    """zamba2-7b's smoke config with one attention head of 112 (d_model
    112), batch 2 x 24 tokens: ``lm_loss`` within 1e-5 relative of
    ``jax.value_and_grad``'s and every gradient leaf, the shared
    attention's included, within 1e-4 normwise."""
    kw = dict(dtype="float32", d_model=112, n_heads=1, n_kv_heads=1,
              head_dim=112)
    jcfg = dataclasses.replace(
        jax_smoke_config(ARCH).with_backend(backend), **kw)
    tcfg = dataclasses.replace(
        get_smoke_config(ARCH).with_backend(backend), **kw)
    pj = _perturbed(jlm.init_params(jax.random.PRNGKey(7), jcfg), 107)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg)
    batch = SyntheticLMDataset(vocab_size=jcfg.vocab_size, seq_len=24,
                               global_batch=2, seed=0).batch_at(0)
    (loss, _), grads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batch, jcfg, RULES), has_aux=True))(pj)
    t_loss, _, t_grads = GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), pt,
        {key: torch.from_numpy(x) for key, x in batch.items()})
    np.testing.assert_allclose(t_loss.item(), float(loss), rtol=1e-5)
    assert set(t_grads["shared"]) == set(grads["shared"]) >= {"attn", "mlp"}
    t_leaves = leaves(t_grads)
    j_leaves = jax.tree.leaves(jax.tree.map(np.asarray, grads))
    assert len(t_leaves) == len(j_leaves)
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape
        assert np.abs(t.numpy() - j).max() <= 1e-4 * np.abs(j).max()


@pytest.mark.parametrize("units", [1, 8, 13])
def test_with_depth_cuts_zamba2_to_whole_units(units):
    """zamba2-7b (13 units of 5 Mamba-2 + 1 shared attention, then 3
    Mamba-2): ``with_depth`` to 6·units layers keeps that many units and
    no tail, every width unchanged; the cut named by ``depth_cut``."""
    full = get_config(ARCH)
    cut = with_depth(full, 6 * units)
    pattern, reps, tail = cut.pattern_and_repeats
    assert (pattern, reps, tail) == (full.layer_pattern, units, ())
    assert cut.n_layers == 6 * units
    for field in ("d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
                  "vocab_size", "ssm"):
        assert getattr(cut, field) == getattr(full, field)
    assert depth_cut(full, cut) == (
        f"{6 * units} of 81 layers: {units} of 13 repeats of "
        f"mamba+mamba+mamba+mamba+mamba+shared_attn, the tail "
        f"mamba+mamba+mamba dropped")


@pytest.mark.parametrize("n_layers", [0, 3, 50, 81])
def test_with_depth_refuses_a_depth_of_partial_units(n_layers):
    """A depth that is not a positive whole number of zamba2-7b's 6-layer
    units (the full 81 among them: 13 units and a tail of 3) raises
    ValueError."""
    with pytest.raises(ValueError, match="not whole repeats"):
        with_depth(get_config(ARCH), n_layers)


def test_train_cli_cuts_zamba2_and_trains_on_cpu():
    """``launch/train.py --arch zamba2-7b --smoke --n-layers 6 --device
    cpu`` (the smoke config's units are 3 layers: 2 units, its tail of 3
    dropped) in a subprocess on two threads: the cut printed, finite
    losses, the cut model's parameters."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="2",
               MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--n-layers", "6", "--device", "cpu", "--steps", "3",
         "--seq-len", "32", "--batch", "2", "--backend", "gated_linear"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert ("depth cut: 6 of 9 layers: 2 of 2 repeats of "
            "mamba+mamba+shared_attn, the tail mamba+mamba+mamba dropped"
            in out.stdout), out.stdout
    m = re.search(r"loss (\S+) -> (\S+)", out.stdout)
    assert m and all(np.isfinite(float(x)) for x in m.groups())
    cfg = with_depth(get_smoke_config(ARCH), 6).with_backend("gated_linear")
    params = tlm.init_params(torch.Generator().manual_seed(0), cfg)
    assert f"{tlm.param_count(params)} params" in out.stdout
