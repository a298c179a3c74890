"""The port's softmax training slice against the JAX package on the CPU:
qwen3-0.6b smoke config under ``attention_backend="softmax"``, fp32,
parameters from JAX through ``convert.params_from_jax``, batches from the
synthetic stream (T = 24).

The attention is ``flash_attention`` under autograd: B10's plain version
forward with its log-sum-exp (the CUDA kernel on the card) and JAX's
blockwise ``_flash_bwd`` in plain PyTorch. Two block sizes: the model's
``attn_block_q`` = 512 (one block, T < block) and 16 (T = 24 spans two
query blocks and three causal pairs).

Tolerances: the loss within 1e-5 relative and every gradient leaf within
max|Δ| ≤ 1e-4 · max|g_JAX| (fp32 sums in other orders through two
layers, the head and the cross-entropy); three AdamW steps' metrics
within 1e-4 relative; bf16 compute's loss within 2e-2 relative.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.data import SyntheticLMDataset
from repro.models import lm as jlm
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine
from repro.runtime import make_train_step as jmake_train_step
from repro.sharding import Rules
from repro_torch import convert
from repro_torch import optim as topt
from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.runtime import make_eval_step, make_train_step
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
RULES = Rules.null()
B, T, STEPS, LR = 2, 24, 3, 3e-3
BLOCKS = [512, 16]


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32", block=512):
    kw = dict(dtype=dtype, attn_block_q=block)
    return (dataclasses.replace(
                jax_smoke_config("qwen3-0.6b").with_backend("softmax"), **kw),
            dataclasses.replace(
                get_smoke_config("qwen3-0.6b").with_backend("softmax"), **kw))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches():
    ds = SyntheticLMDataset(vocab_size=256, seq_len=T, global_batch=B,
                            seed=0)
    return [ds.batch_at(i) for i in range(STEPS)]


def _tb(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _optimizers():
    return (jadamw(jcosine(LR, warmup=1, total=STEPS), weight_decay=0.1),
            topt.adamw(topt.cosine_warmup(LR, warmup=1, total=STEPS),
                       weight_decay=0.1))


@pytest.fixture(scope="module")
def jax_runs():
    """Per block size: JAX's loss and grads on batch 0 and the metrics
    of three jitted train steps, from the same initial parameters."""
    out = {}
    for block in BLOCKS:
        jcfg, _ = _configs(block=block)
        pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
        batches = _batches()
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jlm.lm_loss(p, batches[0], jcfg, RULES),
            has_aux=True)(pj)
        jopt, _ = _optimizers()
        step = jax.jit(jmake_train_step(jcfg, RULES, jopt))
        params, state, traj = pj, jopt.init(pj), []
        for b in batches:
            params, state, m = step(params, state, b)
            traj.append({k: float(v) for k, v in m.items()})
        out[block] = dict(params0=_np(pj), loss=float(loss),
                          xent=float(metrics["xent"]), grads=_np(grads),
                          traj=traj, params_end=_np(params))
    return out


def _port_grads(params, batch, tcfg, **kw):
    return topt.GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg, **kw), params, _tb(batch))


@pytest.mark.parametrize("block", BLOCKS)
def test_loss_and_every_gradient_leaf_match_jax(jax_runs, block):
    run = jax_runs[block]
    _, tcfg = _configs(block=block)
    before = FA.fwd.launches
    loss, metrics, grads = _port_grads(
        convert.params_from_jax(run["params0"], tcfg), _batches()[0], tcfg)
    assert FA.fwd.launches == before           # CPU: the plain version
    np.testing.assert_allclose(loss.item(), run["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics["xent"].item(), run["xent"],
                               rtol=1e-5)
    t_leaves, j_leaves = leaves(grads), jax.tree.leaves(run["grads"])
    assert len(t_leaves) == len(j_leaves) == 13
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape and t.dtype == torch.float32
        err = np.abs(t.numpy() - j).max()
        assert err <= 1e-4 * np.abs(j).max(), err


@pytest.mark.parametrize("block", BLOCKS)
def test_three_train_steps_match_jax_trajectory(jax_runs, block):
    run = jax_runs[block]
    _, tcfg = _configs(block=block)
    _, opt = _optimizers()
    step = make_train_step(tcfg, opt)
    params = convert.params_from_jax(run["params0"], tcfg)
    state = opt.init(params)
    for b, want in zip(_batches(), run["traj"]):
        params, state, m = step(params, state, _tb(b))
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), want[key], rtol=1e-4)
    for t, j in zip(leaves(params), jax.tree.leaves(run["params_end"])):
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())


def test_remat_unit_and_none_and_both_routes_give_equal_grads(jax_runs):
    """Recomputing each layer's forward in the backward (remat="unit")
    changes nothing, bit for bit; nor does ``attention_kernel=False`` on
    CPU tensors (both are the plain version)."""
    run = jax_runs[16]
    grads = []
    for remat, kernel in (("unit", True), ("none", True), ("unit", False)):
        tcfg = dataclasses.replace(_configs(block=16)[1], remat=remat)
        _, _, g = _port_grads(convert.params_from_jax(run["params0"], tcfg),
                              _batches()[0], tcfg, attention_kernel=kernel)
        grads.append(leaves(g))
    for other in grads[1:]:
        for a, b in zip(grads[0], other):
            assert torch.equal(a, b)


def test_bf16_loss_matches_jax():
    jcfg, tcfg = _configs("bfloat16")
    pj = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batches()[0]
    want, _ = jlm.lm_loss(pj, batch, jcfg, RULES)
    loss, _ = tlm.lm_loss(convert.params_from_jax(_np(pj), tcfg), _tb(batch),
                          tcfg)
    np.testing.assert_allclose(loss.item(), float(want), rtol=2e-2)


def test_eval_step_is_the_loss_without_gradients(jax_runs):
    run = jax_runs[512]
    _, tcfg = _configs()
    m = make_eval_step(tcfg)(convert.params_from_jax(run["params0"], tcfg),
                             _tb(_batches()[0]))
    np.testing.assert_allclose(m["loss"].item(), run["loss"], rtol=1e-5)
    assert not m["loss"].requires_grad


def test_train_build_two_steps_at_smoke_size():
    """``launch/train.py --backend softmax`` through ``build`` and the
    loop: two steps of finite losses under the softmax config."""
    args = ttrain.parse_args(["--smoke", "--device", "cpu", "--backend",
                              "softmax", "--steps", "2", "--batch", "2",
                              "--seq-len", "16", "--log-every", "1"])
    assert ttrain.config(args).attention_backend == "softmax"
    out = ttrain.build(args).run()
    assert out["step"] == 2
    losses = [m["loss"] for m in out["metrics"]]
    assert len(losses) == 2 and all(np.isfinite(losses))


def test_train_cli_softmax_on_cpu_loss_falls():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    # two intra-op threads, as the test process has: torch's default of
    # one per core, beside the other test workers, oversubscribes the
    # CPU and slows each step by two orders of magnitude
    env.update(OMP_NUM_THREADS="2", MKL_NUM_THREADS="2")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--backend", "softmax", "--steps", "30"],
        env=env, capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-2].startswith("final step 30  loss ")
    first, last = (float(x) for x in
                   lines[-2].split("loss ")[1].split()[0:3:2])
    assert last < first and np.isfinite(last)
    assert "ms/step" in lines[-1] and "90496 params" in lines[-1]
