"""The port's training slice against the JAX package on the CPU:
qwen3-0.6b smoke config under ``attention_backend="linear"``, fp32,
parameters from JAX through ``convert.params_from_jax``, batches from the
synthetic stream (T = 24, not a multiple of the chunk 16).

Tolerances: the loss within 1e-5 relative and every gradient leaf within
max|Δ| ≤ 1e-4 · max|g_JAX| (fp32 sums in other orders through two
layers, the head and the cross-entropy); the loss trajectory of three
AdamW steps within 1e-4 relative (the updates compound those
differences); bf16 compute within 2e-2 relative (bf16 rounds at other
places in the two frameworks).
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
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
from repro_torch.launch import train as ttrain
from repro_torch.models import lm as tlm
from repro_torch.runtime import (InjectedFailure, TrainLoop, TrainLoopConfig,
                                 make_eval_step, make_train_step)
from repro_torch.tree import leaves

ROOT = Path(__file__).resolve().parents[1]
RULES = Rules.null()
B, T, STEPS, LR = 2, 24, 3, 3e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _configs(dtype="float32", **kw):
    jcfg = dataclasses.replace(
        jax_smoke_config("qwen3-0.6b").with_backend("linear"), dtype=dtype,
        **kw)
    tcfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend("linear"), dtype=dtype,
        **kw)
    return jcfg, tcfg


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
def jax_run():
    """JAX's loss and grads on batch 0, then three jitted train steps,
    keeping the params and AdamState after step 2."""
    jcfg, _ = _configs()
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    batches = _batches()
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jlm.lm_loss(p, batches[0], jcfg, RULES), has_aux=True)(pj)
    jopt, _ = _optimizers()
    step = jax.jit(jmake_train_step(jcfg, RULES, jopt))
    params, state, traj, after = pj, jopt.init(pj), [], []
    for b in batches:
        after.append((_np(params), _np(state)))
        params, state, m = step(params, state, b)
        traj.append({k: float(v) for k, v in m.items()})
    return dict(params0=_np(pj), loss=float(loss), xent=float(
        metrics["xent"]), grads=_np(grads), traj=traj, before=after,
        params_end=_np(params))


def _port_params(np_params, tcfg):
    return convert.params_from_jax(np_params, tcfg)


def _port_grads(params, batch, tcfg):
    return topt.GradAccumulator(1).run(
        lambda p, b: tlm.lm_loss(p, b, tcfg), params, _tb(batch))


def test_loss_and_every_gradient_leaf_match_jax(jax_run):
    _, tcfg = _configs()
    loss, metrics, grads = _port_grads(
        _port_params(jax_run["params0"], tcfg), _batches()[0], tcfg)
    np.testing.assert_allclose(loss.item(), jax_run["loss"], rtol=1e-5)
    np.testing.assert_allclose(metrics["xent"].item(), jax_run["xent"],
                               rtol=1e-5)
    assert metrics["aux"].item() == 0.0
    t_leaves, j_leaves = leaves(grads), jax.tree.leaves(jax_run["grads"])
    assert len(t_leaves) == len(j_leaves) == 13
    for t, j in zip(t_leaves, j_leaves):
        assert t.shape == j.shape and t.dtype == torch.float32
        err = np.abs(t.numpy() - j).max()
        assert err <= 1e-4 * np.abs(j).max(), err


def test_three_train_steps_match_jax_trajectory(jax_run):
    _, tcfg = _configs()
    _, opt = _optimizers()
    step = make_train_step(tcfg, opt)
    params = _port_params(jax_run["params0"], tcfg)
    state = opt.init(params)
    for b, want in zip(_batches(), jax_run["traj"]):
        params, state, m = step(params, state, _tb(b))
        assert set(m) == set(want) == {"loss", "xent", "aux", "grad_norm"}
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(m[key].item(), want[key], rtol=1e-4)
    for t, j in zip(leaves(params), jax.tree.leaves(jax_run["params_end"])):
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-4,
                                   atol=1e-4 * np.abs(j).max())


def test_jax_adam_state_carried_across_continues_identically(jax_run):
    """Params and AdamState after JAX's step 2, converted; the port's
    step 3 gives JAX's step-3 metrics and parameters."""
    _, tcfg = _configs()
    _, opt = _optimizers()
    np_params, np_state = jax_run["before"][2]
    params = _port_params(np_params, tcfg)
    state = convert.opt_state_from_jax(np_state, tcfg)
    assert int(state.step) == 2 and state.step.dtype == torch.int32
    params, state, m = make_train_step(tcfg, opt)(params, state,
                                                  _tb(_batches()[2]))
    want = jax_run["traj"][2]
    np.testing.assert_allclose(m["loss"].item(), want["loss"], rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"].item(), want["grad_norm"],
                               rtol=1e-4)
    assert int(state.step) == 3
    for t, j in zip(leaves(params), jax.tree.leaves(jax_run["params_end"])):
        np.testing.assert_allclose(t.detach().numpy(), j, rtol=1e-5,
                                   atol=1e-5 * np.abs(j).max())


def test_remat_unit_and_none_give_bitwise_equal_grads(jax_run):
    out = []
    for remat in ("unit", "none"):
        _, tcfg = _configs(remat=remat)
        out.append(_port_grads(_port_params(jax_run["params0"], tcfg),
                               _batches()[0], tcfg))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(leaves(out[0][2]),
                                                 leaves(out[1][2])))


def test_accumulating_two_microbatches_matches_one_batch(jax_run):
    _, tcfg = _configs()
    runs = []
    for n_micro in (1, 2):
        _, opt = _optimizers()
        params = _port_params(jax_run["params0"], tcfg)
        state = opt.init(params)
        params, state, m = make_train_step(tcfg, opt, n_micro=n_micro)(
            params, state, _tb(_batches()[0]))
        runs.append((m, params))
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(runs[1][0][key].item(),
                                   runs[0][0][key].item(), rtol=1e-5)
    for a, b in zip(leaves(runs[0][1]), leaves(runs[1][1])):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_bf16_loss_matches_jax():
    jcfg, tcfg = _configs(dtype="bfloat16")
    pj = jlm.init_params(jax.random.PRNGKey(1), jcfg)
    batch = _batches()[0]
    want, _ = jlm.lm_loss(pj, batch, jcfg, RULES)
    got, _ = tlm.lm_loss(_port_params(_np(pj), tcfg), _tb(batch), tcfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.item(), float(want), rtol=2e-2)


def test_eval_step_is_the_loss_without_gradients(jax_run):
    _, tcfg = _configs()
    params = _port_params(jax_run["params0"], tcfg)
    m = make_eval_step(tcfg)(params, _tb(_batches()[0]))
    assert not m["loss"].requires_grad
    np.testing.assert_allclose(m["loss"].item(), jax_run["loss"], rtol=1e-5)


def test_param_count_matches_jax():
    jcfg, tcfg = _configs()
    assert tlm.param_count(_port_params(
        _np(jlm.init_params(jax.random.PRNGKey(0), jcfg)), tcfg)) == \
        jlm.param_count(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    full = jax.eval_shape(lambda: jlm.init_params(
        jax.random.PRNGKey(0), jax_config("qwen3-0.6b").with_backend(
            "linear")))
    assert sum(int(np.prod(x.shape)) for x in jax.tree.leaves(full)) == \
        596_049_920


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_train_cli_on_cpu_loss_falls():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "qwen3-0.6b", "--smoke", "--backend", "linear",
         "--steps", "30"],
        env=_env(), capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert lines[-2].startswith("final step 30  loss ")
    first, last = (float(x) for x in
                   lines[-2].split("loss ")[1].split()[0:3:2])
    assert last < first and np.isfinite(last)
    assert "ms/step" in lines[-1] and "tokens/s" in lines[-1]


def _args(*extra):
    return ttrain.parse_args(["--smoke", "--device", "cpu", "--steps", "2",
                              "--batch", "2", "--seq-len", "16", *extra])


@pytest.mark.parametrize("backend", ["softmax"])
def test_training_other_backends_raises(backend):
    with pytest.raises(NotImplementedError):
        ttrain.build(_args("--backend", backend))


def test_checkpoint_dir_raises(tmp_path):
    with pytest.raises(NotImplementedError):
        ttrain.build(_args("--backend", "linear", "--ckpt-dir",
                           str(tmp_path / "ck")))
    with pytest.raises(NotImplementedError):
        TrainLoop(None, {}, None, None,
                  TrainLoopConfig(total_steps=1, ckpt_dir=str(tmp_path)))
    assert not (tmp_path / "ck").exists()


@pytest.mark.parametrize("flag", [["--mesh", "1x1"], ["--ckpt-every", "5"]])
def test_unported_flags_refused(flag):
    """The driver has no mesh (one device) and no checkpointing, so their
    flags are not accepted at all."""
    with pytest.raises(SystemExit):
        _args("--backend", "linear", *flag)


def test_train_entry_point_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        ttrain.build(ttrain.parse_args(["--smoke", "--backend", "linear"]))


def test_loop_failure_injection_and_preemption():
    loop = ttrain.build(_args("--backend", "linear", "--steps", "4",
                              "--fail-at-step", "2"))
    with pytest.raises(InjectedFailure):
        loop.run()
    assert loop.step == 2 and len(loop.metrics_history) == 2
    loop = ttrain.build(_args("--backend", "linear", "--steps", "4"))
    loop.request_preemption()
    out = loop.run()
    assert out["step"] == 1 and np.isfinite(out["metrics"][0]["loss"])
    assert set(out["metrics"][0]) == {"loss", "xent", "aux", "grad_norm",
                                      "step_time"}
