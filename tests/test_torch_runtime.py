"""The port's fault-tolerant training loop on the CPU: a crash and a
relaunch reproduce the uninterrupted run bit for bit (parameters,
AdamState, the losses after the resume), synchronous and async saves; a
preemption request checkpoints and stops; the loop resumes from a
checkpoint that JAX's ``TrainLoop`` wrote, and its next losses equal
JAX's uninterrupted run's within 1e-5 relative (fp32 sums in another
order); ``launch/train.py`` resumes with ``--ckpt-dir`` as JAX's does.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import SyntheticLMDataset as JaxDataset
from repro.optim import adamw as jadamw
from repro.runtime import TrainLoop as JaxTrainLoop
from repro.runtime import TrainLoopConfig as JaxTrainLoopConfig
from repro.runtime.train_loop import InjectedFailure as JaxInjectedFailure
from repro_torch.data import SyntheticLMDataset
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw
from repro_torch.runtime import InjectedFailure, TrainLoop, TrainLoopConfig
from repro_torch.tree import leaves

TOTAL, EVERY = 12, 4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _weights(seed=0):
    rng = np.random.default_rng(seed)
    return {"w1": (rng.standard_normal((16, 32)) * 0.1).astype(np.float32),
            "w2": (rng.standard_normal((32, 64)) * 0.1).astype(np.float32)}


def _dataset(cls):
    return cls(vocab_size=64, seq_len=8, global_batch=4, seed=3)


def _tiny_loop(ckpt_dir=None, total=TOTAL, fail_at=None, async_ckpt=False):
    """A 2-layer MLP on the synthetic stream with the real loop (JAX's
    test problem; tokens past 16 one-hot to zeros, as ``jax.nn.one_hot``
    gives)."""
    params = {k: torch.from_numpy(v) for k, v in _weights().items()}
    opt = adamw(1e-2)

    def step_fn(params, opt_state, batch):
        flat = leaves(params)
        for p in flat:
            p.requires_grad_(True)
        x = (batch["tokens"][..., None] == torch.arange(16)).float()
        logits = torch.tanh(x @ params["w1"]) @ params["w2"]
        nll = -torch.log_softmax(logits, -1).gather(
            -1, batch["labels"][..., None].long()).mean()
        g = dict(zip(sorted(params), torch.autograd.grad(nll, flat)))
        params, opt_state = opt.update(g, opt_state, params)
        return params, opt_state, {"loss": nll.detach()}

    return TrainLoop(step_fn, params, opt.init(params),
                     _dataset(SyntheticLMDataset),
                     TrainLoopConfig(total_steps=total, ckpt_every=EVERY,
                                     ckpt_dir=ckpt_dir, fail_at_step=fail_at,
                                     log_every=100, async_ckpt=async_ckpt))


def _jax_tiny_loop(ckpt_dir=None, total=TOTAL, fail_at=None):
    w = {k: jnp.asarray(v) for k, v in _weights().items()}
    opt = jadamw(1e-2)

    @jax.jit
    def step_fn(params, opt_state, batch):
        def loss_fn(p):
            x = jax.nn.one_hot(batch["tokens"], 16) @ p["w1"]
            logp = jax.nn.log_softmax(jnp.tanh(x) @ p["w2"])
            return -jnp.take_along_axis(
                logp, batch["labels"][..., None], axis=-1).mean()
        loss, grads = jax.value_and_grad(loss_fn)(params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, {"loss": loss}

    return JaxTrainLoop(step_fn, w, opt.init(w), _dataset(JaxDataset),
                        JaxTrainLoopConfig(total_steps=total,
                                           ckpt_every=EVERY,
                                           ckpt_dir=ckpt_dir,
                                           fail_at_step=fail_at,
                                           log_every=100, async_ckpt=False))


def _state_leaves(out):
    return leaves({"params": out["params"], "opt": out["opt_state"]})


@pytest.mark.parametrize("async_ckpt", [False, True])
def test_resume_is_bit_exact(tmp_path, async_ckpt):
    """Run A uninterrupted; run B crashes at step 8 (after its step-8
    checkpoint) and a new loop in the same directory finishes it: the
    parameters, AdamState and the losses of steps 9-12 are run A's bit
    for bit."""
    ref = _tiny_loop(str(tmp_path / "a"), async_ckpt=async_ckpt).run()
    crashing = _tiny_loop(str(tmp_path / "b"), fail_at=8,
                          async_ckpt=async_ckpt)
    with pytest.raises(InjectedFailure):
        crashing.run()
    crashing.ckpt.wait()          # the crashed process's step-8 writer
    assert crashing.ckpt.steps() == [4, 8]
    resumed = _tiny_loop(str(tmp_path / "b"), async_ckpt=async_ckpt)
    assert resumed.step == 8 and resumed.opt_state.step.item() == 8
    out = resumed.run()
    assert ref["step"] == out["step"] == TOTAL
    for a, b in zip(_state_leaves(ref), _state_leaves(out)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [m["loss"] for m in ref["metrics"][8:]] == [
        m["loss"] for m in out["metrics"]]
    assert sorted(os.listdir(tmp_path / "b")) == ["step_12", "step_4",
                                                  "step_8"]


def test_preemption_checkpoints_and_stops(tmp_path):
    loop = _tiny_loop(str(tmp_path / "p"), total=100, async_ckpt=True)
    orig_fn, calls = loop.step_fn, []

    def spy(params, opt_state, batch):
        calls.append(1)
        if len(calls) == 3:
            loop.request_preemption()
        return orig_fn(params, opt_state, batch)

    loop.step_fn = spy
    out = loop.run()
    assert out["step"] == 3 and loop.ckpt.steps() == [3]
    resumed = _tiny_loop(str(tmp_path / "p"), total=100)
    assert resumed.step == 3
    for a, b in zip(_state_leaves(out), leaves(
            {"params": resumed.params, "opt": resumed.opt_state})):
        assert torch.equal(a, b)


def test_restored_tensors_are_the_live_ones(tmp_path):
    """A resume copies into the loop's own tensors: the next in-place
    update writes no checkpoint's buffer."""
    _tiny_loop(str(tmp_path / "c"), total=EVERY).run()
    loop = _tiny_loop(str(tmp_path / "c"), total=EVERY + 1)
    before = [t.data_ptr() for t in leaves(loop.params)]
    assert loop.step == EVERY
    loop.run()
    assert [t.data_ptr() for t in leaves(loop.params)] == before


def test_resumes_from_a_jax_checkpoint(tmp_path):
    """JAX's loop crashes at step 8 after its checkpoint; the port's loop
    in the same directory resumes there, and its losses of steps 9-12
    equal JAX's uninterrupted run's."""
    want = [m["loss"] for m in _jax_tiny_loop().run()["metrics"]]
    with pytest.raises(JaxInjectedFailure):
        _jax_tiny_loop(str(tmp_path / "j"), fail_at=8).run()
    loop = _tiny_loop(str(tmp_path / "j"))
    assert loop.step == 8 and loop.opt_state.step.item() == 8
    out = loop.run()
    np.testing.assert_allclose([m["loss"] for m in out["metrics"]],
                               want[8:], rtol=1e-5)


def _cli(ckpt_dir, *extra):
    return ttrain.parse_args([
        "--smoke", "--device", "cpu", "--backend", "linear", "--steps", "6",
        "--batch", "2", "--seq-len", "16", "--ckpt-every", "2",
        "--ckpt-dir", str(ckpt_dir), "--log-every", "100", *extra])


def test_train_driver_resumes_bit_for_bit(tmp_path):
    """``launch/train.py --ckpt-dir``: crash at step 4, relaunch, finish;
    the LM's parameters and AdamState equal the uninterrupted run's."""
    try:
        ref = ttrain.build(_cli(tmp_path / "a")).run()
        crashing = ttrain.build(_cli(tmp_path / "b", "--fail-at-step", "4"))
        with pytest.raises(InjectedFailure):
            crashing.run()
        crashing.ckpt.wait()
        resumed = ttrain.build(_cli(tmp_path / "b"))
        assert resumed.step == 4
        out = resumed.run()
        for a, b in zip(_state_leaves(ref), _state_leaves(out)):
            assert torch.equal(a, b)
        assert len(_state_leaves(out)) == 40
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


def test_train_driver_sigterm_saves_and_stops(tmp_path):
    try:
        loop = ttrain.build(_cli(tmp_path / "s"))
        orig_fn = loop.step_fn

        def spy(params, opt_state, batch):
            if loop.step == 2:
                os.kill(os.getpid(), signal.SIGTERM)
            return orig_fn(params, opt_state, batch)

        loop.step_fn = spy
        assert loop.run()["step"] == 3
        assert loop.ckpt.steps() == [2, 3]
        assert ttrain.build(_cli(tmp_path / "s")).step == 3
    finally:
        signal.signal(signal.SIGTERM, signal.SIG_DFL)


# ---------------------------------------------------------------------------
# the decode step builder and the runtime's exports
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", ["linear", "softmax"])
def test_decode_step_matches_jax(backend):
    """``make_decode_step`` against JAX's on converted qwen3-0.6b smoke
    weights in fp32, from each package's prefill of one prompt: the
    logits within 1e-5 and the state's leaves within 1e-5 over three
    greedy steps; ``DecodeBackend.decode_step`` gives the same bits."""
    import dataclasses

    from repro.configs import get_smoke_config as jax_smoke_config
    from repro.models import lm as jlm
    from repro.runtime import make_decode_step as jax_make_decode_step
    from repro.sharding import Rules
    from repro_torch import convert
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import lm
    from repro_torch.runtime import make_decode_step
    from repro_torch.serving import backend_for_config

    jcfg = dataclasses.replace(
        jax_smoke_config("qwen3-0.6b").with_backend(backend), dtype="float32")
    tcfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend(backend), dtype="float32")
    pj = jlm.init_params(jax.random.PRNGKey(0), jcfg)
    pt = convert.params_from_jax(jax.tree.map(np.asarray, pj), tcfg)
    prompt = np.random.default_rng(0).integers(0, jcfg.vocab_size, (2, 8))
    _, js = jlm.prefill(pj, jnp.asarray(prompt, jnp.int32), jcfg,
                        Rules.null())
    js = jlm.pad_decode_state(js, jcfg, max_len=16)
    be = backend_for_config(tcfg)
    _, ts = lm.prefill(pt, torch.from_numpy(prompt), tcfg)
    ts = be.pad_decode_state(ts, max_len=16)
    ts2 = lm.snapshot_state(ts, 0), lm.snapshot_state(ts, 1)
    jstep = jax.jit(jax_make_decode_step(jcfg, Rules.null()))
    tstep = make_decode_step(tcfg)
    tok = np.asarray([3, 5])
    for pos in range(8, 11):
        jl, js = jstep(pj, js, jnp.asarray(tok, jnp.int32), jnp.int32(pos))
        tl, ts = tstep(pt, ts, torch.from_numpy(tok), pos)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5,
                                   rtol=1e-5)
        for j, t in zip(jax.tree.leaves(js), leaves(ts)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-5,
                                       rtol=1e-5)
        tok = np.asarray(jl).argmax(-1)
    # the backend's surface is the same call, bit for bit
    bs = lm.init_decode_state(tcfg, 2, max_len=16)
    for slot, snap in enumerate(ts2):
        lm.restore_state(bs, snap, slot)
    tok = torch.tensor([3, 5])
    a, _ = be.decode_step(pt, bs, tok, 8)
    b, _ = tstep(pt, be.pad_decode_state(
        lm.prefill(pt, torch.from_numpy(prompt), tcfg)[1], max_len=16),
        tok, 8)
    assert torch.equal(a, b)


def test_runtime_exports_match_jax():
    """The runtime exports every name JAX's does (``plan_mesh_shape``,
    elastic re-meshing, included), beside the port's own
    ``InjectedFailure``."""
    import repro.runtime as jr
    import repro_torch.runtime as tr
    from repro_torch.runtime import StragglerDetector
    names = lambda m: {n for n in dir(m) if not n.startswith("_")
                       and n[0].isalpha() and callable(getattr(m, n))
                       and not isinstance(getattr(m, n), type(os))}
    assert names(jr) - names(tr) == set()
    # the exported detector is JAX's: the same step times, the same flags
    times = [1.0, 1.1, 0.9, 5.0, 1.0, 6.0, 7.0]
    flags = []
    for det in (jr.StragglerDetector(warmup_steps=1, patience=2),
                StragglerDetector(warmup_steps=1, patience=2)):
        flags.append([det.observe(i, t) for i, t in enumerate(times)])
    assert flags[0] == flags[1] and any(flags[1])
