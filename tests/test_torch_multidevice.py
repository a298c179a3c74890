"""The port's multi-device paths on four CPU ranks (gloo), against the
port on one device and, through it, the JAX package on the CPU.

One subprocess forks four ranks once for the whole module (a ``file://``
rendezvous under the test's temporary directory, one thread a rank); the
ranks run every check and rank 0 writes the results, while this process
computes JAX's references (jitted, null rules, smoke size, fp32). The
parametrised tests below then assert each result:

- ``lm_loss``, its gradients and one AdamW step on a (data 2, model 2)
  mesh (DTensor parameters, moments and batch; B2/B3's plain versions on
  each rank's heads) against the single-device step, and that step's
  loss and gradients against JAX's;
- ``decode_step`` logits on (2, 2) under linear, gated_linear and
  softmax, and on (1, 4) with 6 heads over 2 kv heads (linear: the state
  padded to 8 heads; softmax: the KV cache split on the head dim),
  against null rules and JAX's ``decode_step``;
- ``moe_apply_shard_map`` (JAX's test config: 8 experts, top 2,
  capacity factor 8) against the einsum path of the port and of JAX,
  gradients included;
- ``restore_on_mesh`` of a checkpoint written by JAX's ``save_pytree``
  onto (2, 2), (4, 1) and (1, 4), bit for bit, each rank's block too;
- GPipe over (stage 2, data 1, model 2) against the plain loss and
  gradients;
- ``launch/train.py --mesh smoke`` against ``--mesh none`` (losses), and
  its checkpoint (whole arrays, written by rank 0) resumed on the mesh;
- zamba2-7b (one unit of its smoke config: Mamba-2 blocks and the shared
  attention) and rwkv6-1.6b smoke under a model axis: ``decode_step``
  logits on (2, 2) and (1, 4), and ``lm_loss`` with its gradients on
  (2, 2), against null rules and JAX's ``decode_step`` / ``lm_loss``.

Tolerances: fp32 within 1e-5 relative for losses and normwise 1e-4
(max|Δ| over max|reference|) for gradients, parameters and logits;
restores bitwise.
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

from repro.checkpoint import save_pytree as jsave_pytree
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import lm as jlm
from repro.models import moe as jmoe
from repro.sharding import Rules as JRules
from repro_torch import convert
from repro_torch.configs import get_smoke_config

ROOT = Path(__file__).resolve().parents[1]
B, T, STEPS = 4, 8, 2
DECODE = [("linear", (2, 2), {}), ("gated_linear", (2, 2), {}),
          ("softmax", (2, 2), {}),
          ("linear", (1, 4), dict(n_heads=6, n_kv_heads=2)),
          ("softmax", (1, 4), dict(n_heads=6, n_kv_heads=2))]
DECODE_IDS = [f"{b}-{m[0]}x{m[1]}" + ("-6heads" if kw else "")
              for b, m, kw in DECODE]
RESTORE_MESHES = [(2, 2), (4, 1), (1, 4)]
SSM = ["zamba2-7b", "rwkv6-1.6b"]
SSM_MESHES = [(2, 2), (1, 4)]

_RANKS = r'''
import dataclasses, os, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def clone(tree):
    from repro_torch.tree import tree_map
    return tree_map(lambda x: x.detach().clone(), tree)


def grads_of(loss_fn, params):
    from repro_torch.tree import leaves
    flat = leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss = loss_fn(params)
    g = torch.autograd.grad(loss, flat)
    for p in flat:
        p.requires_grad_(False)
    return loss.detach(), g


def checks(rank, tmp):
    from repro_torch.checkpoint import restore_on_mesh
    from repro_torch.configs import get_smoke_config
    from repro_torch.launch import train as ttrain
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.moe import moe_apply, moe_param_specs
    from repro_torch.optim import adamw
    from repro_torch.pipeline import (
        gpipe_loss_fn, make_pipeline_mesh, place_pipeline_params)
    from repro_torch.sharding import (
        Rules, distribute, distribute_tree, full)
    from repro_torch.tree import leaves, tree_map

    import time
    path = os.path.join(tmp, "inputs.pt")
    while not os.path.exists(path):      # the test writes it meanwhile
        time.sleep(0.05)
    inp = torch.load(path, weights_only=False)
    out = {"seconds": {}}
    t0 = [time.perf_counter()]

    def mark(name):
        now = time.perf_counter()
        out["seconds"][name] = now - t0[0]
        t0[0] = now
    f32 = lambda c: dataclasses.replace(c, dtype="float32")  # noqa

    # -- train step on (2, 2) ---------------------------------------------
    cfg = f32(get_smoke_config("qwen3-0.6b").with_backend("linear"))
    params, batch = inp["lm_params"], inp["batch"]
    mesh = make_mesh((2, 2), ("data", "model"), device="cpu")
    rules = Rules.for_mesh(mesh)
    specs = lm.param_specs(cfg)
    loss1, g1 = grads_of(lambda p: lm.lm_loss(p, batch, cfg)[0],
                         clone(params))
    loss2, g2 = grads_of(lambda p: lm.lm_loss(p, batch, cfg, rules=rules)[0],
                         distribute_tree(clone(params), specs, rules))
    # one AdamW update from those gradients (the train step's update;
    # make_train_step itself runs on a mesh in the train --mesh check)
    opt = adamw(1e-3, weight_decay=0.1)
    it1, it2 = iter(g1), iter(g2)
    p1 = clone(params)
    p1, _ = opt.update(tree_map(lambda _: next(it1), p1), opt.init(p1), p1)
    p2 = distribute_tree(clone(params), specs, rules)
    s2 = opt.init(p2)
    p2, _ = opt.update(tree_map(lambda _: next(it2), p2), s2, p2)
    out["train"] = dict(
        loss1=loss1, loss2=full(loss2), g1=list(g1),
        g2=[full(g) for g in g2], p1=leaves(p1),
        p2=[full(p) for p in leaves(p2)],
        moments_placed=all(
            m.placements == p.placements
            for m, p in zip(leaves(s2.mu), leaves(p2))))

    mark("train")

    # -- decode ----------------------------------------------------------
    out["decode"] = []
    for (backend, shape, kw), dec in zip(inp["decode_cases"],
                                         inp["decode"]):
        dcfg = f32(dataclasses.replace(
            get_smoke_config("qwen3-0.6b").with_backend(backend), **kw))
        drules = rules if shape == (2, 2) else Rules.for_mesh(
            make_mesh(shape, ("data", "model"), device="cpu"))
        dp = distribute_tree(dec["params"], lm.param_specs(dcfg), drules)
        nb = dec["tokens"][0].shape[0]
        st0 = lm.init_decode_state(dcfg, nb, max_len=8)
        st1 = lm.init_decode_state(dcfg, nb, max_len=8, rules=drules)
        ref, got = [], []
        with torch.no_grad():
            for i, tok in enumerate(dec["tokens"]):
                pos = torch.tensor(i, dtype=torch.int32)
                a, st0 = lm.decode_step(dec["params"], st0, tok, pos, dcfg)
                b, st1 = lm.decode_step(dp, st1, tok, pos, dcfg,
                                        rules=drules)
                ref.append(a)
                got.append(full(b))
        heads = [tuple(x.shape) for x in st1["stack"][0] if x is not None]
        out["decode"].append(dict(ref=ref, got=got, state_shapes=heads))

    mark("decode")

    # -- MoE expert parallelism on (2, 2) -------------------------------
    mcfg = inp["moe_cfg"]
    mp_, x = inp["moe_params"], inp["moe_x"]
    pd = distribute_tree(clone(mp_), moe_param_specs(mcfg), rules)
    for a in leaves(pd):
        a.requires_grad_(True)
    xd = distribute(x.clone(), rules, "batch", "seq_sp", None
                    ).requires_grad_(True)
    o2, aux2 = moe_apply(pd, xd, mcfg, rules=rules)
    wd = distribute(inp["moe_w"], rules, "batch", "seq_sp", None)
    (o2 * wd).sum().add(aux2).backward()
    pe = clone(mp_)
    for a in leaves(pe):
        a.requires_grad_(True)
    xe = x.clone().requires_grad_(True)
    ecfg = dataclasses.replace(mcfg, moe=dataclasses.replace(
        mcfg.moe, dispatch="einsum"))
    o1, aux1 = moe_apply(pe, xe, ecfg)
    (o1 * inp["moe_w"]).sum().add(aux1).backward()
    out["moe"] = dict(
        o1=o1.detach(), o2=full(o2).detach(), aux1=aux1.detach(),
        aux2=full(aux2).detach(), g1=[a.grad for a in leaves(pe)] + [xe.grad],
        g2=[full(a.grad) for a in leaves(pd)] + [full(xd.grad)])

    mark("moe")

    # -- restore a JAX checkpoint on three meshes ------------------------
    out["restore"] = []
    like = inp["ckpt_like"]
    for shape in inp["restore_meshes"]:
        rmesh = mesh if shape == (2, 2) else make_mesh(
            shape, ("data", "model"), device="cpu")
        rrules = Rules.for_mesh(rmesh)
        tree, _ = restore_on_mesh(inp["ckpt"], like, inp["ckpt_specs"],
                                  rmesh)
        whole = all(torch.equal(full(tree[k]), like[k]) for k in like)
        # this rank's block is the block of the whole array its placements
        # name (distribute keeps exactly that block)
        block = all(torch.equal(
            tree[k].to_local(),
            distribute(like[k], rrules, *inp["ckpt_specs"][k]).to_local())
            for k in like)
        flags = torch.tensor([whole, block], dtype=torch.int32)
        dist.all_reduce(flags, op=dist.ReduceOp.MIN)
        out["restore"].append(dict(
            whole=bool(flags[0]), block=bool(flags[1]),
            placements={k: tuple(str(p) for p in tree[k].placements)
                        for k in tree}))

    mark("restore")

    # -- GPipe over (stage 2, data 1, model 2) -------------------------
    pmesh = make_pipeline_mesh(stages=2, data=1, model=2, device="cpu")
    prules = Rules.for_mesh(pmesh)
    pp = place_pipeline_params(clone(params), cfg, prules)
    loss_fn = gpipe_loss_fn(cfg, prules, pmesh, n_micro=2)
    lossp, gp = grads_of(lambda p: loss_fn(p, batch), pp)
    out["gpipe"] = dict(loss=lossp, g=[full(g) for g in gp])

    mark("gpipe")

    # -- launch/train.py --mesh smoke, its checkpoint resumed ------------
    ck = os.path.join(tmp, "train_ck")
    argv = ["--smoke", "--device", "cpu", "--steps", str(inp["steps"]),
            "--batch", "4", "--seq-len", "8", "--log-every", "100"]
    loop = ttrain.build(ttrain.parse_args(argv + ["--mesh", "smoke",
                                                  "--ckpt-dir", ck]))
    meshed = loop.run()
    plain = ttrain.build(ttrain.parse_args(argv)).run()
    again = ttrain.build(ttrain.parse_args(argv + ["--mesh", "smoke",
                                                   "--ckpt-dir", ck]))
    out["train_cli"] = dict(
        mesh=[m["loss"] for m in meshed["metrics"]],
        none=[m["loss"] for m in plain["metrics"]],
        resumed_step=again.step,
        resumed_equal=all(torch.equal(full(a), full(b)) for a, b in zip(
            leaves(again.params), leaves(meshed["params"]))),
        mesh_shape=dict(loop.rules.mesh_shape))
    mark("train_cli")

    # -- Mamba-2 and RWKV-6 under a model axis ----------------------------
    out["ssm"] = []
    for case in inp["ssm"]:
        scfg, sp, res = case["cfg"], case["params"], {}
        for shape in inp["ssm_meshes"]:
            srules = rules if shape == (2, 2) else Rules.for_mesh(
                make_mesh(shape, ("data", "model"), device="cpu"))
            dp = distribute_tree(clone(sp), lm.param_specs(scfg), srules)
            nb = case["tokens"][0].shape[0]
            st0 = lm.init_decode_state(scfg, nb, max_len=8)
            st1 = lm.init_decode_state(scfg, nb, max_len=8, rules=srules)
            ref, got = [], []
            with torch.no_grad():
                for i, tok in enumerate(case["tokens"]):
                    pos = torch.tensor(i, dtype=torch.int32)
                    a, st0 = lm.decode_step(sp, st0, tok, pos, scfg)
                    b, st1 = lm.decode_step(dp, st1, tok, pos, scfg,
                                            rules=srules)
                    ref.append(a)
                    got.append(full(b))
            res[shape] = dict(ref=ref, got=got)
        loss1, g1 = grads_of(lambda p: lm.lm_loss(p, case["batch"], scfg)[0],
                             clone(sp))
        loss2, g2 = grads_of(
            lambda p: lm.lm_loss(p, case["batch"], scfg, rules=rules)[0],
            distribute_tree(clone(sp), lm.param_specs(scfg), rules))
        res["train"] = dict(loss1=loss1, loss2=full(loss2), g1=list(g1),
                            g2=[full(g) for g in g2])
        out["ssm"].append(res)
    mark("ssm")
    return out


def rank_main(rank, world, tmp):
    import faulthandler
    # a rank that waits on a collective forever prints where, and exits
    # (once, after the whole run's time)
    faulthandler.dump_traceback_later(540, exit=True)
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=rank, world_size=world)
    try:
        out = checks(rank, tmp)
        if rank == 0:
            torch.save(out, os.path.join(tmp, "out.pt"))
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    mp.start_processes(rank_main, args=(4, sys.argv[1]), nprocs=4,
                       start_method="fork")
'''


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, tol=1e-4):
    """max|Δ| over max|want| (normwise), 0-size safe."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(float(np.abs(want).max(initial=0.0)), 1e-30)
    return float(np.abs(got - want).max(initial=0.0)) / scale <= tol


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """Start the four ranks, compute JAX's references meanwhile, and
    return (ranks' results, JAX's)."""
    tmp = tmp_path_factory.mktemp("multidevice")
    # the ranks start first and wait for their inputs, written below
    (tmp / "ranks.py").write_text(_RANKS)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    proc = subprocess.Popen([sys.executable, str(tmp / "ranks.py"),
                             str(tmp)], env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    jcfg = dataclasses.replace(
        jax_smoke_config("qwen3-0.6b").with_backend("linear"),
        dtype="float32")
    tcfg = dataclasses.replace(
        get_smoke_config("qwen3-0.6b").with_backend("linear"),
        dtype="float32")
    rng = np.random.default_rng(0)
    jp = _np(jlm.init_params(jax.random.PRNGKey(0), jcfg))
    tokens = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    labels = rng.integers(0, jcfg.vocab_size, (B, T)).astype(np.int32)
    inputs = {
        "lm_params": convert.params_from_jax(jp, tcfg, device="cpu"),
        "batch": {"tokens": torch.from_numpy(tokens).long(),
                  "labels": torch.from_numpy(labels).long()},
        "steps": STEPS, "restore_meshes": RESTORE_MESHES,
        "decode_cases": DECODE, "decode": []}
    jdec = []
    for i, (backend, _, kw) in enumerate(DECODE):
        jc = dataclasses.replace(
            jax_smoke_config("qwen3-0.6b").with_backend(backend),
            dtype="float32", **kw)
        tc = dataclasses.replace(
            get_smoke_config("qwen3-0.6b").with_backend(backend),
            dtype="float32", **kw)
        p = _np(jlm.init_params(jax.random.PRNGKey(10 + i), jc))
        toks = rng.integers(0, jc.vocab_size, (2, B)).astype(np.int32)
        inputs["decode"].append(dict(
            params=convert.params_from_jax(p, tc, device="cpu"),
            tokens=[torch.from_numpy(t).long() for t in toks]))
        jdec.append((jc, p, toks))
    # MoE at JAX's tests/test_multidevice.py config
    mj = jax_smoke_config("deepseek-moe-16b")
    mj = dataclasses.replace(mj, moe=dataclasses.replace(
        mj.moe, capacity_factor=8.0, n_experts=8, top_k=2))
    mt = get_smoke_config("deepseek-moe-16b")
    mt = dataclasses.replace(mt, moe=dataclasses.replace(
        mt.moe, capacity_factor=8.0, n_experts=8, top_k=2))
    mpj = _np(jmoe.moe_params(jax.random.PRNGKey(0), mj, jnp.float32))
    mx = rng.standard_normal((4, 8, mj.d_model)).astype(np.float32)
    mw = rng.standard_normal((4, 8, mj.d_model)).astype(np.float32)
    inputs.update(moe_cfg=mt, moe_params=convert._tree(mpj, "cpu"),
                  moe_x=torch.from_numpy(mx), moe_w=torch.from_numpy(mw))
    # a checkpoint written by JAX's save_pytree
    ck = {"w": rng.standard_normal((16, 8)).astype(np.float32),
          "emb": rng.standard_normal((32, 8)).astype(np.float32)}
    jsave_pytree(str(tmp / "jax_ck"), {k: jnp.asarray(v)
                                        for k, v in ck.items()})
    inputs.update(ckpt=str(tmp / "jax_ck"),
                  ckpt_like={k: torch.from_numpy(v) for k, v in ck.items()},
                  ckpt_specs={"w": ("fsdp", "ffn"), "emb": ("vocab", None)})
    # zamba2-7b's smoke config cut to one unit (its tail dropped) and
    # rwkv6-1.6b's, for the Mamba-2 / RWKV-6 blocks under a model axis
    inputs.update(ssm=[], ssm_meshes=SSM_MESHES)
    jssm = []
    for i, arch in enumerate(SSM):
        jc = dataclasses.replace(jax_smoke_config(arch), dtype="float32")
        tc = dataclasses.replace(get_smoke_config(arch), dtype="float32")
        if arch == "zamba2-7b":
            jc = dataclasses.replace(jc, n_layers=3, n_repeats=1, tail=())
            tc = dataclasses.replace(tc, n_layers=3, n_repeats=1, tail=())
        p = _np(jlm.init_params(jax.random.PRNGKey(20 + i), jc))
        toks = rng.integers(0, jc.vocab_size, (2, B)).astype(np.int32)
        st = rng.integers(0, jc.vocab_size, (2, B, T)).astype(np.int32)
        inputs["ssm"].append(dict(
            cfg=tc, params=convert.params_from_jax(p, tc, device="cpu"),
            tokens=[torch.from_numpy(t).long() for t in toks],
            batch={"tokens": torch.from_numpy(st[0]).long(),
                   "labels": torch.from_numpy(st[1]).long()}))
        jssm.append((jc, p, toks, st))
    torch.save(inputs, tmp / "inputs.tmp")
    os.replace(tmp / "inputs.tmp", tmp / "inputs.pt")

    # JAX's references while the ranks run
    jbatch = {"tokens": jnp.asarray(tokens), "labels": jnp.asarray(labels)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jlm.lm_loss(p, jbatch, jcfg, JRules.null())[0]))(
            jax.tree.map(jnp.asarray, jp))
    refs = {"loss": float(jloss),
            "grads": [np.asarray(g) for g in jax.tree.leaves(jgrads)],
            "decode": []}
    for jc, p, toks in jdec:
        st = jlm.init_decode_state(jc, B, 8)
        step = jax.jit(lambda p_, s, t, i, jc=jc: jlm.decode_step(
            p_, s, t, i, jc, JRules.null()))
        logits = []
        for i, t in enumerate(toks):
            lg, st = step(jax.tree.map(jnp.asarray, p), st, jnp.asarray(t),
                          jnp.int32(i))
            logits.append(np.asarray(lg))
        refs["decode"].append(logits)
    me = dataclasses.replace(mj, moe=dataclasses.replace(
        mj.moe, dispatch="einsum"))
    mo, maux = jax.jit(lambda p, x: jmoe.moe_apply(p, x, me, JRules.null()))(
        jax.tree.map(jnp.asarray, mpj), jnp.asarray(mx))
    refs["moe"] = (np.asarray(mo), float(maux))

    refs["ssm"] = []
    for jc, p, toks, st in jssm:
        jp_ = jax.tree.map(jnp.asarray, p)
        state = jlm.init_decode_state(jc, B, 8)
        step = jax.jit(lambda p_, s, t, i, jc=jc: jlm.decode_step(
            p_, s, t, i, jc, JRules.null()))
        logits = []
        for i, t in enumerate(toks):
            lg, state = step(jp_, state, jnp.asarray(t), jnp.int32(i))
            logits.append(np.asarray(lg))
        sb = {"tokens": jnp.asarray(st[0]), "labels": jnp.asarray(st[1])}
        sl, sg = jax.jit(jax.value_and_grad(
            lambda p_, jc=jc, sb=sb: jlm.lm_loss(p_, sb, jc,
                                                 JRules.null())[0]))(jp_)
        refs["ssm"].append(dict(
            decode=logits, loss=float(sl),
            grads=[np.asarray(g) for g in jax.tree.leaves(sg)]))

    log, _ = proc.communicate(timeout=600)
    assert proc.returncode == 0, log[-4000:]
    return torch.load(tmp / "out.pt", weights_only=False), refs


# -- train step ---------------------------------------------------------------

def test_sharded_loss_and_grads_match_single_device(run):
    out, _ = run
    tr = out["train"]
    assert abs(float(tr["loss2"]) - float(tr["loss1"])) <= \
        1e-5 * abs(float(tr["loss1"]))
    for a, b in zip(tr["g2"], tr["g1"]):
        assert _close(a, b)


def test_single_device_step_matches_jax(run):
    out, refs = run
    tr = out["train"]
    assert abs(float(tr["loss1"]) - refs["loss"]) <= 1e-5 * abs(refs["loss"])
    assert len(tr["g1"]) == len(refs["grads"])
    for a, b in zip(tr["g1"], refs["grads"]):
        assert _close(a, b)


def test_sharded_adamw_step_matches_single_device(run):
    out, _ = run
    tr = out["train"]
    assert tr["moments_placed"]
    for a, b in zip(tr["p2"], tr["p1"]):
        assert _close(a, b)


# -- decode ---------------------------------------------------------------------

@pytest.mark.parametrize("case", range(len(DECODE)), ids=DECODE_IDS)
def test_sharded_decode_matches_null_rules_and_jax(run, case):
    out, refs = run
    dec = out["decode"][case]
    for got, ref, want in zip(dec["got"], dec["ref"], refs["decode"][case]):
        assert _close(got, ref, 1e-5)
        assert _close(ref, want)
    backend, shape, kw = DECODE[case]
    if backend == "linear" and kw:
        # 6 heads padded to 8 on a model axis of 4 (JAX's padded_head_count)
        assert dec["state_shapes"][0][2] == 8


# -- MoE ----------------------------------------------------------------------

def test_moe_shard_map_matches_einsum(run):
    out, refs = run
    mo = out["moe"]
    assert _close(mo["o2"], mo["o1"], 1e-5)
    assert abs(float(mo["aux2"]) - float(mo["aux1"])) <= 1e-6
    for a, b in zip(mo["g2"], mo["g1"]):
        assert _close(a, b)
    assert _close(mo["o1"], refs["moe"][0], 1e-5)
    assert abs(float(mo["aux1"]) - refs["moe"][1]) <= 1e-6


# -- elastic restore -----------------------------------------------------------

@pytest.mark.parametrize("i", range(len(RESTORE_MESHES)),
                         ids=[f"{a}x{b}" for a, b in RESTORE_MESHES])
def test_restore_on_mesh_of_jax_checkpoint_is_bitwise(run, i):
    out, _ = run
    r = out["restore"][i]
    assert r["whole"] and r["block"]
    # JAX's spec keeps a mesh axis of size 1 (P("data", "model") on
    # (4, 1)); so do the placements
    assert r["placements"] == {"w": ("S(0)", "S(1)"), "emb": ("R", "S(0)")}


# -- GPipe ----------------------------------------------------------------------

def test_gpipe_matches_plain_loss_and_grads(run):
    out, _ = run
    tr, gp = out["train"], out["gpipe"]
    assert abs(float(gp["loss"]) - float(tr["loss1"])) <= \
        1e-5 * abs(float(tr["loss1"]))
    for a, b in zip(gp["g"], tr["g1"]):
        assert _close(a, b)


# -- train --mesh ----------------------------------------------------------------

def test_train_mesh_smoke_gives_mesh_none_losses(run):
    out, _ = run
    t = out["train_cli"]
    assert t["mesh_shape"] == {"data": 4, "model": 1}
    assert len(t["mesh"]) == len(t["none"]) == STEPS
    np.testing.assert_allclose(t["mesh"], t["none"], rtol=1e-4)


def test_train_mesh_checkpoint_resumes_on_mesh(run):
    out, _ = run
    t = out["train_cli"]
    assert t["resumed_step"] == STEPS
    assert t["resumed_equal"]


def test_ranks_ran_every_check(run):
    """Every check ran in the ranks, in order; their seconds (DTensor's
    first sharding propagation of each op dominates) go to the log."""
    out, _ = run
    assert list(out["seconds"]) == ["train", "decode", "moe", "restore",
                                    "gpipe", "train_cli", "ssm"]
    print({k: round(v, 1) for k, v in out["seconds"].items()})


# -- Mamba-2 and RWKV-6 under a model axis ------------------------------------

@pytest.mark.parametrize("mesh", SSM_MESHES,
                         ids=[f"{a}x{b}" for a, b in SSM_MESHES])
@pytest.mark.parametrize("case", range(len(SSM)), ids=SSM)
def test_ssm_decode_under_model_axis_matches_null_rules_and_jax(run, case,
                                                               mesh):
    out, refs = run
    dec = out["ssm"][case][mesh]
    for got, ref, want in zip(dec["got"], dec["ref"],
                              refs["ssm"][case]["decode"]):
        assert _close(got, ref, 1e-5)
        assert _close(ref, want)


@pytest.mark.parametrize("case", range(len(SSM)), ids=SSM)
def test_ssm_loss_and_grads_under_model_axis_match_null_rules_and_jax(run,
                                                                     case):
    out, refs = run
    tr, want = out["ssm"][case]["train"], refs["ssm"][case]
    assert abs(float(tr["loss2"]) - float(tr["loss1"])) <= \
        1e-5 * abs(float(tr["loss1"]))
    assert abs(float(tr["loss1"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert len(tr["g1"]) == len(want["grads"])
    for a, b, c in zip(tr["g2"], tr["g1"], want["grads"]):
        assert _close(a, b)
        assert _close(b, c)
