"""GPipe pipeline parallelism on point-to-point sends (port of
``repro/pipeline/gpipe.py``).

Mesh: (stage=S, data, model). Each stage is the (data, model) sub-mesh
of the ranks at one stage coordinate, where the layer code runs as it
does on any mesh (DTensors, ``constrain``, the kernels under
``local_map``); between stages this module moves the activations, one
rank to the rank at the same (data, model) coordinates of the next
stage, with ``batch_isend_irecv``: JAX's ``ppermute``.

Schedule (JAX's): M microbatches, S stages, M + S − 1 ticks. At tick t
stage s runs microbatch t − s when 0 ≤ t − s < M; stage 0 injects the
embedded microbatch t; the last stage computes the loss of the
microbatch it finishes; after every tick the activations move one stage
forward (the last stage's wrap to stage 0, whose buffer the next
injection replaces). Each stage body is rematerialised
(``torch.utils.checkpoint``), so a stage keeps one buffer per tick in
flight. A stage knows its coordinate, so an idle tick runs nothing and
passes its buffer on.

Parameters need no restructuring: the stacked leaves' leading (repeat)
dim is split over ``stage`` (R / S repeats a stage) and every other leaf
is replicated over it (``place_pipeline_params``); their other dims are
placed by the usual logical rules. Gradients come back on the same
placements: a leaf replicated over the stages gets the sum of the
stages' contributions.

The backward runs the sends in reverse: each tick's move is an autograd
function whose backward sends the gradient to the previous stage. Every
rank's loss depends on the last tick's buffer and the first buffer on
every parameter, so every rank runs every tick's backward, in the
reverse order, whichever leaves a caller asks gradients for, and the
sends pair up.
"""

from __future__ import annotations

from typing import Any, Dict

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import blocks as B
from repro_torch.models import lm
from repro_torch.sharding import (
    Rules, constrain, distribute, mixed_for, replicated_like)
from repro_torch.tree import leaves

Tensor = torch.Tensor


def make_pipeline_mesh(stages: int = 4, data: int = 4, model: int = 16, *,
                       device: str = "cuda"):
    """(stage, data, model): stages × data × model ranks."""
    return make_mesh((stages, data, model), ("stage", "data", "model"),
                     device=device)


def pipeline_compatible(cfg: ModelConfig, n_stages: int) -> bool:
    """Pipelining needs a homogeneous repeating unit divisible across the
    stages."""
    pattern, reps, tail = cfg.pattern_and_repeats
    return (not tail and "shared_attn" not in pattern
            and reps % n_stages == 0)


def _stage_rules(rules: Rules, mesh) -> Rules:
    """The rules on this rank's (data, model) sub-mesh."""
    sub = mesh["data", "model"]
    return Rules(table=rules.table, mesh_axes=("data", "model"),
                 mesh_shape={a: rules.axis_size(a)
                             for a in ("data", "model")}, mesh=sub)


def place_pipeline_params(params: Dict[str, Any], cfg: ModelConfig,
                          rules: Rules) -> Dict[str, Any]:
    """Whole parameters (the same on every rank) as DTensors on the
    pipeline mesh: the stacked leaves split over ``stage`` on their
    leading dim, the rest replicated over it; data and model as
    ``param_specs`` says (``rules`` made for the pipeline mesh)."""
    def place(x, names, stacked):
        return distribute(x, rules, *((("stage",) + names[1:]) if stacked
                                      else names))
    rules = Rules(table=dict(rules.table, stage="stage"),
                  mesh_axes=rules.mesh_axes, mesh_shape=rules.mesh_shape,
                  mesh=rules.mesh)
    specs = lm.param_specs(cfg)

    def walk(tree, spec, stacked):
        if isinstance(tree, dict):
            return {k: walk(tree[k], spec[k], stacked) for k in tree}
        if isinstance(tree, tuple):
            return tuple(walk(t, s, stacked) for t, s in zip(tree, spec))
        return place(tree, spec, stacked)
    return {k: walk(v, specs[k], k == "stack") for k, v in params.items()}


def _to_stage(x, sub, stacked: bool):
    """A leaf on the pipeline mesh as a DTensor on the stage's sub-mesh;
    a leaf replicated over the stages takes partial gradients over
    them."""
    from torch.distributed.tensor import DTensor, Partial
    pl = list(x.placements)
    shape = list(x.shape)
    if stacked:
        shape[0] //= x.device_mesh.size(0)
    local = x.to_local(grad_placements=pl if stacked
                       else [Partial()] + pl[1:])
    stride, acc = [], 1
    for n in reversed(shape):
        stride.insert(0, acc)
        acc *= n
    return DTensor.from_local(local, sub, pl[1:], run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


class _Shift(torch.autograd.Function):
    """Send x to ``nxt``, receive the previous stage's from ``prv``; the
    backward sends the gradient back the other way."""

    @staticmethod
    def forward(ctx, x, nxt: int, prv: int):
        ctx.nxt, ctx.prv = nxt, prv
        return _exchange(x.contiguous(), nxt, prv)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g.contiguous(), ctx.prv, ctx.nxt), None, None


def _exchange(x: Tensor, to: int, frm: int) -> Tensor:
    """Send x to rank ``to`` and receive a tensor like it from ``frm``.
    gloo has no point-to-point for CUDA tensors: under gloo a CUDA
    tensor goes through host memory. With one stage the move is to the
    rank itself."""
    if to == frm == dist.get_rank():
        return x.clone()
    staged = x.is_cuda and dist.get_backend() == "gloo"
    send = x.cpu() if staged else x
    out = torch.empty_like(send)
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, send, to),
                                   dist.P2POp(dist.irecv, out, frm)])
    for r in reqs:
        r.wait()
    return out.to(x.device) if staged else out


def gpipe_loss_fn(cfg: ModelConfig, rules: Rules, mesh, *, n_micro: int = 8,
                  attention_kernel: bool = True):
    """Build loss(params, batch) with a GPipe schedule over ``stage``.

    params: ``place_pipeline_params``' tree; batch: {"tokens": (B, T),
    "labels": (B, T)}, the same on every rank, B % n_micro == 0.
    Returns the mean token cross-entropy (``lm.lm_loss``'s, up to the
    association of the microbatch mean), the same on every rank;
    gradients flow to the parameters as the pipeline ran them.
    """
    from torch.distributed.tensor import DTensor
    n_stages = mesh.size(0)
    pattern, reps, tail = cfg.pattern_and_repeats
    if not pipeline_compatible(cfg, n_stages):
        raise ValueError(f"{cfg.name}: pattern {pattern}×{reps}+{tail} not "
                         f"divisible into {n_stages} pipeline stages")
    adt = lm.dtype_of(cfg.dtype)
    inner = _stage_rules(rules, mesh)
    sub = inner.mesh
    coord = mesh.get_coordinate()
    stage = coord[0]
    ranks = mesh.mesh
    nxt = int(ranks[(stage + 1) % n_stages, coord[1], coord[2]])
    prv = int(ranks[(stage - 1) % n_stages, coord[1], coord[2]])
    sp = ("batch", "seq_sp", "embed")

    def stage_body(x, stack, shared):
        for r in range(reps // n_stages):
            for pos, kind in enumerate(pattern):
                x, _, _ = B.block_apply(
                    kind, lm._at(stack[pos], r), x, cfg, shared=shared,
                    attention_kernel=attention_kernel, rules=inner)
                x = constrain(x, inner, *sp)
        return x

    def shift(x):
        local = _Shift.apply(x.to_local(), nxt, prv)
        return DTensor.from_local(local, sub, x.placements, run_check=False,
                                  shape=x.shape, stride=x.stride())

    def loss_fn(params, batch):
        tokens, labels = batch["tokens"], batch["labels"]
        b = tokens.shape[0]
        if b % n_micro:
            raise ValueError(f"batch {b} not divisible into {n_micro} "
                             f"microbatches")
        with mixed_for(params):
            p = {k: _walk(v, k == "stack") for k, v in params.items()}
            # every leaf in every rank's graph: a stage that does not use
            # one (the head on stage 0) still returns its zero gradient
            unused = sum(x.to_local().float().sum() for x in leaves(p))
            p = lm.cast_params(p, adt)
            tok_mb = tokens.reshape(n_micro, b // n_micro, -1)
            lab_mb = labels.reshape(n_micro, b // n_micro, -1)
            b_mb, t = tok_mb.shape[1:]
            # the first buffer depends on every parameter: each tick's
            # move is then on the way from the loss to the parameters on
            # every rank, idle or not, and runs its backward there
            buf = distribute(torch.zeros((b_mb, t, cfg.d_model), dtype=adt,
                                         device=tokens.device), inner, *sp)
            buf = buf + replicated_like((0 * unused).to(adt), buf)
            nll = None
            for tick in range(n_micro + n_stages - 1):
                here = tick - stage
                if stage == 0 and tick < n_micro:
                    inject = constrain(lm._embed(
                        p, distribute(tok_mb[tick], inner, "batch", None),
                        inner).to(adt), inner, *sp)
                    buf = inject + 0 * buf     # keeps buf's backward edge
                out = buf
                if 0 <= here < n_micro:
                    out = checkpoint(stage_body, buf, p["stack"],
                                     p.get("shared"), use_reentrant=False,
                                     preserve_rng_state=False)
                    if stage == n_stages - 1:
                        logits = lm._head(p, out, cfg, inner,
                                          "batch", "seq_sp", None)
                        term = lm.cross_entropy(logits, distribute(
                            lab_mb[here], inner, "batch", None)).full_tensor()
                        nll = term if nll is None else nll + term
                buf = shift(out)
            local = (torch.zeros((), device=tokens.device)
                     if nll is None else nll / n_micro)
            # every rank's loss reaches the last move: its backward runs
            # every tick's send
            local = local + 0 * buf.to_local().float().sum()
            total = local.detach().clone()
            dist.all_reduce(total, group=mesh.get_group("stage"))
            return local + (total - local.detach())

    def _walk(tree, stacked):
        if isinstance(tree, dict):
            return {k: _walk(v, stacked) for k, v in tree.items()}
        if isinstance(tree, tuple):
            return tuple(_walk(v, stacked) for v in tree)
        return _to_stage(tree, sub, stacked)

    return loss_fn
