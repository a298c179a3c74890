"""Multi-pod dry run: trace every (arch × shape × mesh) cell on fake
tensors (port of ``repro/launch/dryrun.py``).

JAX lowers and compiles each cell for 256 or 512 fake devices. The port
runs rank 0's program once, eagerly, with no card and nothing
allocated:

  1. a fake process group (``torch.testing``'s ``FakeStore`` and the
     "fake" backend: collectives return at once) of 256 ranks for the
     single-pod mesh (data 16, model 16) and the pipeline mesh (stage 4,
     data 4, model 16), 512 for the multi-pod mesh (pod 2, data 16,
     model 16);
  2. JAX's logical rules resolved into DTensor placements for the
     parameters, optimizer moments, inputs and decode state
     (``sharding.distribute_tree``), all of them ``FakeTensor``s made
     by ``launch/specs.py`` on the run's device ("cuda" unless asked: a
     fake CUDA tensor needs no card);
  3. the step (``runtime.steps.make_train_step`` with AdamW, ``lm.prefill``
     or the serving profile's ``lm.decode_step``) run once under
     ``FakeTensorMode`` inside ``launch/hlo.py``'s ``analyze_step``:
     the per-device program JAX compiles, traced op by op. The kernel
     wrappers take their fake route (shapes and work, no launch);
  4. the dot FLOPs, bytes, collectives, memory and roofline recorded in
     ``build/artifacts/<arch>__<shape>__<mesh>[__<backend>].json``.

Usage:
  python -m repro_torch.launch.dryrun --arch yi-34b --shape train_4k --mesh single
  python -m repro_torch.launch.dryrun --all --mesh both
  python -m repro_torch.launch.dryrun --arch yi-34b --shape long_500k \\
      --backend linear       # the paper's backend override

``--cell ARCH:SHAPE[:MESH[:BACKEND]]`` (repeatable) runs a list of cells
in one process, in order. ``--device cpu`` traces on fake CPU tensors
(where the build has no CUDA, Python indexing of a fake CUDA tensor
fails); the kernel wrappers take the same fake route on either.
``run_cell``'s ``n_layers`` cuts the depth to whole repeats of the
layer pattern (``configs.base.with_depth``).
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs import SHAPES, get_config, list_architectures
from repro_torch.configs.base import ModelConfig, ShapeConfig, with_depth
from repro_torch.launch import specs as S
from repro_torch.launch.hlo import StepAnalysis, analyze_step
from repro_torch.launch.roofline import RooflineTerms

ARTIFACT_DIR = Path(__file__).resolve().parents[3] / "build" / "artifacts"
WORLD = {"single": 256, "multi": 512, "pipeline": 256}


def init_world(n: int) -> None:
    """A fake process group of ``n`` ranks, this process rank 0 (an
    existing one of another size is replaced)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n)


def make_mesh(mesh_kind: str, device: str = "cuda"):
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.pipeline import make_pipeline_mesh
    init_world(WORLD[mesh_kind])
    if mesh_kind == "pipeline":
        return make_pipeline_mesh(stages=4, data=4, model=16, device=device)
    return make_production_mesh(multi_pod=mesh_kind == "multi",
                                device=device)


def _fake_mode():
    from torch._subclasses.fake_tensor import FakeTensorMode
    return FakeTensorMode(allow_non_fake_inputs=True)


def trace_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               device: str = "cuda") -> StepAnalysis:
    """Rank 0's step for one cell, traced once on fake tensors."""
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step, train_state_specs
    from repro_torch.sharding import Rules, distribute_tree
    rules = Rules.for_mesh(mesh)
    with _fake_mode():
        if shape.kind == "train":
            optimizer = adamw(1e-4)
            params = S.abstract_params(cfg, device=device)
            opt = optimizer.init(params)
            batch = S.input_specs(cfg, shape, device=device)
            pspecs, ospecs, bspecs = train_state_specs(cfg, rules)
            params = distribute_tree(params, pspecs, rules)
            opt = distribute_tree(opt, ospecs, rules)
            batch = distribute_tree(batch, bspecs, rules)
            step = make_train_step(cfg, optimizer, rules=rules)
            return analyze_step(step, params, opt, batch)[1]
        if shape.kind == "prefill":
            params = distribute_tree(S.abstract_params(cfg, device=device),
                                     lm.param_specs(cfg), rules)
            inputs = S.input_specs(cfg, shape, device=device)

            @torch.no_grad()
            def prefill_step(params, tokens, memory=None):
                return lm.prefill(params, tokens, cfg, memory=memory,
                                  rules=rules)
            return analyze_step(prefill_step, params, inputs["tokens"],
                                inputs.get("memory"))[1]
        # decode — the serving profile: weights replicated over the data
        # axes (an fsdp layout would gather every weight on every token)
        # and held in bf16 (the fp32 master stays with the trainer)
        rules = Rules.for_mesh(mesh, overrides={"fsdp": None})
        params = distribute_tree(
            S.abstract_params_serving(cfg, device=device),
            lm.param_specs(cfg), rules)
        inputs = S.input_specs(cfg, shape, rules, device=device)

        @torch.no_grad()
        def serve_step(params, state, token, pos):
            return lm.decode_step(params, state, token, pos, cfg,
                                  rules=rules)
        return analyze_step(serve_step, params, inputs["state"],
                            inputs["token"], inputs["pos"])[1]


def trace_pipeline_cell(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                        device: str = "cuda") -> StepAnalysis:
    """The PP train step: GPipe loss + gradients + AdamW on the (stage,
    data, model) mesh, 8 microbatches, the stacked layers split over
    ``stage``; rank 0 is stage 0."""
    from repro_torch.optim import adamw
    from repro_torch.pipeline import gpipe_loss_fn, place_pipeline_params
    from repro_torch.sharding import Rules
    from repro_torch.tree import leaves, tree_map
    rules = Rules.for_mesh(mesh)
    optimizer = adamw(1e-4)
    # built outside the fake mode: it reads the mesh's rank table
    loss_fn = gpipe_loss_fn(cfg, rules, mesh, n_micro=8)
    with _fake_mode():
        params = place_pipeline_params(S.abstract_params(cfg, device=device),
                                       cfg, rules)
        opt = optimizer.init(params)
        batch = S.input_specs(cfg, shape, device=device)

        def step(params, opt_state, batch):
            flat = leaves(params)
            for p in flat:
                p.requires_grad_(True)
            loss = loss_fn(params, batch)
            grads = iter(torch.autograd.grad(loss, flat))
            for p in flat:
                p.requires_grad_(False)
            params, opt_state = optimizer.update(
                tree_map(lambda _: next(grads), params), opt_state, params)
            return params, opt_state, loss.detach()
        return analyze_step(step, params, opt, batch)[1]


def _skip(arch, shape_name, mesh_kind, cfg, reason) -> Dict:
    return {"arch": arch, "shape": shape_name, "mesh": mesh_kind,
            "backend": cfg.attention_backend, "status": "skipped",
            "reason": reason}


def _save(result: Dict, arch, shape_name, mesh_kind, backend) -> None:
    ARTIFACT_DIR.mkdir(parents=True, exist_ok=True)
    suffix = f"__{backend}" if backend else ""
    path = ARTIFACT_DIR / f"{arch}__{shape_name}__{mesh_kind}{suffix}.json"
    path.write_text(json.dumps(result, indent=1))


def run_cell(
    arch: str,
    shape_name: str,
    mesh_kind: str,
    backend: Optional[str] = None,
    save: bool = True,
    *,
    device: str = "cuda",
    n_layers: Optional[int] = None,
) -> Dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    if backend:
        cfg = cfg.with_backend(backend)
    if n_layers:
        cfg = with_depth(cfg, n_layers)

    # long_500k is decode-only with sub-quadratic state: pure softmax
    # attention is skipped per the assignment (the linear backends run it).
    if (shape.kind == "decode" and shape.seq_len > 100_000
            and cfg.attention_backend == "softmax" and cfg.uses_attention):
        result = _skip(arch, shape_name, mesh_kind, cfg,
                       "pure softmax attention at 500k context (quadratic "
                       "state) — run with --backend linear")
        if save:
            _save(result, arch, shape_name, mesh_kind, None)
        return result

    if mesh_kind == "pipeline":
        from repro_torch.pipeline import pipeline_compatible
        if not pipeline_compatible(cfg, 4) or shape.kind != "train":
            return _skip(arch, shape_name, mesh_kind, cfg,
                         "PP needs a homogeneous divisible layer pattern "
                         "and a train shape")
    t0 = time.time()
    result: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_kind,
        "backend": cfg.attention_backend, "n_devices": WORLD[mesh_kind],
        "n_layers": cfg.n_layers,
    }
    try:
        mesh = make_mesh(mesh_kind, device)
        an = (trace_pipeline_cell(cfg, shape, mesh, device=device)
              if mesh_kind == "pipeline"
              else trace_cell(cfg, shape, mesh, device=device))
        result.update({
            "status": "ok",
            "t_trace_s": round(time.time() - t0, 2),
            "flops_per_device": an.flops,
            "dot_flops_per_device": an.dot_flops,
            "kernel_flops_per_device": an.kernel_flops,
            "hbm_bytes_per_device": an.bytes,
            "kernel_bytes_per_device": an.kernel_bytes,
            "kernels": an.kernel_counts(),
            "memory": {
                "argument_bytes": an.argument_bytes,
                "output_bytes": an.output_bytes,
                "temp_bytes": an.temp_bytes,
                "alias_bytes": an.alias_bytes,
                "peak_bytes_per_device": an.peak_bytes,
            },
            "collectives": {
                "count": an.collective_count(),
                "wire_bytes": an.collective_wire_bytes,
                "payload_bytes": an.collective_payload_bytes,
                "by_kind": an.collective_by_kind(),
            },
            "model_flops": S.model_flops(cfg, shape),
        })
        terms = RooflineTerms(
            flops_per_device=an.flops,
            hbm_bytes_per_device=an.bytes,
            wire_bytes_per_device=an.collective_wire_bytes,
            n_devices=WORLD[mesh_kind],
            model_flops_global=result["model_flops"],
            score_bytes_per_device=an.score_bytes,
        )
        result["roofline"] = terms.as_dict()
    except Exception as e:  # a failure here is a bug in the system
        result.update({
            "status": "failed",
            "error": f"{type(e).__name__}: {e}",
            "traceback": traceback.format_exc()[-4000:],
        })
    if torch.cuda.is_available() and torch.cuda.memory_allocated():
        raise AssertionError(f"the dry run allocated "
                             f"{torch.cuda.memory_allocated()} B on the card")
    if save:
        _save(result, arch, shape_name, mesh_kind, backend)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", help="architecture id (see --list)")
    ap.add_argument("--shape", help="shape id", choices=list(SHAPES))
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both", "pipeline"])
    ap.add_argument("--backend", default=None,
                    choices=[None, "softmax", "linear", "gated_linear"])
    ap.add_argument("--all", action="store_true",
                    help="run every (arch × shape) cell")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="the fake tensors' device (no card either way)")
    ap.add_argument("--cell", action="append", default=[],
                    metavar="ARCH:SHAPE[:MESH[:BACKEND]]",
                    help="a cell to run (repeatable), in order")
    args = ap.parse_args(argv)
    _settle_card()

    if args.list:
        print("\n".join(list_architectures()))
        return 0

    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    cells = []
    if args.all:
        for arch in list_architectures():
            for shape in SHAPES:
                cells.extend((arch, shape, m, args.backend) for m in meshes)
    elif args.cell:
        for cell in args.cell:
            arch, shape, *rest = cell.split(":")
            cells.append((arch, shape, rest[0] if rest else args.mesh,
                          rest[1] if len(rest) > 1 else args.backend))
    else:
        if not args.arch or not args.shape:
            ap.error("--arch and --shape required (or --all, or --cell)")
        cells.extend((args.arch, args.shape, m, args.backend)
                     for m in meshes)

    n_fail = 0
    for arch, shape, mesh_kind, backend in cells:
        r = run_cell(arch, shape, mesh_kind, backend=backend,
                     device=args.device)
        status = r["status"]
        extra = ""
        if status == "ok":
            rl = r["roofline"]
            extra = (f"bottleneck={rl['bottleneck']} "
                     f"t_bound={rl['t_bound_s']:.4f}s "
                     f"mem/dev={r['memory']['peak_bytes_per_device']/2**30:.2f}GiB "
                     f"trace={r['t_trace_s']:.1f}s")
        elif status == "failed":
            n_fail += 1
            extra = r["error"][:200]
        print(f"[{status:7s}] {arch:24s} {shape:12s} {mesh_kind:6s} "
              f"{extra}", flush=True)
    if torch.cuda.is_available():
        # nothing is held on the card after any cell (``run_cell`` raises
        # otherwise); the peak counts FakeTensorMode's own context touch
        print(f"device bytes allocated: peak "
              f"{torch.cuda.max_memory_allocated()}", flush=True)
    return 1 if n_fail else 0


def _settle_card() -> None:
    """On a machine with a card: ``FakeTensorMode`` makes (and frees) a
    4-byte CUDA tensor when it first fakes a CUDA tensor, to start the
    device's context; make that happen first and start the peak count
    after it."""
    if torch.cuda.is_available():
        with _fake_mode():
            for dev in ("cuda", f"cuda:{torch.cuda.current_device()}"):
                torch.empty(1, device=dev)
        torch.cuda.reset_peak_memory_stats()


if __name__ == "__main__":
    sys.exit(main())
