"""Training driver (port of ``repro/launch/train.py``).

Builds the config, the AdamW optimizer (cosine warmup, weight decay 0.1,
global-norm clipping at 1.0), the train step, random parameters from
``--seed`` and the synthetic bigram stream, and runs them through the
fault-tolerant training loop: with ``--ckpt-dir`` it resumes from the
newest checkpoint there, saves asynchronously every ``--ckpt-every``
steps and blocking at the last, and SIGTERM makes it save at the next
step and stop. The flags are the JAX driver's, with ``--device`` and
``--n-layers`` on top (and ``--mesh smoke`` as a name for JAX's
``auto``). It trains
``--backend linear``, whose
attention core runs the B2 forward and B3 backward kernels on the card,
``--backend gated_linear`` (the paper's §4 decay form), whose core runs
B8 forward and B9 backward, and ``--backend softmax`` (the paper's §2
baseline), whose attention runs B10 forward with its log-sum-exp and
JAX's blockwise flash backward in plain PyTorch. The checkpoints are in
the JAX package's format (``checkpoint/manager.py``): either driver
resumes the other's.

``--mesh`` (JAX's flag) trains on a device mesh under a process group
that ``torchrun`` started: ``smoke`` (or ``auto``) is (data = world /
model, model = 1) over every rank, ``single`` and ``multi`` the
production meshes of 256 and 512 ranks. The parameters and AdamW moments
are DTensors placed by ``train_state_specs`` under the logical rules,
the batch is split on ``batch``, and each rank runs the kernels on its
own block. A checkpoint holds the whole arrays, written by rank 0, so
any mesh restores it. The group is gloo on the CPU, NCCL on CUDA with a
card per rank, and gloo with CUDA tensors when ranks share a card (NCCL
refuses two ranks on one device). ``--mesh none`` (the default) runs on
one device as before.

  python -m torch.distributed.run --nproc-per-node 4 \
      -m repro_torch.launch.train --smoke --device cpu --mesh smoke \
      --steps 5

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --backend linear --batch 8 --seq-len 1024 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --backend gated_linear --batch 8 --seq-len 1024 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --backend linear --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --backend gated_linear --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --backend softmax --batch 8 --seq-len 1024 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --backend softmax --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 12 --ckpt-every 4 --ckpt-dir build/ck --fail-at-step 8
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 12 --ckpt-every 4 --ckpt-dir build/ck    # resumes at 8

``--arch`` takes qwen3-0.6b, the dense configs yi-34b, internlm2-20b,
phi3-mini-3.8b and musicgen-large, the MoE configs (the router's
load-balance loss in the loss), rwkv6-1.6b and zamba2-7b; ``--n-layers``
cuts a model too large for one card to whole repeats of its layer
pattern (a tail after the repeats is dropped: zamba2-7b's units are 5
Mamba-2 blocks and one shared-attention site, ``--n-layers 48`` keeps 8
of its 13 units and none of its 3 tail blocks) and prints the cut. On
the card, the linear and gated backends' training kernels (B2/B3,
B8/B9) take head dims 16, 64, 96, 112 and 128, so phi3-mini-3.8b (96;
its fp32 master, gradients and two moments of 3.8 B parameters leave no
room for the activations at 32 layers: cut it), musicgen-large (64,
whole) and zamba2-7b (the shared attention's 112 under every backend,
its Mamba-2 blocks through B8/B9; 5.74 B parameters: cut it) train
there. rwkv6-1.6b (no attention layer: ``--backend`` does not apply)
trains whole: its time-mix runs B8's exclusive route forward and its
hand-written backward. The vision config's cross blocks need a memory
that the synthetic stream does not draw.

  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch deepseek-moe-16b --n-layers 2 --batch 8 --seq-len 1024 \\
      --steps 4
  PYTHONPATH=src python -m repro_torch.launch.train --arch musicgen-large \\
      --backend gated_linear --batch 8 --seq-len 1024 --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch phi3-mini-3.8b \\
      --n-layers 24 --backend linear --batch 8 --seq-len 1024 --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --smoke --device cpu --backend linear --steps 5
  PYTHONPATH=src python -m repro_torch.launch.train --arch zamba2-7b \\
      --n-layers 48 --backend gated_linear --batch 8 --seq-len 1024 \\
      --steps 6
  PYTHONPATH=src python -m repro_torch.launch.train --arch rwkv6-1.6b \\
      --batch 8 --seq-len 1024 --steps 6

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import signal
from typing import Optional, Sequence

import torch

from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.configs.base import depth_cut, with_depth
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.runtime import TrainLoop, TrainLoopConfig, make_train_step
from repro_torch.runtime.steps import train_state_specs
from repro_torch.sharding import Rules, distribute, distribute_tree


def base_config(args) -> ModelConfig:
    """The named config (or its smoke config) before any depth cut."""
    return get_smoke_config(args.arch) if args.smoke \
        else get_config(args.arch)


def config(args) -> ModelConfig:
    cfg = base_config(args)
    if args.n_layers:
        cfg = with_depth(cfg, args.n_layers)
    return cfg.with_backend(args.backend) if args.backend else cfg


def _mesh(args, device: torch.device):
    """The device mesh ``--mesh`` asks for over the process group
    (started here from torchrun's environment when it is not yet), and
    this rank's device."""
    import os
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_production_mesh, make_smoke_mesh
    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        world = int(os.environ.get("WORLD_SIZE", 1))
        shared = device.type == "cuda" and world > torch.cuda.device_count()
        dist.init_process_group(
            "nccl" if device.type == "cuda" and not shared else "gloo")
    if args.mesh in ("single", "multi"):
        mesh = make_production_mesh(multi_pod=args.mesh == "multi",
                                    device=device.type)
    else:
        mesh = make_smoke_mesh(device=device.type)
    return mesh, device


def build(args) -> TrainLoop:
    device = resolve_device(args.device)
    cfg = config(args)
    rules = Rules.null()
    if args.mesh != "none":
        mesh, device = _mesh(args, device)
        rules = Rules.for_mesh(mesh)
    optimizer = adamw(
        cosine_warmup(args.lr, warmup=args.warmup, total=args.steps),
        weight_decay=0.1)
    step = make_train_step(cfg, optimizer, n_micro=args.accum,
                           grad_compress=args.grad_compress, rules=rules)

    params = lm.init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    pspecs, _, bspecs = train_state_specs(cfg, rules)
    params = distribute_tree(params, pspecs, rules)
    opt_state = optimizer.init(params)     # moments placed as the params
    dataset = SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=args.seed)

    def put(batch):
        return {k: distribute(torch.from_numpy(v).to(device,
                                                     non_blocking=True),
                              rules, *bspecs[k])
                for k, v in batch.items()}

    loop = TrainLoop(
        step, params, opt_state, dataset,
        TrainLoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                        ckpt_dir=args.ckpt_dir,
                        fail_at_step=args.fail_at_step,
                        log_every=args.log_every),
        put_batch=put)
    loop.rules = rules
    signal.signal(signal.SIGTERM, lambda *_: loop.request_preemption())
    return loop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers, whole repeats"
                         " of its layer pattern (widths unchanged)")
    ap.add_argument("--backend", default=None,
                    choices=[None, "softmax", "linear", "gated_linear"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--mesh", default="none",
                    choices=["none", "auto", "smoke", "single", "multi"],
                    help="device mesh over the torchrun ranks (auto = "
                         "smoke: (data = world, model = 1))")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    args = parse_args(argv)
    loop = build(args)
    if args.mesh != "none":
        import torch.distributed as dist
        if dist.get_rank():                  # rank 0 reports
            loop.run()
            return 0
        print(f"mesh {dict(loop.rules.mesh_shape)} over "
              f"{dist.get_world_size()} ranks ({dist.get_backend()})")
    if args.n_layers:
        print(f"depth cut: {depth_cut(base_config(args), config(args))}")
    if loop.step:
        print(f"resumed from step {loop.step} ({args.ckpt_dir})")
    out = loop.run()
    if not out["metrics"]:
        print(f"final step {out['step']}: nothing left to run")
        return 0
    losses = [m["loss"] for m in out["metrics"]]
    print(f"final step {out['step']}  loss {losses[0]:.4f} -> "
          f"{losses[-1]:.4f}  stragglers={len(out['straggler_events'])}")
    # the first step includes the kernels' build and the library's warm-up
    times = [m["step_time"] for m in out["metrics"]][1:] or [
        out["metrics"][0]["step_time"]]
    ms = sum(times) / len(times) * 1e3
    print(f"{ms:.2f} ms/step  {args.batch * args.seq_len / ms * 1e3:.0f} "
          f"tokens/s  ({config(args).name}, "
          f"{lm.param_count(out['params'])} params, batch {args.batch} x "
          f"seq {args.seq_len})")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
