"""Training driver (port of ``repro/launch/train.py``).

Builds the config, the AdamW optimizer (cosine warmup, weight decay 0.1,
global-norm clipping at 1.0), the train step, random parameters from
``--seed`` and the synthetic bigram stream, and runs them through the
training loop with straggler telemetry; SIGTERM stops the loop at the
next step. The flags are the JAX driver's, with ``--device`` on top and
no ``--mesh`` (one device). It trains ``--backend linear``, whose
attention core runs the B2 forward and B3 backward kernels on the card,
and ``--backend gated_linear`` (the paper's §4 decay form), whose core
runs B8 forward and B9 backward; ``softmax`` raises before any
parameter is built (the port serves softmax but does not train it).
Checkpointing is not ported, so ``--ckpt-dir`` raises and there is no
``--ckpt-every``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --backend linear --batch 8 --seq-len 1024 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --backend gated_linear --batch 8 --seq-len 1024 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-0.6b \\
      --smoke --device cpu --backend linear --steps 30
  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --backend gated_linear --steps 5

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import logging
import signal
from typing import Optional, Sequence

import torch

from repro_torch.configs import ModelConfig, get_config, get_smoke_config
from repro_torch.data import SyntheticLMDataset
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.runtime import TrainLoop, TrainLoopConfig, make_train_step


def config(args) -> ModelConfig:
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    return cfg.with_backend(args.backend) if args.backend else cfg


def build(args) -> TrainLoop:
    device = resolve_device(args.device)
    cfg = config(args)
    optimizer = adamw(
        cosine_warmup(args.lr, warmup=args.warmup, total=args.steps),
        weight_decay=0.1)
    step = make_train_step(cfg, optimizer, n_micro=args.accum,
                           grad_compress=args.grad_compress)

    params = lm.init_params(
        torch.Generator(device=device).manual_seed(args.seed), cfg)
    opt_state = optimizer.init(params)
    dataset = SyntheticLMDataset(
        vocab_size=cfg.vocab_size, seq_len=args.seq_len,
        global_batch=args.batch, seed=args.seed)

    def put(batch):
        return {k: torch.from_numpy(v).to(device, non_blocking=True)
                for k, v in batch.items()}

    loop = TrainLoop(
        step, params, opt_state, dataset,
        TrainLoopConfig(total_steps=args.steps, ckpt_dir=args.ckpt_dir,
                        fail_at_step=args.fail_at_step,
                        log_every=args.log_every),
        put_batch=put)
    signal.signal(signal.SIGTERM, lambda *_: loop.request_preemption())
    return loop


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--backend", default=None,
                    choices=[None, "softmax", "linear", "gated_linear"])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--fail-at-step", type=int, default=None)
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(message)s")
    args = parse_args(argv)
    loop = build(args)
    out = loop.run()
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
