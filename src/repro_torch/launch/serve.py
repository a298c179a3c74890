"""Serving entry point, ``--mode generate`` (port of
``repro/launch/serve.py::generate``).

One static batch of requests: prefill the prompts once, then decode
autoregressively, O(k²) per token under the linear backend (no KV cache;
the decode state has the same size at any context length). Each decode
step runs the fused recurrent CUDA kernel once per layer.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --prompt-len 16 --gen-len 8 --batch 2

Runs on CUDA unless ``--device cpu`` is given; weights and prompts are
random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_recurrent import ops as FR
from repro_torch.models import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(args) -> Dict[str, Any]:
    """Prefill + generation on one static batch. Prints the lines of the
    JAX package's ``generate`` and returns the measured numbers, the
    generated tokens and the decode kernel's launches in the timed
    generation (``decode_launches``)."""
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    cfg = cfg.with_backend(args.backend)
    # independent generator streams: params / prompt / sampling
    gens = [torch.Generator(device=device).manual_seed(args.seed * 4 + i)
            for i in range(3)]
    g_params, g_prompt, g_sample = gens
    params = lm.cast_params(lm.init_params(g_params, cfg),
                            lm.dtype_of(cfg.dtype))

    b, t_p, t_g = args.batch, args.prompt_len, args.gen_len
    prompt = torch.randint(0, cfg.vocab_size, (b, t_p), generator=g_prompt,
                           device=device)

    # warm-up, untimed: one prefill and two decode steps, so the kernel
    # is built and loaded and the library has picked its matmul kernels
    # before the clock starts
    logits, states = lm.prefill(params, prompt, cfg)
    lm.generate(params, states, torch.argmax(logits, -1), t_p, 2, cfg)
    _sync(device)

    t0 = time.perf_counter()
    logits, states = lm.prefill(params, prompt, cfg)
    states = lm.pad_decode_state(states, cfg, max_len=t_p + t_g)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    tok0 = lm.sample_token(logits, args.temperature, g_sample)
    launches0 = FR.decode_linear.launches
    t0 = time.perf_counter()
    toks, states = lm.generate(params, states, tok0, t_p, t_g - 1, cfg,
                               temperature=args.temperature,
                               generator=g_sample)
    _sync(device)
    t_decode = time.perf_counter() - t0
    launches = FR.decode_linear.launches - launches0
    out = torch.cat([tok0[:, None], toks], dim=1)
    if out.shape != (b, t_g):
        raise RuntimeError(f"generated {tuple(out.shape)}, want {(b, t_g)}")

    n_dec = max(t_g - 1, 1)
    state_mib = lm.state_bytes(states) / 2**20
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} backend={cfg.attention_backend} "
          f"decode_kernel={cfg.decode_kernel} device={where}")
    print(f"prefill {t_p} toks x{b}: {t_prefill*1e3:.0f} ms")
    print(f"decode  {t_g} toks x{b}: {t_decode/n_dec*1e3:.2f} ms/tok "
          f"({b*n_dec/t_decode:.0f} tok/s)")
    print(f"decode state: {state_mib:.1f} MiB "
          f"({'O(1) in context' if cfg.fixed_state_decode else 'KV cache'})")
    return {"prefill_ms": t_prefill * 1e3,
            "decode_ms_per_token": t_decode / n_dec * 1e3,
            "tokens_per_s": b * n_dec / t_decode,
            "state_mib": state_mib, "tokens": out,
            "decode_launches": launches}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="generate", choices=["generate"])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", default="linear", choices=["linear"],
                    help="the port serves the linear backend")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = categorical sampling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv: Optional[Sequence[str]] = None) -> int:
    generate(parse_args(argv))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
