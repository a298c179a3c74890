#!/usr/bin/env python3
"""Time the lookup kernels of one tree of the port on one GPU.

    python3 scripts/lookup_kernel_times.py [--src DIR] [--tag NAME]

Imports ``repro_torch`` from DIR (default: this checkout's ``src``) and
runs ``chip_smoke.time_lookup_kernels`` on a random store of the lookup
main path's shape (16,384 states of 64 × 64, the first 8,192 drawn from):
B4 at the main path's wave, cold and L2-warm, and at the paper's width;
B5; B6 at the paper's width and at the LM's 128 × 128 in bf16; and the
launch floor, each beside its bound, plain version and library call (or
the two calls that compute the same: gather + ``bmm`` for B4,
``baddbmm`` + ``bmm`` for B6). To compare two trees on one card, unpack the other one
(``git archive``) into a directory that ``.gitignore`` lists and run this
once per tree within one call, in turns (A, B, B, A): each tree builds
its own kernel library under its own ``build/``. Prints the card's name
and power limit, one line per kernel and, last, one JSON line.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402  (puts this checkout's src first)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a name for the JSON line")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("lookup_kernel_times: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    import repro_torch
    if Path(repro_torch.__file__).resolve().parents[1] != src:
        raise SystemExit(f"repro_torch came from {repro_torch.__file__}, "
                         f"not {src}")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    store = torch.randn((16384, 64, 64), generator=gen, device=dev)
    times = chip_smoke.time_lookup_kernels(store, 8192, gen, dev)
    card = chip_smoke.nvidia_smi()
    print(card)
    print(f"tree {src} ({args.tag})")
    chip_smoke.print_lookup_times(times)
    keys = ("ms", "plain_ms", "library_ms", "gather_bmm_ms",
            "baddbmm_bmm_ms", "bound_ms")
    print(json.dumps({"tag": args.tag, "card": card, "times": {
        name: {k: t[k] for k in keys if k in t} for name, t in
        times.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
