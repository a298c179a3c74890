#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit, and the build of every CUDA
   kernel of the port from the sources in this checkout.
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the smoke width.
3. The serving slice on the card: a 2-layer model at qwen3-0.6b's full
   widths in fp32, prefill + 16 greedy steps through the kernel against
   the same run through ``decode_kernel="reference"``.
4. The main path: ``repro_torch.launch.serve --mode generate`` on the
   full 28-layer qwen3-0.6b linear model in bf16 (random weights from a
   seed), batch 8, prompt 512, 64 generated tokens; the kernels' launch
   counts over that run; a profile of a few decode steps; each kernel
   timed with CUDA events beside its bound and its plain version.

The last line is {"ok": true, "device": {...}}; the line before it the
kernels' JSON record; before that the card's name and power limit.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def bf16_ulps(x, ref):
    """|x - ref| in units of one bf16 ulp of ref (8 significant bits)."""
    import torch
    _, e = torch.frexp(ref.float())
    ulp = torch.ldexp(torch.ones_like(ref, dtype=torch.float32), e - 8)
    return ((x.float() - ref.float()).abs() / ulp).max().item()


def elu1(x):
    import torch.nn.functional as F
    return F.elu(x) + 1.0


def decode_inputs(n, d, w, dtype, gen, dev):
    """Positive S, z, q, k, v: no sum cancels, so two fp32 sums taken in
    different orders agree to ~D·2^-24 relative, far inside one bf16 ulp
    (2^-8 relative); a larger difference is a fault, not rounding."""
    import torch
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    return dict(s=r(n, d, d).abs(), z=elu1(r(n, d)) * 4.0,
                q=elu1(r(n, w, d)).to(dtype), k=elu1(r(n, w, d)).to(dtype),
                v=elu1(r(n, w, d)).to(dtype))


def check_decode_linear(n, d, w, normalize, varlen, gen, dev) -> float:
    """Kernel vs plain version; returns the largest |o difference|."""
    import torch
    from repro_torch.kernels.fused_recurrent import ops, ref
    x = decode_inputs(n, d, w, torch.bfloat16, gen, dev)
    lens = (torch.arange(n, dtype=torch.int32, device=dev) % (w + 1)
            if varlen else None)            # includes 0 and W
    z = x["z"] if normalize else None
    o_r, s_r, z_r = ref.fused_recurrent_linear_ref(
        x["s"][:, None], x["q"][:, None], x["k"][:, None], x["v"][:, None],
        z=None if z is None else z[:, None], normalize=normalize, lens=lens)
    s_k = x["s"].clone()
    z_k = None if z is None else z.clone()
    o_k, _, _ = ops.decode_linear(s_k, x["q"], x["k"], x["v"], z=z_k,
                                  normalize=normalize, lens=lens)
    torch.cuda.synchronize()
    o_r, s_r = o_r[:, 0], s_r[:, 0]
    tag = f"n={n} d={d} w={w} normalize={normalize} varlen={varlen}"
    torch.testing.assert_close(s_k, s_r, rtol=1e-5, atol=1e-6, msg=tag)
    if normalize:
        torch.testing.assert_close(z_k, z_r[:, 0], rtol=1e-5, atol=1e-6,
                                   msg=tag)
    ulps = bf16_ulps(o_k, o_r)
    if ulps > 1.0:
        raise AssertionError(f"decode_linear {tag}: o off by {ulps} bf16 ulp")
    if varlen:
        steps = torch.arange(w, device=dev)[None, :]
        masked = steps >= lens[:, None]                       # (n, w)
        if torch.count_nonzero(o_k[masked]) != 0:
            raise AssertionError(f"decode_linear {tag}: masked o not 0")
        idle = lens == 0
        if not torch.equal(s_k[idle], x["s"][idle]) or (
                normalize and not torch.equal(z_k[idle], z[idle])):
            raise AssertionError(f"decode_linear {tag}: lens=0 rows moved")
    err = (o_k.float() - o_r.float()).abs().max().item()
    same = torch.equal(s_k, s_r) and (not normalize
                                      or torch.equal(z_k, z_r[:, 0]))
    print(f"  decode_linear {tag}: max|Δo|={err:.3e} ({ulps:.2f} bf16 ulp),"
          f" S and z within rtol 1e-5, bitwise equal: {same}")
    return err


def graph_ms(fn, n_calls: int, replays: int = 20) -> float:
    """Device time of one call of ``fn(i)``, from CUDA events around
    replays of a CUDA graph that holds ``n_calls`` calls (host launch
    overhead excluded)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):           # warm-up outside the graph
        for i in range(3):
            fn(i)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n_calls):
            fn(i)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * n_calls)


def time_decode_linear(n, d, gen, dev) -> dict:
    """B1 at the main path's shape (W=1, normalize, bf16), cycling over
    enough state buffers (> 50 MB L2) that each launch finds its state
    in device memory, as the 28-layer decode does."""
    import torch
    from repro_torch.kernels.fused_recurrent import ops, ref
    w, n_bufs = 1, 16
    x = decode_inputs(n, d, w, torch.bfloat16, gen, dev)
    states = [x["s"].clone() for _ in range(n_bufs)]
    zs = [x["z"].clone() for _ in range(n_bufs)]

    def kernel(i):
        ops.decode_linear(states[i % n_bufs], x["q"], x["k"], x["v"],
                          z=zs[i % n_bufs], normalize=True)

    def plain(i):
        ref.fused_recurrent_linear_ref(
            states[i % n_bufs][:, None], x["q"][:, None], x["k"][:, None],
            x["v"][:, None], z=zs[i % n_bufs][:, None], normalize=True)

    ms = graph_ms(kernel, 2 * n_bufs)
    plain_ms = graph_ms(plain, 2 * n_bufs)
    in_bytes = sum(t.nbytes for t in (x["s"], x["z"], x["q"], x["k"],
                                      x["v"]))
    out_bytes = x["s"].nbytes + x["z"].nbytes + x["v"].nbytes    # s, z, o
    flops = n * w * (4 * d * d + 4 * d)
    bytes_ms = (in_bytes + out_bytes) / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / PEAK_FP32_FLOPS * 1e3
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=in_bytes + out_bytes)


def profile_decode(params, cfg, states, tok, pos, steps=4):
    """Device time by kernel over a few decode steps (torch.profiler);
    returns device ms per step, or None when the profiler saw none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, states = lm.decode_step(params, states, tok, pos + i,
                                            cfg)
            tok = torch.argmax(logits, -1)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / steps * 1e3
    rows, host = [], []
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0) or 0)
        if t > 0:
            rows.append((t, e.key, e.count))
        if e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.key, e.count))
    rows.sort(reverse=True)
    host.sort(reverse=True)
    host_total = sum(t for t, _, _ in host)
    print(f"  profile: {wall_ms:.3f} ms wall per decode step under the "
          f"profiler; host time in operators {host_total / steps / 1e3:.3f}"
          f" ms per step (the profiler adds its own cost to both)")
    for t, key, count in host[:8]:
        print(f"    host {100 * t / host_total:5.1f}%  "
              f"{t / steps / 1e3:8.4f} ms/step  x{count // steps:<4d} "
              f"{key[:80]}")
    total = sum(t for t, _, _ in rows)
    if not total:
        print("  profile: the profiler reported no device time "
              "(not measured)")
        return None
    print(f"  profile: {total / steps / 1e3:.3f} ms device time per decode "
          f"step ({steps} steps)")
    for t, key, count in rows[:10]:
        print(f"    {100 * t / total:5.1f}%  {t / steps / 1e3:8.4f} ms/step "
              f" x{count // steps:<4d} {key[:90]}")
    return total / steps / 1e3


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.fused_recurrent import ops
    from repro_torch.launch import serve
    from repro_torch.models import lm

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    # -- 1. device and build ---------------------------------------------
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    ops.load()
    print(f"phase 1: built and loaded the kernels in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_SECONDS})")
    for name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    # -- 2. kernels against their plain versions --------------------------
    gen = torch.Generator(device=dev).manual_seed(0)
    for n, d in ((128, 128), (12, 16)):         # main path, smoke width
        for w in (1, 8):
            for normalize in (False, True):
                for varlen in (False, True):
                    err = check_decode_linear(n, d, w, normalize, varlen,
                                              gen, dev)
                    if (d, w, normalize, varlen) == (128, 1, True, False):
                        main_err = err          # the main path's variant
    print("phase 2: decode_linear agrees with its plain version "
          "(S, z rtol 1e-5; o within 1 bf16 ulp; masked rows bitwise)")

    # -- 3. the slice, kernel vs plain recurrence, fp32 --------------------
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").with_backend("linear"), n_layers=2,
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    runs = {}
    for kernel in ("auto", "reference"):
        c = dataclasses.replace(cfg, decode_kernel=kernel)
        logits, st = lm.prefill(params, prompt, c)
        tok = lm.sample_token(logits, 0.0)
        all_logits, toks = [logits], [tok]
        for i in range(16):
            logits, st = lm.decode_step(params, st, tok, 64 + i, c)
            tok = lm.sample_token(logits, 0.0)
            all_logits.append(logits)
            toks.append(tok)
        runs[kernel] = (torch.stack(all_logits), torch.stack(toks))
    torch.testing.assert_close(runs["auto"][0], runs["reference"][0],
                               rtol=1e-4, atol=1e-4)
    if not torch.equal(runs["auto"][1], runs["reference"][1]):
        raise AssertionError("phase 3: greedy tokens differ")
    if not torch.isfinite(runs["auto"][0]).all():
        raise AssertionError("phase 3: non-finite logits")
    d_logit = (runs["auto"][0] - runs["reference"][0]).abs().max().item()
    print(f"phase 3: 2-layer full-width fp32 slice, prefill + 16 greedy "
          f"steps: tokens identical, max|Δlogit|={d_logit:.3e}")
    del params, runs

    # -- 4. the main path -------------------------------------------------
    args = serve.parse_args(["--arch", "qwen3-0.6b", "--batch", "8",
                             "--prompt-len", "512", "--gen-len", "64",
                             "--seed", "0"])
    full = get_config(args.arch)
    ops.decode_linear.launches = 0
    result = serve.generate(args)
    launches = ops.decode_linear.launches
    # the timed generation launches once per layer and token; the
    # entry point's untimed warm-up adds two decode steps
    want = full.n_layers * (args.gen_len - 1)
    if result["decode_launches"] != want:
        raise AssertionError(f"decode_linear launched "
                             f"{result['decode_launches']} times in the "
                             f"timed generation, want {want}")
    if launches != want + 2 * full.n_layers:
        raise AssertionError(f"decode_linear launched {launches} times in "
                             f"the run, want {want + 2 * full.n_layers}")
    toks = result["tokens"]
    if toks.shape != (args.batch, args.gen_len) or not (
            (toks >= 0) & (toks < full.vocab_size)).all():
        raise AssertionError("phase 4: bad generated tokens")
    print(f"phase 4: main path prefill_ms={result['prefill_ms']:.3f} "
          f"decode_ms_per_token={result['decode_ms_per_token']:.4f} "
          f"tok_s={result['tokens_per_s']:.1f} "
          f"state_mib={result['state_mib']:.1f} "
          f"decode_linear.launches={launches} (timed generation "
          f"{result['decode_launches']} = {full.n_layers} x "
          f"{args.gen_len - 1}, warm-up {full.n_layers} x 2)")

    # where a decode step's device time goes (bf16, full model)
    cfg_main = full.with_backend("linear")
    params = lm.cast_params(
        lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg_main),
        torch.bfloat16)
    prompt = torch.randint(0, full.vocab_size, (args.batch, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    logits, st = lm.prefill(params, prompt, cfg_main)
    device_ms = profile_decode(params, cfg_main, st,
                               torch.argmax(logits, -1), 64)
    if device_ms is not None:
        busy = device_ms / result["decode_ms_per_token"]
        print(f"  device busy {100 * busy:.1f}% of a decode step "
              f"({device_ms:.3f} ms device time per step over "
              f"{result['decode_ms_per_token']:.3f} ms per token)")
    del params, st

    t = time_decode_linear(8 * full.n_heads, full.head_dim, gen, dev)
    print(f"decode_linear N={8 * full.n_heads} D={full.head_dim} W=1 bf16: "
          f"{t['ms'] * 1e3:.2f} us/launch (plain version "
          f"{t['plain_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.2f} us"
          f" by {t['bound_by']}, {t['bytes'] / 1e6:.2f} MB moved)")

    record = {"kernels": [{
        "name": "decode_linear", "route": "cuda",
        "source": "src/repro_torch/kernels/fused_recurrent/csrc/"
                  "decode_linear.cu",
        "replaces": "src/repro/kernels/fused_recurrent/kernel.py:239",
        "launches": launches, "max_abs_err": main_err, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": None}]}
    print(card)
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
