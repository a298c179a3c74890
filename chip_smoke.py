#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit, and the build of every CUDA
   kernel of the port from the sources in this checkout; each kernel's
   registers, spills and ptxas's notes on serialized wgmmas; the HGMMA
   instructions in B10's, B8/B9's and B2/B3's libraries (their bf16
   routes run on the tensor cores).
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the smoke width (B10 at each D it takes,
   with K/V of fewer heads than q, and against JAX's oracle; B2, B3, B8
   and B9 in bf16 at T not a multiple of their 64-token tile, D = 16 and
   128, B3's and B9's launches each on its own, B2 and B8 (inclusive and
   exclusive + u) with a final state far from symmetric; B8/B9 at the
   decay clamp and at each route's ``min_log_decay`` limit against
   ``gla_scan``, and a value past the limit refused).
3. The serving slice on the card: a 2-layer model at qwen3-0.6b's full
   widths in fp32, prefill + 16 greedy steps through the kernel against
   the same run through ``decode_kernel="reference"``.
4. The generate main path: ``repro_torch.launch.serve --mode generate``
   on the full 28-layer qwen3-0.6b linear model in bf16 (random weights
   from a seed), batch 8, prompt 512, 64 generated tokens; the decode
   kernel's launch count over that run; a profile of a few decode steps;
   the kernel timed with CUDA events beside its bound and its plain
   version.
5. The lookup slice at the paper's width (k = 100, 750-token documents,
   1-4 queries per request): ``LookupEngine`` through the lookup kernel
   against the same through ``use_kernel=False``, and the softmax
   baseline's resident bytes beside the linear store's.
6. The lookup main path: ``repro_torch.launch.serve --mode lookup`` with
   8,192 resident 750-token documents and two passes of 131,072 queries in
   waves of 256; the lookup kernel's launch count over that run; sampled
   answers against the store; a profile of a few waves; the three lookup
   kernels timed beside their bounds, plain versions and library calls.
7. The gated slice (paper §4 decay, ``--backend gated_linear``) as phase
   3: 2 layers at full width in fp32 through the gated decode kernel
   against ``decode_kernel="reference"``.
8. The gated generate main path: ``serve --backend gated_linear`` on the
   full 28-layer qwen3-0.6b in bf16, batch 8, prompt 512, 64 generated
   tokens; the gated kernel's launch count over that run; a profile of a
   few decode steps; the kernel timed beside its bound and plain version.
9. The training slice on the card: 2 layers at qwen3-0.6b's full widths
   in fp32, batch 2 x 256 tokens, weights from seed 0: the loss, every
   gradient leaf and the parameters after one AdamW step through B2/B3
   against the same through their plain versions
   (``attention_kernel=False``); then the same 2 layers in bf16 compute
   (B2 and B3 on the tensor cores): the loss and every gradient leaf.
10. The training main path: ``repro_torch.launch.train``'s ``build`` and
   ``TrainLoop`` on the full 28-layer qwen3-0.6b (linear, bf16 compute,
   fp32 master weights, remat per layer), batch 8 x seq 1,024, 2 warm-up
   and 6 timed steps; ms/step, tokens/s, peak memory, the losses, B2/B3
   launches per step, a profile of one step, and B2, B3-dq, B3-dkv and
   B3 as a whole (``ops.bwd``) timed beside their bounds and plain
   versions.
11. The gated training slice (paper §4 decay, ``--backend gated_linear``)
   as phase 9, through B8/B9 against ``attention_kernel=False``, in fp32
   and in bf16 compute.
12. The gated training main path as phase 10: ``launch/train.py
   --backend gated_linear`` on the full 28-layer model; B8/B9 launches
   per step, a profile of one step (which must hold no flip or cumsum
   kernel: B9 forms dg in its dk/dv launch), B8, B9-dq and B9-dkv timed
   beside their bounds and plain versions, B9 as a whole (``ops.bwd``)
   beside its bound, and alone the eager dg epilogue that B9 ran
   before its dk/dv launch formed dg.
13. The softmax slice (paper §2's KV-cache baseline, ``--backend
   softmax``): 2 layers at full width in fp32, batch 4, prompt 64,
   prefill through the causal flash-attention kernel (B10) + 16 greedy
   steps over the KV cache, against prefill through B10's plain version
   (``attention_kernel=False``).
14. The softmax generate main path: ``serve --backend softmax`` on the
   full 28-layer qwen3-0.6b in bf16, batch 8, prompt 512, 64 generated
   tokens; B10's launch count over that run (once per layer and
   prefill), the KV cache's size, a profile of a few decode steps and of
   one prefill, and B10 timed beside its bounds, its plain version and
   ``scaled_dot_product_attention`` at the prefill's shape (K/V of 8 kv
   heads) and with K/V of 16 heads.

Each main path (phases 4, 6, 8, 10, 12 and 14) is driven with every
kernel's launch count set to 0 just before it and read just after.

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

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 non-tensor flop/s,
# bf16 dense tensor-core flop/s
PEAK_BYTES_PER_S = 3.35e12
PEAK_FP32_FLOPS = 67e12
PEAK_BF16_TC_FLOPS = 989e12
# the lookup kernels' outputs against their plain versions: fp32 sums in
# another order (the JAX kernel tests' tolerance)
LOOKUP_TOL = 1e-4


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def hgmma_count(build, source) -> int:
    """HGMMA instructions in the SASS of ``source``'s built library."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build._lib_path(source))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sass.count("HGMMA")


def ptxas_notes(log: str) -> list:
    """From ``nvcc -Xptxas=-v`` output: each kernel's registers and
    spills, and ptxas's C75xx notes (a wgmma serialized, and why), each
    tagged with the kernel's name, its template arguments shortened."""
    import re

    def short(mangled):
        # the first length-prefixed name followed by template arguments
        for n in re.finditer(r"(?<!\d)\d+", mangled):
            end = n.end() + int(n.group())
            ident, rest = mangled[n.end():end], mangled[end:]
            if re.fullmatch(r"[A-Za-z_]\w*", ident) and rest[:1] == "I":
                args = re.match(r"I(.*?)E(?:E|v)", rest)
                return f"{ident}<{args.group(1) if args else ''}>"
        return mangled

    out, kernel = [], "?"
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            kernel = short(m.group(1))
            continue
        note = re.search(r"\((C75\d\d)\) (.*?)(?: in (?:the )?function "
                         r"'([^']+)')?$", line.strip())
        if note:
            where = short(note.group(3)) if note.group(3) else "?"
            out.append(f"{where}: {note.group(1)} {note.group(2)}")
        elif "registers" in line or "spill" in line:
            out.append(f"{kernel}: {line.split(':', 1)[-1].strip()}")
    return out


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


def gated_decay(kind, n, w, d, gen, dev):
    """A log-decay (N, W, D) fp32: mild (the model's regime, in [-1, 0]),
    strong (≤ -5, far past the prefill clamp: decode does not clamp),
    zero (a = 1), or scalar (one value per row and step, broadcast over
    D, as decode broadcasts a per-head decay)."""
    import torch
    u = torch.rand((n, w, d), generator=gen, device=dev)
    if kind == "mild":
        return -u
    if kind == "strong":
        return -5.0 - 3.0 * u
    if kind == "zero":
        return torch.zeros_like(u)
    return (-u[..., :1]).expand(n, w, d).contiguous()


def check_decode_gated(n, d, w, dtype, varlen, decay, gen, dev) -> float:
    """B7 against its plain version; returns the largest |o difference|.
    S within rtol 1e-6 (positive inputs: no cancellation), o within 1e-5
    (fp32) or 1 bf16 ulp, lens-0 rows bitwise unchanged, masked o 0."""
    import torch
    from repro_torch.kernels.fused_recurrent import ops, ref
    x = decode_inputs(n, d, w, dtype, gen, dev)
    g = gated_decay(decay, n, w, d, gen, dev)
    lens = (torch.arange(n, dtype=torch.int32, device=dev) % (w + 3)
            if varlen else None)            # 0, 1 .. W and beyond W
    o_r, s_r = ref.fused_recurrent_gated_ref(
        x["s"][:, None], x["q"][:, None], x["k"][:, None], x["v"][:, None],
        g[:, None], lens=lens)
    s_k = x["s"].clone()
    o_k, _ = ops.decode_gated(s_k, x["q"], x["k"], x["v"], g, lens=lens)
    torch.cuda.synchronize()
    o_r, s_r = o_r[:, 0], s_r[:, 0]
    tag = (f"n={n} d={d} w={w} {str(dtype).split('.')[-1]} varlen={varlen}"
           f" decay={decay}")
    torch.testing.assert_close(s_k, s_r, rtol=1e-6, atol=0.0, msg=tag)
    if dtype == torch.float32:
        torch.testing.assert_close(o_k, o_r, rtol=1e-5, atol=1e-5, msg=tag)
        ulps = float("nan")
    else:
        ulps = bf16_ulps(o_k, o_r)
        if ulps > 1.0:
            raise AssertionError(f"decode_gated {tag}: o off by {ulps} "
                                 f"bf16 ulp")
    if varlen:
        steps = torch.arange(w, device=dev)[None, :]
        masked = steps >= lens[:, None]                       # (n, w)
        if torch.count_nonzero(o_k[masked]) != 0:
            raise AssertionError(f"decode_gated {tag}: masked o not 0")
        idle = lens == 0
        if not torch.equal(s_k[idle], x["s"][idle]):
            raise AssertionError(f"decode_gated {tag}: lens=0 rows moved")
    d_o = (o_k.float() - o_r.float()).abs()
    err = d_o.max().item()
    rel = (d_o / o_r.float().abs().clamp_min(1e-30)).max().item()
    d_s = (s_k - s_r).abs().max().item()
    n_diff = int(torch.count_nonzero(s_k != s_r))
    print(f"  decode_gated {tag}: max|Δo|={err:.3e} (relative {rel:.2e}; "
          f"{ulps:.2f} bf16 ulp), max|ΔS|={d_s:.3e}, {n_diff} of "
          f"{s_k.numel()} state elements not bitwise equal")
    return err


def bound(n_bytes: float, flops: float, peak: float = PEAK_FP32_FLOPS
          ) -> dict:
    """The least time the card could take: bytes over the memory rate or
    the operations over ``peak`` (the fp32 rate outside the tensor cores
    unless given), whichever is larger."""
    bytes_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    flops_ms = flops / peak * 1e3
    return dict(bound_ms=max(bytes_ms, flops_ms),
                bound_by="bytes" if bytes_ms >= flops_ms else "operations",
                bytes=n_bytes, flops=flops)


def nonsymmetric(gen, dev, *shape):
    """Random states with C != Cᵀ, so that a transposed read shows."""
    import torch
    c = torch.randn(shape, generator=gen, device=dev)
    if (c - c.mT).abs().max() < 0.1:
        raise AssertionError("states came out symmetric")
    return c


def check_lookup_indexed(n, b, m, kd, block_m, gen, dev, n_live=None
                         ) -> float:
    """B4 against its plain version; returns the largest |o difference|.
    Rows are drawn from the first ``n_live`` states (all by default)."""
    import torch
    from repro_torch.kernels.lookup import ops as LU, ref as LR
    store = nonsymmetric(gen, dev, n, kd, kd)
    rows = torch.randint(0, n_live or n, (b,), generator=gen, device=dev,
                         dtype=torch.int32)
    q = torch.randn((b, m, kd), generator=gen, device=dev)
    o = LU.mass_lookup_indexed(store, rows, q, block_m=block_m)
    torch.cuda.synchronize()
    o_r = LR.mass_lookup_indexed_ref(store, rows, q)
    tag = f"N={n} B={b} M={m} K={kd} block_m={block_m}"
    torch.testing.assert_close(o, o_r, rtol=LOOKUP_TOL, atol=LOOKUP_TOL,
                               msg=tag)
    dup = b - torch.unique(rows).numel()
    err = (o - o_r).abs().max().item()
    print(f"  mass_lookup_indexed {tag} ({dup} repeated rows): "
          f"max|Δo|={err:.3e}")
    return err


def check_mass_lookup(n, m, kd, gen, dev) -> float:
    """B5 against its plain version and against one torch.bmm."""
    import torch
    from repro_torch.kernels.lookup import ops as LU, ref as LR
    c = nonsymmetric(gen, dev, n, kd, kd)
    q = torch.randn((n, m, kd), generator=gen, device=dev)
    o = LU.mass_lookup(c, q)
    torch.cuda.synchronize()
    tag = f"N={n} M={m} K={kd}"
    o_r = LR.mass_lookup_ref(c, q)
    torch.testing.assert_close(o, o_r, rtol=LOOKUP_TOL, atol=LOOKUP_TOL,
                               msg=tag)
    torch.testing.assert_close(o, torch.bmm(q, c.mT), rtol=LOOKUP_TOL,
                               atol=LOOKUP_TOL, msg=tag)
    err = (o - o_r).abs().max().item()
    print(f"  mass_lookup {tag}: max|Δo|={err:.3e}")
    return err


def check_fused_decode(n, dk, dv, dtype, gen, dev) -> float:
    """B6 against its plain version: the state bit for bit, o within
    LOOKUP_TOL (fp32) or 2e-2 (bf16 output)."""
    import torch
    from repro_torch.kernels.lookup import ops as LU, ref as LR
    s = nonsymmetric(gen, dev, n, dk, dv) if dk == dv else torch.randn(
        (n, dk, dv), generator=gen, device=dev)
    q, k = (torch.randn((n, dk), generator=gen, device=dev).to(dtype)
            for _ in range(2))
    v = torch.randn((n, dv), generator=gen, device=dev).to(dtype)
    o_r, s_r = LR.decode_ref(s, q, k, v)
    s_k = s.clone()
    o, _ = LU.fused_decode(s_k, q, k, v)
    torch.cuda.synchronize()
    tag = f"N={n} Dk={dk} Dv={dv} {str(dtype).split('.')[-1]}"
    if not torch.equal(s_k, s_r):
        raise AssertionError(f"fused_decode {tag}: state not bitwise equal "
                             f"(max |Δ| {(s_k - s_r).abs().max().item()})")
    tol = LOOKUP_TOL if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_r.float(), rtol=tol, atol=tol,
                               msg=tag)
    err = (o.float() - o_r.float()).abs().max().item()
    print(f"  fused_decode {tag}: state bitwise equal, max|Δo|={err:.3e}")
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


def time_decode_gated(n, d, gen, dev) -> dict:
    """B7 at the gated main path's shape (W=1, bf16 q/k/v, fp32 g at the
    model's operating point, g ≈ -0.002), cycling over 16 state buffers
    (> 50 MB L2) as the 28-layer decode does."""
    import torch
    from repro_torch.kernels.fused_recurrent import ops, ref
    w, n_bufs = 1, 16
    x = decode_inputs(n, d, w, torch.bfloat16, gen, dev)
    g = -0.004 * torch.rand((n, w, d), generator=gen, device=dev)
    states = [x["s"].clone() for _ in range(n_bufs)]

    def kernel(i):
        ops.decode_gated(states[i % n_bufs], x["q"], x["k"], x["v"], g)

    def plain(i):
        ref.fused_recurrent_gated_ref(
            states[i % n_bufs][:, None], x["q"][:, None], x["k"][:, None],
            x["v"][:, None], g[:, None])

    ms = graph_ms(kernel, 2 * n_bufs)
    plain_ms = graph_ms(plain, 2 * n_bufs)
    in_bytes = sum(t.nbytes for t in (x["s"], x["q"], x["k"], x["v"], g))
    out_bytes = x["s"].nbytes + x["v"].nbytes                    # s, o
    # per element: a·S, k·v, their sum, and o's multiply-add; exp per row
    flops = n * w * (5 * d * d + d)
    return dict(ms=ms, plain_ms=plain_ms, **bound(in_bytes + out_bytes,
                                                  flops))


def time_lookup_kernels(store, n_live, gen, dev) -> dict:
    """B4 at the lookup main path's wave (B = 256 rows of the served
    store, M = 1), cycling over 16 row sets (64 MiB of distinct states,
    more than the 50 MB L2) so each launch reads its states from device
    memory; B5 at the paper's width (N = 256 documents, M = PAPER_M = 4,
    K = PAPER_K = 100) and B6 at N = 256, Dk = Dv = 100, fp32, each over
    16 buffers of inputs for the same reason."""
    import torch
    from repro_torch.configs.paper_qa import PAPER_K, PAPER_M
    from repro_torch.kernels.lookup import ops as LU, ref as LR
    n_bufs, b, kd = 16, 256, store.shape[-1]
    out = {}

    rows = [torch.randint(0, n_live, (b,), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(n_bufs)]
    rows_long = [r.long() for r in rows]
    q = torch.randn((b, 1, kd), generator=gen, device=dev)
    distinct = sum(torch.unique(r).numel() for r in rows) / n_bufs
    t = dict(
        ms=graph_ms(lambda i: LU.mass_lookup_indexed(
            store, rows[i % n_bufs], q, block_m=1), 2 * n_bufs),
        plain_ms=graph_ms(lambda i: LR.mass_lookup_indexed_ref(
            store, rows[i % n_bufs], q), 2 * n_bufs),
        gather_bmm_ms=graph_ms(lambda i: torch.bmm(
            q, store.index_select(0, rows_long[i % n_bufs]).mT), 2 * n_bufs),
        library_ms=None, shape=f"N={store.shape[0]} B={b} M=1 K={kd}",
        **bound(distinct * kd * kd * 4 + b * 4 + 2 * q.nbytes,
                2 * b * kd * kd))
    out["mass_lookup_indexed"] = t

    n, m, kp = 256, PAPER_M, PAPER_K
    cs = [torch.randn((n, kp, kp), generator=gen, device=dev)
          for _ in range(n_bufs)]
    q = torch.randn((n, m, kp), generator=gen, device=dev)
    out["mass_lookup"] = dict(
        ms=graph_ms(lambda i: LU.mass_lookup(cs[i % n_bufs], q), 2 * n_bufs),
        plain_ms=graph_ms(lambda i: LR.mass_lookup_ref(cs[i % n_bufs], q),
                          2 * n_bufs),
        library_ms=graph_ms(lambda i: torch.bmm(q, cs[i % n_bufs].mT),
                            2 * n_bufs),
        shape=f"N={n} M={m} K={kp}",
        **bound(cs[0].nbytes + 2 * q.nbytes, 2 * n * m * kp * kp))
    del cs

    ss = [torch.randn((n, kp, kp), generator=gen, device=dev)
          for _ in range(n_bufs)]
    qd, kd_, vd = (torch.randn((n, kp), generator=gen, device=dev)
                   for _ in range(3))
    out["fused_decode"] = dict(
        ms=graph_ms(lambda i: LU.fused_decode(ss[i % n_bufs], qd, kd_, vd),
                    2 * n_bufs),
        plain_ms=graph_ms(lambda i: LR.decode_ref(ss[i % n_bufs], qd, kd_,
                                                  vd), 2 * n_bufs),
        library_ms=None, shape=f"N={n} Dk={kp} Dv={kp} fp32",
        **bound(2 * ss[0].nbytes + 4 * qd.nbytes, 4 * n * kp * kp))
    return out


def profile_rows(prof):
    """(µs, name, count) rows of a torch.profiler run, largest first: the
    device rows (kernels, copies and sets that ran on the card) and the
    host rows (operators' own CPU time). An operator's row also carries
    the device time of the kernels it launched, so only events that ran
    on the device count as device time; summing every row would count
    each such kernel twice."""
    from torch.autograd import DeviceType
    rows, host = [], []
    for e in prof.key_averages():
        t = (getattr(e, "self_device_time_total", None)
             or getattr(e, "self_cuda_time_total", 0) or 0)
        if t > 0 and e.device_type == DeviceType.CUDA:
            rows.append((t, e.key, e.count))
        if e.self_cpu_time_total > 0:
            host.append((e.self_cpu_time_total, e.key, e.count))
    return sorted(rows, reverse=True), sorted(host, reverse=True)


def profile_lookup_waves(engine, doc_ids, queries, waves=8):
    """Device busy share over a few timed waves (torch.profiler): device
    time by kernel against the wall time of ``engine.run()``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    n = waves * engine.wave_size
    for i in range(n):
        engine.submit(doc_ids[(i * 7) % len(doc_ids)], queries[i],
                      priority=i % 3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        engine.run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, host = profile_rows(prof)
    host_total = sum(t for t, _, _ in host)
    print(f"  profile: {waves} waves in {wall_ms:.3f} ms wall under the "
          f"profiler ({wall_ms / waves:.3f} ms per wave); host time in "
          f"operators {host_total / waves / 1e3:.3f} ms per wave")
    for t, key, count in host[:6]:
        print(f"    host {100 * t / host_total:5.1f}%  "
              f"{t / waves / 1e3:8.4f} ms/wave  {count:5d} calls  "
              f"{key[:80]}")
    total = sum(t for t, _, _ in rows)
    if not total:
        print("  profile: the profiler reported no device time "
              "(not measured)")
        return None
    busy = total / 1e3 / wall_ms
    print(f"  profile: {total / waves / 1e3:.4f} ms device time per wave; "
          f"device busy {100 * busy:.1f}% of the wall time")
    for t, key, count in rows[:8]:
        print(f"    {100 * t / total:5.1f}%  {t / waves / 1e3:8.4f} ms/wave "
              f" {count:5d} calls  {key[:90]}")
    return busy


def lookup_slice(dev) -> None:
    """Phase 5: the paper-width lookup slice through the kernel against
    the same through ``use_kernel=False``; the softmax baseline's
    resident bytes beside the linear store's."""
    import numpy as np
    import torch
    from repro_torch.configs.paper_qa import PAPER_M, PAPER_N, QAConfig
    from repro_torch.kernels.lookup import ops as LU
    from repro_torch.qa.gru import gru_params
    from repro_torch.serving import LookupEngine

    cfg = QAConfig()
    g = torch.Generator(device=dev).manual_seed(5)
    encoder = {"embed": torch.randn((cfg.vocab_size, cfg.embed_dim),
                                    generator=g, device=dev) * 0.1,
               "gru": gru_params(g, cfg.embed_dim, cfg.hidden)}
    rng = np.random.default_rng(5)
    docs = {f"doc{i}": rng.integers(0, cfg.vocab_size, size=PAPER_N)
            for i in range(64)}
    reqs = [(f"doc{int(rng.integers(0, 64))}",
             rng.standard_normal((int(rng.integers(1, PAPER_M + 1)),
                                  cfg.hidden)).astype(np.float32),
             int(rng.integers(0, 3))) for _ in range(512)]

    def serve_once(**kwargs):
        eng = LookupEngine(encoder, device=dev, **kwargs)
        for d, toks in docs.items():
            eng.ingest(d, toks)
        eng.flush()
        for d, q, p in reqs:
            eng.submit(d, q, priority=p)
        before = LU.mass_lookup_indexed.launches
        results = eng.run()
        torch.cuda.synchronize()
        return eng, results, LU.mass_lookup_indexed.launches - before

    kern, res_k, launches = serve_once(normalize=True)
    plain, res_p, plain_launches = serve_once(normalize=True,
                                              use_kernel=False)
    for key in kern.store:
        if not torch.equal(kern.store[key], plain.store[key]):
            raise AssertionError(f"phase 5: resident store {key!r} differs")
    st = kern.stats
    if not (st.lookup_dispatches == st.waves == launches) or plain_launches:
        raise AssertionError(f"phase 5: {st.waves} waves, "
                             f"{st.lookup_dispatches} dispatches, "
                             f"{launches} kernel launches "
                             f"({plain_launches} on the plain route)")
    if st.multi_memory_waves == 0:
        raise AssertionError("phase 5: no mixed-memory wave")
    err = 0.0
    for a, b in zip(res_k, res_p):
        if a.uid != b.uid or a.status != "ok" or b.status != "ok":
            raise AssertionError(f"phase 5: result {a.uid} vs {b.uid}")
        ta, tb = torch.from_numpy(a.answers), torch.from_numpy(b.answers)
        torch.testing.assert_close(ta, tb, rtol=LOOKUP_TOL, atol=LOOKUP_TOL)
        err = max(err, (ta - tb).abs().max().item())
    soft, res_s, _ = serve_once(backend="softmax")
    if not all(np.isfinite(r.answers).all() for r in res_s):
        raise AssertionError("phase 5: non-finite softmax answers")
    print(f"phase 5: paper-width slice (k={cfg.hidden}, 64 docs x "
          f"{PAPER_N} tokens, {len(reqs)} requests of 1-{PAPER_M} queries):"
          f" {st.waves} waves = {launches} kernel launches, "
          f"{st.multi_memory_waves} mixed-memory; stores bitwise equal, "
          f"max|Δanswer|={err:.3e} against use_kernel=False")
    print(f"  resident bytes: linear {kern.resident_bytes} "
          f"(N·(k²+k)·4), softmax {soft.resident_bytes} (Σnᵢ·k·4), "
          f"{soft.resident_bytes / kern.resident_bytes:.2f}x")


def lookup_main_path(dev, n_docs=8192, doc_len=750, n_queries=131072,
                     wave_size=256, n_sample=1024) -> dict:
    """Phase 6: ``serve --mode lookup`` at 8,192 × 750-token documents and
    two passes of 131,072 queries; returns the kernels' launches, the
    result and the busy share."""
    import numpy as np
    import torch
    from repro_torch.launch import serve

    args = serve.parse_args([
        "--mode", "lookup", "--n-docs", str(n_docs), "--doc-len",
        str(doc_len), "--n-queries", str(n_queries), "--wave-size",
        str(wave_size), "--seed", "0", "--device", dev.type])
    reset_launches()
    result = serve.lookup(args)
    launches = read_launches()
    n_waves = 2 * args.n_queries // args.wave_size
    if not (launches["mass_lookup_indexed"] == result["waves"] == n_waves
            == result["lookup_dispatches"]):
        raise AssertionError(f"phase 6: {launches} launches, "
                             f"{result['waves']} waves, "
                             f"{result['lookup_dispatches']} dispatches; "
                             f"want {n_waves} of each")
    if result["lookup_launches"] != n_waves // 2 or \
            result["multi_memory_waves"] == 0:
        raise AssertionError(f"phase 6: timed pass launched "
                             f"{result['lookup_launches']} times, "
                             f"{result['multi_memory_waves']} mixed waves")
    engine, doc_ids = result["engine"], result["doc_ids"]
    # the scratch row past the last document doubles the store
    if engine.store["c"].shape[0] != 1 << n_docs.bit_length():
        raise AssertionError(f"phase 6: store of {engine.store['c'].shape}")
    by_uid = {r.uid: r for r in engine.results()}
    rng = np.random.default_rng(0)
    sample = rng.choice(args.n_queries, size=n_sample, replace=False)
    got, want = [], []
    for i in sample:
        r = by_uid[result["timed_uid0"] + int(i)]
        doc = doc_ids[(int(i) * 7) % len(doc_ids)]
        if r.doc_id != doc or r.status != "ok":
            raise AssertionError(f"phase 6: request {i}: {r}")
        got.append(torch.from_numpy(r.answers[0]))
        q = torch.from_numpy(result["queries"][i]).to(dev)
        want.append((engine.store["c"][engine.rows()[doc]] @ q).cpu())
    got, want = torch.stack(got), torch.stack(want)
    torch.testing.assert_close(got, want, rtol=LOOKUP_TOL, atol=LOOKUP_TOL)
    if not torch.isfinite(got).all():
        raise AssertionError("phase 6: non-finite answers")
    err = (got - want).abs().max().item()
    print(f"phase 6: lookup main path lookups_per_s="
          f"{result['lookups_per_s']:.1f} serve_s={result['serve_s']:.4f} "
          f"ingest_s={result['ingest_s']:.3f} "
          f"resident_mib={result['resident_mib']:.1f} "
          f"(store {engine.store['c'].shape[0]} rows, "
          f"{engine.store['c'].nbytes / 2**20:.1f} MiB allocated); "
          f"mass_lookup_indexed.launches={launches['mass_lookup_indexed']}"
          f" = waves {result['waves']} (timed pass "
          f"{result['lookup_launches']}), "
          f"{result['multi_memory_waves']} mixed-memory waves; {n_sample} "
          f"sampled answers max|Δ|={err:.3e} against C q on the card")
    busy = profile_lookup_waves(engine, doc_ids, result["queries"])
    return dict(launches=launches, result=result, busy=busy)


def profile_decode(params, cfg, states, tok, pos, steps=4, kernel=None):
    """Device time by kernel over a few decode steps (torch.profiler),
    the ten largest rows and every row whose name holds ``kernel``;
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
    rows, host = profile_rows(prof)
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
    for i, (t, key, count) in enumerate(rows):
        if i < 10 or (kernel and kernel in key):
            print(f"    {100 * t / total:5.1f}%  {t / steps / 1e3:8.4f} "
                  f"ms/step  x{count // steps:<4d} {key[:90]}")
    return total / steps / 1e3


# B2/B3 against their plain versions, normwise: max|Δ| within the
# tolerance times max|plain| (fp32 sums of up to T·D terms in another
# order; bf16: the same fp32 sums rounded to bf16, two ulps of the max)
LA_TOL = {"float32": 1e-5, "bfloat16": 8e-3}


def la_rows(bh, t, d, dtype, gen, dev):
    """q, k positive (the model's elu1 feature map), v and do signed."""
    import torch
    r = lambda: torch.randn((bh, t, d), generator=gen, device=dev)  # noqa
    return [x.to(dtype) for x in (elu1(r()), elu1(r()), r(), r())]


def normwise(x, want, tol, what) -> float:
    """max|x - want|, checked against tol · max|want|."""
    err = (x.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    if not err <= tol * scale:
        raise AssertionError(f"{what}: max|Δ| {err:.3e} > {tol} x "
                             f"{scale:.3e}")
    return err


def check_linear_attention_rows(bh, t, d, dtype, chunk, gen, dev) -> dict:
    """B2 and B3 on flat rows against ``chunked_fwd_ref`` /
    ``chunked_bwd_ref``, and B3's two launches each on its own against
    ``chunked_bwd_dq_ref`` / ``chunked_bwd_dkv_ref``; every output in its
    input's type. Returns the largest |Δ| per kernel."""
    import torch
    from repro_torch.kernels.linear_attention import ops as LA, ref as LR
    q, k, v, do = la_rows(bh, t, d, dtype, gen, dev)
    o, s = LA.fwd(q, k, v, chunk=chunk)
    dq, dk, dv = LA.bwd(q, k, v, do, chunk=chunk)
    dq1 = LA.bwd_dq(k, v, do, chunk=chunk)
    dk1, dv1 = LA.bwd_dkv(q, k, v, do, chunk=chunk)
    torch.cuda.synchronize()
    o_r, s_r = LR.chunked_fwd_ref(q, k, v, chunk=chunk)
    dq_r, dk_r, dv_r = LR.chunked_bwd_ref(q, k, v, do, chunk=chunk)
    dq1_r = LR.chunked_bwd_dq_ref(k, v, do, chunk=chunk)
    dk1_r, dv1_r = LR.chunked_bwd_dkv_ref(q, k, v, do, chunk=chunk)
    name = str(dtype).split(".")[-1]
    tol = LA_TOL[name]
    tag = f"rows={bh} T={t} D={d} {name} chunk={chunk}"
    if any(x.dtype != dtype for x in (o, dq, dk, dv, dq1, dk1, dv1)):
        raise AssertionError(f"linear_attention {tag}: outputs not {dtype}")
    err = {"linear_attention_fwd": normwise(o, o_r, tol, f"o {tag}"),
           "linear_attention_bwd_dq": max(
               normwise(dq, dq_r, tol, f"dq {tag}"),
               normwise(dq1, dq1_r, tol, f"dq launch {tag}")),
           "linear_attention_bwd_dkv": max(
               normwise(dk, dk_r, tol, f"dk {tag}"),
               normwise(dv, dv_r, tol, f"dv {tag}"),
               normwise(dk1, dk1_r, tol, f"dk/dv launch dk {tag}"),
               normwise(dv1, dv1_r, tol, f"dk/dv launch dv {tag}"))}
    # a transposed state would show: S is far from symmetric
    asym = ((s_r - s_r.mT).abs().max() / s_r.abs().max()).item()
    if not asym > 100 * LA_TOL["float32"]:
        raise AssertionError(f"state {tag}: too near symmetric ({asym:.3e})")
    s_err = normwise(s, s_r, LA_TOL["float32"], f"state {tag}")
    o_rel = err["linear_attention_fwd"] / o_r.float().abs().max().item()
    print(f"  linear_attention {tag}: max|Δo|="
          f"{err['linear_attention_fwd']:.3e} ({o_rel:.2e} of max|o|) "
          f"max|ΔS|={s_err:.3e} ({s_err / s_r.abs().max().item():.2e} of "
          f"max|S|; |S - Sᵀ| {asym:.2f} max|S|) max|Δdq|="
          f"{err['linear_attention_bwd_dq']:.3e} max|Δdk,dv|="
          f"{err['linear_attention_bwd_dkv']:.3e} (through ops.bwd and each "
          f"launch alone; normwise tol {tol})")
    return err


def check_linear_attention_wrapper(t, d, dtype, chunk, gen, dev) -> None:
    """(B, H, T, D) through ``ops.linear_attention`` (padding to the
    chunk, the autograd function) and ``linear_attention_with_state``,
    kernel route against ``kernel=False``: o, the state and the three
    gradients."""
    import torch
    from repro_torch.kernels.linear_attention import ops as LA
    q, k, v, do = (x.reshape(2, 3, t, d)
                   for x in la_rows(6, t, d, dtype, gen, dev))
    out = {}
    for kernel in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = LA.linear_attention(*leaves, chunk=chunk, kernel=kernel)
        o.backward(do)
        _, s = LA.linear_attention_with_state(q, k, v, chunk=chunk,
                                              kernel=kernel)
        out[kernel] = [o.detach(), s] + [x.grad for x in leaves]
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tag = f"B=2 H=3 T={t} D={d} {name} chunk={chunk}"
    errs = [normwise(a, b, LA_TOL["float32" if i == 1 else name],
                     f"wrapper {tag} output {i}")
            for i, (a, b) in enumerate(zip(out[True], out[False]))]
    print(f"  linear_attention wrapper {tag} (padded to "
          f"{-(-t // min(chunk, t)) * min(chunk, t)} when T % chunk): "
          f"max|Δ| o {errs[0]:.3e}, S {errs[1]:.3e}, dq {errs[2]:.3e}, "
          f"dk {errs[3]:.3e}, dv {errs[4]:.3e} against kernel=False")


def check_linear_attention_autograd(gen, dev) -> None:
    """The autograd function (B2 forward, B3 backward) against autograd
    through the quadratic direct form, fp32, T = 37."""
    from repro_torch.kernels.linear_attention import ops as LA, ref as LR
    import torch
    q, k, v, do = (x.reshape(1, 4, 37, 16)
                   for x in la_rows(4, 37, 16, torch.float32, gen, dev))
    got, want = [], []
    for fn, sink in ((lambda a, b, c: LA.linear_attention(a, b, c, chunk=16),
                      got),
                     (lambda a, b, c: LR.linear_attention_ref(
                         a[0], b[0], c[0])[0][None], want)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        o = fn(*leaves)
        o.backward(do)
        sink.extend([o.detach()] + [x.grad for x in leaves])
    errs = [normwise(a, b, LA_TOL["float32"], "autograd")
            for a, b in zip(got, want)]
    print(f"  linear_attention autograd function vs autograd of the direct "
          f"form (fp32, T=37): max|Δ| o, dq, dk, dv = "
          f"{', '.join(f'{e:.3e}' for e in errs)}")


def time_linear_attention(bh, t, d, chunk, gen, dev) -> dict:
    """B2, B3-dq, B3-dkv and B3 as a whole (``ops.bwd``, both launches) at
    the training main path's shape (bf16), with their plain versions, from
    CUDA-graph replays. The inputs (4 x 33.5 MB at the main shape) exceed
    the 50 MB L2. Bounds: each input read once and each output written
    once over 3.35 TB/s, or the operations the function needs over the
    bf16 tensor-core rate (``fp32_bound_ms``: over 67 TFLOP/s, the rate
    of the fp32 routes' FMAs). The least work is the scan form's: each
    rank-one update of the D x D state and each product with it costs 2D²
    per token; B2 and dq do two per token (S += k vᵀ, then q S), dk/dv
    three (R += q doᵀ, then v R and k R), B3 five. The chunked forms the
    kernels and the Pallas functions run do more."""
    import torch
    from repro_torch.kernels.linear_attention import ops as LA, ref as LR
    q, k, v, do = la_rows(bh, t, d, torch.bfloat16, gen, dev)
    x_bytes = q.nbytes
    state_bytes = bh * d * d * 4
    per_product = bh * t * 2 * d * d
    out = {}
    for name, kern, plain, n_bytes, n_products in (
            ("linear_attention_fwd",
             lambda i: LA.fwd(q, k, v, chunk=chunk),
             lambda i: LR.chunked_fwd_ref(q, k, v, chunk=chunk),
             4 * x_bytes + state_bytes, 2),
            ("linear_attention_bwd_dq",
             lambda i: LA.bwd_dq(k, v, do, chunk=chunk),
             lambda i: LR.chunked_bwd_dq_ref(k, v, do, chunk=chunk),
             4 * x_bytes, 2),
            ("linear_attention_bwd_dkv",
             lambda i: LA.bwd_dkv(q, k, v, do, chunk=chunk),
             lambda i: LR.chunked_bwd_dkv_ref(q, k, v, do, chunk=chunk),
             6 * x_bytes, 3),
            ("bwd",
             lambda i: LA.bwd(q, k, v, do, chunk=chunk),
             lambda i: LR.chunked_bwd_ref(q, k, v, do, chunk=chunk),
             7 * x_bytes, 5)):
        out[name] = dict(ms=graph_ms(kern, 4, replays=5),
                         plain_ms=graph_ms(plain, 2, replays=3),
                         library_ms=None, fp32_bound_ms=bound(
                             n_bytes, n_products * per_product)["bound_ms"],
                         **bound(n_bytes, n_products * per_product,
                                 PEAK_BF16_TC_FLOPS))
    # two sweeps (a forward one for dq, a reverse one for dk and dv) each
    # read their inputs and write their outputs: 4 + 6 tensors
    out["bwd"]["two_sweep_bytes"] = 10 * x_bytes
    out["bwd"]["two_sweep_ms"] = bound(10 * x_bytes, 0.0)["bound_ms"]
    return out


def gla_rows(bh, t, d, dtype, decay, gen, dev):
    """q, k positive (elu1), v and do signed (``la_rows``), and an fp32
    log-decay g: the model's operating point (b_gate 4, decay_temp 8:
    g ≈ -0.002; drawn in [-0.004, 0]), mild ([-0.6, 0] with 3% of the
    entries past the clamp at -1.5) or the clamp itself (-1)."""
    import torch
    q, k, v, do = la_rows(bh, t, d, dtype, gen, dev)
    u = torch.rand((bh, t, d), generator=gen, device=dev)
    g = {"model": -0.004 * u, "mild": torch.where(u < 0.03, -1.5, -0.6 * u),
         "clamp": torch.full_like(u, -1.0)}[decay]
    return q, k, v, do, g


def check_gla_rows(bh, t, d, dtype, chunk, decay, gen, dev) -> dict:
    """B8 (inclusive, and exclusive with the bonus u) and B9 on flat rows
    against ``chunked_fwd_ref`` / ``chunked_bwd_ref``, normwise, and B9's
    two launches on their own: the dq launch's (dq, q⊙dq) against
    ``bwd_dq_ref``, the dk/dv launch's (dk, dv; dg in fp32) against
    ``bwd_dkv_dg_ref`` given the same q⊙dq. Every output in its type.
    Returns the largest |Δ| per kernel."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.gated_linear_attention import ref as GR
    q, k, v, do, g = gla_rows(bh, t, d, dtype, decay, gen, dev)
    u = torch.linspace(-1.0, 1.0, d, device=dev)
    o, s = GL.fwd(q, k, v, g, chunk=chunk)
    o_x, s_x = GL.fwd(q, k, v, g, u=u, chunk=chunk, exclusive=True)
    grads = GL.bwd(q, k, v, g, do, chunk=chunk)
    dq, qdq = GL.bwd_dq(q, k, v, g, do, chunk=chunk)
    dkv = GL.bwd_dkv(q, k, v, g, do, qdq, chunk=chunk)
    torch.cuda.synchronize()
    o_r, s_r = GR.chunked_fwd_ref(q, k, v, g, chunk=chunk)
    o_xr, s_xr = GR.chunked_fwd_ref(q, k, v, g, u=u, chunk=chunk,
                                    exclusive=True)
    grads_r = GR.chunked_bwd_ref(q, k, v, g, do, chunk=chunk)
    dq_r, qdq_r = GR.bwd_dq_ref(q, k, v, g, do, chunk=chunk)
    dkv_r = GR.bwd_dkv_dg_ref(q, k, v, g, do, qdq, chunk=chunk)
    name = str(dtype).split(".")[-1]
    tol, tol32 = LA_TOL[name], LA_TOL["float32"]
    tag = f"rows={bh} T={t} D={d} {name} chunk={chunk} decay={decay}"
    for what, x, x_r in zip(("dq", "dk", "dv", "dg", "q⊙dq"),
                            grads + (qdq,), grads_r + (qdq_r,)):
        if x.dtype != x_r.dtype:
            raise AssertionError(f"{what} {tag}: {x.dtype}, want "
                                 f"{x_r.dtype}")
    e = {n: normwise(x, x_r, tol, f"{n} {tag}") for n, x, x_r in zip(
        ("dq", "dk", "dv", "dg"), grads, grads_r)}
    e1 = {n: normwise(x, x_r, tol, f"dq launch {n} {tag}") for n, x, x_r in
          zip(("dq", "q⊙dq"), (dq, qdq), (dq_r, qdq_r))}
    # The dk/dv launch alone, given the dq launch's q⊙dq: dk and dv, and
    # dg in fp32 only. In bf16 that q⊙dq carries the rounding of Q̂ which
    # only the same launch pair's k⊙dk cancels, so there dg is held to
    # its plain version through both launches (bwd, above).
    n2 = ("dk", "dv", "dg") if dtype == torch.float32 else ("dk", "dv")
    e2 = {n: normwise(x, x_r, tol, f"dk/dv launch {n} {tag}") for n, x, x_r
          in zip(n2, dkv, dkv_r)}
    err = {"gated_linear_attention_fwd": max(
               normwise(o, o_r, tol, f"o {tag}"),
               normwise(o_x, o_xr, tol, f"o exclusive {tag}")),
           "gated_linear_attention_bwd_dq": max(e["dq"], *e1.values()),
           "gated_linear_attention_bwd_dkv": max(e["dk"], e["dv"], e["dg"],
                                                 *e2.values())}
    # a transposed state would show: S is far from symmetric
    asym = ((s_r - s_r.mT).abs().max() / s_r.abs().max()).item()
    if not asym > 100 * tol32:
        raise AssertionError(f"state {tag}: too near symmetric ({asym:.3e})")
    s_err = max(normwise(s, s_r, tol32, f"state {tag}"),
                normwise(s_x, s_xr, tol32, f"state exclusive {tag}"))
    print(f"  gated_linear_attention {tag}: max|Δo| (incl, excl+u)="
          f"{err['gated_linear_attention_fwd']:.3e} max|ΔS|={s_err:.3e} "
          f"(|S - Sᵀ| {asym:.2f} max|S|); "
          f"bwd max|Δ| " + ", ".join(f"{n} {x:.3e}" for n, x in e.items())
          + "; dq launch " + ", ".join(f"{n} {x:.3e}" for n, x in e1.items())
          + "; dk/dv launch " + ", ".join(f"{n} {x:.3e}" for n, x in
                                         e2.items())
          + f" (normwise tol {tol})")
    return err


def check_gla_wrapper(t, d, dtype, chunk, scalar, gen, dev) -> None:
    """(B, H, T, D) through ``gated_linear_attention`` (g broadcast,
    padding to the chunk, the autograd function) and ``rwkv6_attention``,
    kernel route against ``kernel=False``: o, the four gradients, and
    the exclusive o and state."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    q, k, v, do, g = (x.reshape(2, 3, t, d) for x in gla_rows(
        6, t, d, dtype, "mild", gen, dev))
    if scalar:
        g = g[..., :1].contiguous()
    u = torch.linspace(-1.0, 1.0, d, device=dev)
    out = {}
    for kernel in (True, False):
        leaves = [x.clone().requires_grad_() for x in (q, k, v, g)]
        o = GL.gated_linear_attention(*leaves, chunk=chunk, kernel=kernel)
        o.backward(do)
        o_x, s_x = GL.rwkv6_attention(q, k, v, g, u, chunk=chunk,
                                      kernel=kernel)
        out[kernel] = [o.detach()] + [x.grad for x in leaves] + [o_x, s_x]
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    tag = (f"B=2 H=3 T={t} D={d} {name} chunk={chunk} "
           f"{'per-head' if scalar else 'vector'} decay")
    names = ("o", "dq", "dk", "dv", "dg", "o excl", "S excl")
    errs = [normwise(a, b, LA_TOL["float32" if n == "S excl" else name],
                     f"gated wrapper {tag} {n}")
            for n, a, b in zip(names, out[True], out[False])]
    print(f"  gated_linear_attention wrapper {tag}: max|Δ| "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
          + " against kernel=False")


def check_gla_clamp(dtype, gen, dev, lo=-1.0) -> None:
    """g ≡ lo = min_log_decay (−1: the default clamp; or the route's
    ``DECAY_LIMIT``), T = 1,024, chunk 128: B8 and B9 through the autograd
    function, all finite and within normwise 1e-5 (fp32) or 8e-3 (bf16)
    of ``gla_scan`` and its autograd gradients, evaluated in fp32 on the
    same values (the chunk-128 plain version is NaN there, as JAX's
    is)."""
    import torch
    from repro_torch.core.gated import gla_scan
    from repro_torch.kernels.gated_linear_attention import ops as GL
    q, k, v, do, g = (x.reshape(1, 2, 1024, 128) for x in gla_rows(
        2, 1024, 128, dtype, "clamp", gen, dev))
    g = g * -lo
    got, want = [], []
    for fn, sink, cast in ((lambda a, b, c, e: GL.gated_linear_attention(
            a, b, c, e, chunk=128, min_log_decay=lo), got, dtype),
            (lambda a, b, c, e: gla_scan(a, b, c, e)[0], want,
             torch.float32)):
        leaves = [x.to(cast).clone().requires_grad_() for x in (q, k, v, g)]
        o = fn(*leaves)
        o.backward(do.to(cast))
        sink.extend([o.detach()] + [x.grad for x in leaves])
    torch.cuda.synchronize()
    names = ("o", "dq", "dk", "dv", "dg")
    name = str(dtype).split(".")[-1]
    for n, a in zip(names, got):
        if not torch.isfinite(a).all():
            raise AssertionError(f"gated clamp {name}: non-finite {n}")
    errs = [normwise(a, b, LA_TOL[name], f"gated clamp {name} {n}")
            for n, a, b in zip(names, got, want)]
    plain = GL.gated_linear_attention(q, k, v, g, chunk=128,
                                      min_log_decay=lo, kernel=False)
    nan_share = torch.isnan(plain).float().mean().item()
    print(f"  gated_linear_attention at the clamp (g = min_log_decay = {lo}, "
          f"T=1024, chunk 128, {name}): all finite; max|Δ| against gla_scan "
          f"and its "
          f"autograd in fp32 " + ", ".join(f"{n} {e:.3e}" for n, e in
                                           zip(names, errs))
          + f" (normwise {LA_TOL[name]}); the chunk-128 plain version: "
          f"{100 * nan_share:.1f}% of o NaN")


def check_decay_limit(gen, dev) -> None:
    """Each route at its ``DECAY_LIMIT`` (bf16 −1.25, fp32 −1.5) with g
    held there (``check_gla_clamp``), and a CUDA call of ``fwd``,
    ``bwd_dq`` and ``bwd_dkv`` just past it refused with ValueError."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    for dtype in (torch.bfloat16, torch.float32):
        lo = GL.DECAY_LIMIT[dtype]
        check_gla_clamp(dtype, gen, dev, lo=lo)
        q, k, v, do, g = gla_rows(2, 64, 16, dtype, "mild", gen, dev)
        qdq = torch.zeros_like(g)
        for fn in (lambda m: GL.fwd(q, k, v, g, chunk=16, min_log_decay=m),
                   lambda m: GL.bwd_dq(q, k, v, g, do, chunk=16,
                                       min_log_decay=m),
                   lambda m: GL.bwd_dkv(q, k, v, g, do, qdq, chunk=16,
                                        min_log_decay=m)):
            try:
                fn(lo - 1e-3)
            except ValueError:
                continue
            raise AssertionError(f"min_log_decay {lo - 1e-3} past the "
                                 f"{dtype} limit {lo} was not refused")
    print(f"  min_log_decay past the limits ({GL.DECAY_LIMIT[torch.bfloat16]}"
          f" bf16, {GL.DECAY_LIMIT[torch.float32]} fp32) refused by fwd, "
          f"bwd_dq and bwd_dkv")


def time_gated_linear_attention(bh, t, d, chunk, gen, dev) -> dict:
    """B8, B9-dq and B9-dkv at the gated training main path's shape (bf16
    q, k, v, do; fp32 g at the model's decay), with their plain versions,
    from CUDA-graph replays; B9 as a whole (``ops.bwd``, both launches)
    and the eager dg epilogue that B9 ran after them before its dk/dv
    launch formed dg (``ref.dg_epilogue`` and the casts of dq and dk to
    bf16). Bounds as ``time_linear_attention``'s: the scan form's 2·T·D²
    per row for each state update or product (two for B8 and dq, three
    for dk/dv, five for B9) plus one exp per decay element, over the bf16
    tensor-core rate (``fp32_bound_ms``: over 67 TFLOP/s), or each input
    read once and each output written once (the fp32 g, q⊙dq and dg at
    four bytes) over 3.35 TB/s."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.gated_linear_attention import ref as GR
    q, k, v, do, g = gla_rows(bh, t, d, torch.bfloat16, "model", gen, dev)
    _, qdq = GL.bwd_dq(q, k, v, g, do, chunk=chunk)
    x_bytes, f_bytes = q.nbytes, g.nbytes
    state_bytes = bh * d * d * 4
    per_product = bh * t * 2 * d * d
    n_exp = bh * t * d
    out = {}
    for name, kern, plain, n_bytes, n_products in (
            ("gated_linear_attention_fwd",
             lambda i: GL.fwd(q, k, v, g, chunk=chunk),
             lambda i: GR.chunked_fwd_ref(q, k, v, g, chunk=chunk),
             4 * x_bytes + f_bytes + state_bytes, 2),
            ("gated_linear_attention_bwd_dq",
             lambda i: GL.bwd_dq(q, k, v, g, do, chunk=chunk),
             lambda i: GR.bwd_dq_ref(q, k, v, g, do, chunk=chunk),
             5 * x_bytes + 2 * f_bytes, 2),
            ("gated_linear_attention_bwd_dkv",
             lambda i: GL.bwd_dkv(q, k, v, g, do, qdq, chunk=chunk),
             lambda i: GR.bwd_dkv_dg_ref(q, k, v, g, do, qdq, chunk=chunk),
             6 * x_bytes + 3 * f_bytes, 3),
            ("bwd",
             lambda i: GL.bwd(q, k, v, g, do, chunk=chunk),
             lambda i: GR.chunked_bwd_ref(q, k, v, g, do, chunk=chunk),
             7 * x_bytes + 2 * f_bytes, 5)):
        ops = n_products * per_product + n_exp
        out[name] = dict(ms=graph_ms(kern, 4, replays=5),
                         plain_ms=graph_ms(plain, 2, replays=3),
                         library_ms=None,
                         fp32_bound_ms=bound(n_bytes, ops)["bound_ms"],
                         **bound(n_bytes, ops, PEAK_BF16_TC_FLOPS))
    dq32 = GR.chunked_bwd_dq_ref(k, v, g, do, chunk=chunk)
    dk32, _ = GR.chunked_bwd_dkv_ref(q, k, v, g, do, chunk=chunk)
    out["old_epilogue_ms"] = graph_ms(
        lambda i: (GR.dg_epilogue(q, k, g, dq32, dk32), dq32.to(q.dtype),
                   dk32.to(k.dtype)), 4, replays=5)
    return out


def check_flash_attention(bh, t, s, d, dtype, gen, dev, t_off=None,
                          s_real=None, kv_heads=None, heads=None) -> float:
    """B10 on rows against its plain version: fp32 within 1e-5 (the same
    fp32 sums in another order), bf16 within normwise 8e-3 and JAX's
    kernel tests' 2e-2 elementwise (P and the output rounded to bf16);
    with ``kv_heads``, k and v have bh / heads · kv_heads rows, read by kv
    head. In the oracle's domain (the queries the last T keys) also
    against ``flash_attention_ref`` on K/V broadcast to the q rows, at the
    same tolerance, the oracle evaluated in fp32 on the same values: in
    bf16 it rounds the scores to bf16 before the softmax, which moves a
    logit by up to 2^-9 of the raw score, as far from the exact function
    as the tolerance; its own distance from the plain version is printed.
    Returns the largest |Δo| against the plain version."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FR
    kv_rows = bh if kv_heads is None else bh // heads * kv_heads
    q, k, v = (torch.randn((n_r, n, d), generator=gen, device=dev).to(dtype)
               for n_r, n in ((bh, t), (kv_rows, s), (kv_rows, s)))
    o = FA.fwd(q, k, v, t_off=t_off, s_real=s_real, kv_heads=kv_heads)
    torch.cuda.synchronize()
    o_r = FA.fwd(q, k, v, t_off=t_off, s_real=s_real, kv_heads=kv_heads,
                 kernel=False)
    name = str(dtype).split(".")[-1]
    tag = (f"rows={bh} kv_rows={kv_rows} T={t} S={s} D={d} {name} t_off="
           f"{s - t if t_off is None else t_off} s_real="
           f"{s if s_real is None else s_real}")
    wants = [("plain version", o_r)]
    tag_bf16 = ""
    if t_off is None and s_real is None:
        hkv = kv_heads or 1
        kb, vb = (x.reshape(-1, 1, hkv, s, d)
                  .expand(-1, bh // kv_rows, -1, -1, -1).reshape(bh, s, d)
                  for x in (k, v))
        wants.append(("oracle", FR.flash_attention_ref(
            q.float(), kb.float(), vb.float())))
        if dtype != torch.float32:
            in_bf16 = FR.flash_attention_ref(q, kb, vb)
            tag_bf16 = (f", the oracle evaluated in bf16 "
                        f"{(in_bf16.float() - o_r.float()).abs().max():.3e}"
                        f" from the plain version")
    errs = []
    for what, want in wants:
        if dtype == torch.float32:
            torch.testing.assert_close(o, want, rtol=1e-5, atol=1e-5,
                                       msg=f"{tag} against the {what}")
        else:
            normwise(o, want, LA_TOL[name],
                     f"flash_attention {tag} against the {what}")
            torch.testing.assert_close(o.float(), want.float(), rtol=2e-2,
                                       atol=2e-2,
                                       msg=f"{tag} against the {what}")
        errs.append(f"{(o.float() - want.float()).abs().max().item():.3e} "
                    f"against the {what}")
    print(f"  flash_attention_fwd {tag}: max|Δo| " + ", ".join(errs)
          + tag_bf16)
    return (o.float() - o_r.float()).abs().max().item()


def check_flash_wrapper(b, h, hkv, t, s, dtype, gen, dev) -> None:
    """(B, H, T, D = 128) q and (B, Hkv, S, D) k, v through
    ``ops.flash_attention`` (padding T and S to the JAX wrapper's tiles),
    kernel route against ``kernel=False``."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    q, k, v = (torch.randn((b, n_h, n, 128), generator=gen, device=dev).to(
        dtype) for n_h, n in ((h, t), (hkv, s), (hkv, s)))
    o = FA.flash_attention(q, k, v)
    o_r = FA.flash_attention(q, k, v, kernel=False)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_r.float(), rtol=tol, atol=tol)
    print(f"  flash_attention wrapper B={b} H={h} Hkv={hkv} T={t} S={s} "
          f"D=128 {str(dtype).split('.')[-1]}: max|Δo|="
          f"{(o.float() - o_r.float()).abs().max().item():.3e} against "
          f"kernel=False")


def time_flash_attention(b, h, hkv, t, d, gen, dev, n_bufs=4) -> dict:
    """B10 at the prefill main path's shape (B·H q rows over B·Hkv kv
    rows, T = S, bf16, causal, t_off 0), its plain version, and the
    library call ``scaled_dot_product_attention(is_causal=True,
    enable_gqa=True)`` on the same inputs, from CUDA-graph replays over
    ``n_bufs`` input sets (beyond the 50 MB L2). SDPA's grouped heads map
    q head h to kv head h // G where B10's map it to h mod Hkv, so SDPA
    gets q's heads permuted to (Hkv, G) order and its output is permuted
    back before the comparison. Bounds: q, o and k, v once over the
    memory rate, or the causal pairs' 4·D operations each (q·k and p·v)
    over the bf16 tensor-core rate (``bound_ms``) or the fp32 rate
    (``fp32_bound_ms``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attention import ops as FA
    g = h // hkv
    sets = [[torch.randn((b, n_h, t, d), generator=gen, device=dev).to(
        torch.bfloat16) for n_h in (h, hkv, hkv)] for _ in range(n_bufs)]
    rows = [[x.reshape(-1, t, d) for x in xs] for xs in sets]
    # SDPA's order: its q head j·G + g is the port's head g·Hkv + j
    lib_q = [xs[0].reshape(b, g, hkv, t, d).transpose(1, 2).reshape(
        b, h, t, d) for xs in sets]
    o = FA.fwd(*rows[0], kv_heads=hkv)
    lib = F.scaled_dot_product_attention(lib_q[0], *sets[0][1:],
                                         is_causal=True, enable_gqa=True)
    lib = lib.reshape(b, hkv, g, t, d).transpose(1, 2).reshape(b * h, t, d)
    lib_err = (o.float() - lib.float()).abs().max()
    flops = b * h * (t * (t + 1) // 2) * 4 * d
    n_bytes = 2 * sets[0][0].nbytes + 2 * sets[0][1].nbytes   # q, o, k, v
    out = dict(
        ms=graph_ms(lambda i: FA.fwd(*rows[i % n_bufs], kv_heads=hkv),
                    2 * n_bufs, replays=5),
        plain_ms=graph_ms(lambda i: FA.fwd(*rows[i % n_bufs], kv_heads=hkv,
                                           kernel=False), 2, replays=3),
        library_ms=graph_ms(lambda i: F.scaled_dot_product_attention(
            lib_q[i % n_bufs], *sets[i % n_bufs][1:], is_causal=True,
            enable_gqa=True), 2 * n_bufs, replays=5),
        library_max_abs_diff=lib_err.item(),
        fp32_bound_ms=bound(n_bytes, flops)["bound_ms"],
        **bound(n_bytes, flops, PEAK_BF16_TC_FLOPS))
    del sets, rows, lib_q
    torch.cuda.empty_cache()
    return out


def wrapper_host_us(b, h, hkv, t, d, gen, dev, n=50) -> tuple:
    """Host time per call of B10's wrapper at the prefill's shape (the
    calls enqueued back to back, no synchronisation inside), and of one
    ``Path.resolve()`` of its source, which ``build.load_library`` no
    longer makes at every launch; both in µs."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    q = torch.randn((b * h, t, d), generator=gen, device=dev).bfloat16()
    k, v = (torch.randn((b * hkv, t, d), generator=gen, device=dev
                        ).bfloat16() for _ in range(2))
    FA.fwd(q, k, v, kv_heads=hkv)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        FA.fwd(q, k, v, kv_heads=hkv)
    host = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        FA.SOURCE.resolve()
    return host, (time.perf_counter() - t0) / n * 1e6


def profile_prefill(params, cfg, prompt, kernel) -> None:
    """Device time by kernel over one prefill (torch.profiler): the ten
    largest rows and every row whose name holds ``kernel``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        lm.prefill(params, prompt, cfg)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, _ = profile_rows(prof)
    total = sum(t for t, _, _ in rows)
    if not total:
        print("  prefill profile: the profiler reported no device time "
              "(not measured)")
        return
    print(f"  prefill profile: {total / 1e3:.3f} ms device time in one "
          f"prefill, {wall_ms:.3f} ms wall under the profiler (busy "
          f"{100 * total / 1e3 / wall_ms:.1f}%)")
    for i, (t, key, count) in enumerate(rows):
        if i < 10 or kernel in key:
            print(f"    {100 * t / total:5.1f}%  {t / 1e3:8.4f} ms  "
                  f"x{count:<4d} {key[:90]}")


def launch_counters() -> dict:
    """Every kernel wrapper of the port, by kernel name: each adds one to
    its ``launches`` where it launches its kernel."""
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.fused_recurrent import ops
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.linear_attention import ops as LA
    from repro_torch.kernels.lookup import ops as LU
    return {"decode_linear": ops.decode_linear,
            "decode_gated": ops.decode_gated,
            "mass_lookup_indexed": LU.mass_lookup_indexed,
            "mass_lookup": LU.mass_lookup, "fused_decode": LU.fused_decode,
            "linear_attention_fwd": LA.fwd,
            "linear_attention_bwd_dq": LA.bwd_dq,
            "linear_attention_bwd_dkv": LA.bwd_dkv,
            "gated_linear_attention_fwd": GL.fwd,
            "gated_linear_attention_bwd_dq": GL.bwd_dq,
            "gated_linear_attention_bwd_dkv": GL.bwd_dkv,
            "flash_attention_fwd": FA.fwd}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


DECODE_KERNEL = {"linear": "decode_linear", "gated_linear": "decode_gated"}


def slice_kernel_vs_reference(backend, dev, phase) -> None:
    """Phases 3 and 7: a 2-layer model at qwen3-0.6b's full widths in fp32,
    prefill + 16 greedy steps through the backend's decode kernel against
    the same through ``decode_kernel="reference"``: greedy tokens
    identical, logits within 1e-4, the kernel launched once per layer and
    step on the kernel route and never on the reference route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    name = DECODE_KERNEL[backend]
    counter = launch_counters()[name]
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").with_backend(backend), n_layers=2,
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    runs = {}
    for kernel in ("auto", "reference"):
        c = dataclasses.replace(cfg, decode_kernel=kernel)
        before = counter.launches
        logits, st = lm.prefill(params, prompt, c)
        tok = lm.sample_token(logits, 0.0)
        all_logits, toks = [logits], [tok]
        for i in range(16):
            logits, st = lm.decode_step(params, st, tok, 64 + i, c)
            tok = lm.sample_token(logits, 0.0)
            all_logits.append(logits)
            toks.append(tok)
        launched = counter.launches - before
        want = 16 * cfg.n_layers if kernel == "auto" else 0
        if launched != want:
            raise AssertionError(f"phase {phase}: {name} launched {launched}"
                                 f" times on the {kernel} route, want {want}")
        runs[kernel] = (torch.stack(all_logits), torch.stack(toks))
    torch.testing.assert_close(runs["auto"][0], runs["reference"][0],
                               rtol=1e-4, atol=1e-4)
    if not torch.equal(runs["auto"][1], runs["reference"][1]):
        raise AssertionError(f"phase {phase}: greedy tokens differ")
    if not torch.isfinite(runs["auto"][0]).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    d_logit = (runs["auto"][0] - runs["reference"][0]).abs().max().item()
    print(f"phase {phase}: {backend} 2-layer full-width fp32 slice, prefill "
          f"+ 16 greedy steps: tokens identical, max|Δlogit|={d_logit:.3e}, "
          f"{name} launched {16 * cfg.n_layers} times")


def generate_main_path(backend, dev, gen, phase) -> dict:
    """Phases 4 and 8: ``serve --mode generate --backend <backend>`` on the
    full 28-layer qwen3-0.6b in bf16 (random weights from seed 0), batch
    8, prompt 512, 64 generated tokens, with every kernel's launch count
    set to 0 just before and read just after; then a profile of a few
    decode steps and the decode kernel timed. Returns the kernel's record
    for the kernels line (without ``max_abs_err``)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    name = DECODE_KERNEL[backend]
    args = serve.parse_args(["--arch", "qwen3-0.6b", "--backend", backend,
                             "--batch", "8", "--prompt-len", "512",
                             "--gen-len", "64", "--seed", "0"])
    full = get_config(args.arch).with_backend(backend)
    reset_launches()
    result = serve.generate(args)
    launches = read_launches()
    # the timed generation launches once per layer and token; the
    # entry point's untimed warm-up adds two decode steps
    want = full.n_layers * (args.gen_len - 1)
    if result["decode_launches"] != want:
        raise AssertionError(f"phase {phase}: {name} launched "
                             f"{result['decode_launches']} times in the "
                             f"timed generation, want {want}")
    if launches[name] != want + 2 * full.n_layers:
        raise AssertionError(f"phase {phase}: {name} launched "
                             f"{launches[name]} times in the run, want "
                             f"{want + 2 * full.n_layers}")
    others = {k: n for k, n in launches.items() if k != name and n}
    if others:
        raise AssertionError(f"phase {phase}: other kernels launched: "
                             f"{others}")
    toks = result["tokens"]
    if toks.shape != (args.batch, args.gen_len) or not (
            (toks >= 0) & (toks < full.vocab_size)).all():
        raise AssertionError(f"phase {phase}: bad generated tokens")
    # fixed-size state: s per layer, batch row and head, plus z for the
    # normalised linear backend only
    z_cols = 1 if backend == "linear" and full.linear_normalize else 0
    state_bytes = (full.n_layers * args.batch * full.n_heads
                   * full.head_dim * (full.head_dim + z_cols) * 4)
    if result["state_mib"] != state_bytes / 2**20:
        raise AssertionError(f"phase {phase}: decode state "
                             f"{result['state_mib']} MiB, want "
                             f"{state_bytes / 2**20}")
    print(f"phase {phase}: {backend} main path "
          f"prefill_ms={result['prefill_ms']:.3f} "
          f"decode_ms_per_token={result['decode_ms_per_token']:.4f} "
          f"tok_s={result['tokens_per_s']:.1f} "
          f"state_mib={result['state_mib']:.1f} "
          f"{name}.launches={launches[name]} (timed generation "
          f"{result['decode_launches']} = {full.n_layers} x "
          f"{args.gen_len - 1}, warm-up {full.n_layers} x 2)")

    # where a decode step's device time goes (bf16, full model)
    params = lm.cast_params(
        lm.init_params(torch.Generator(device=dev).manual_seed(0), full),
        torch.bfloat16)
    prompt = torch.randint(0, full.vocab_size, (args.batch, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    logits, st = lm.prefill(params, prompt, full)
    device_ms = profile_decode(params, full, st, torch.argmax(logits, -1),
                               64, kernel=f"{name}_kernel")
    if not torch.isfinite(logits).all() or not all(
            torch.isfinite(t).all() for group in st.values()
            for layer in group for t in layer if t is not None):
        raise AssertionError(f"phase {phase}: non-finite logits or state")
    if device_ms is not None:
        busy = device_ms / result["decode_ms_per_token"]
        print(f"  device busy {100 * busy:.1f}% of a decode step "
              f"({device_ms:.3f} ms device time per step over "
              f"{result['decode_ms_per_token']:.3f} ms per token)")
    del params, st

    timer = {"linear": time_decode_linear,
             "gated_linear": time_decode_gated}[backend]
    t = timer(args.batch * full.n_heads, full.head_dim, gen, dev)
    print(f"{name} N={args.batch * full.n_heads} D={full.head_dim} W=1 "
          f"bf16: {t['ms'] * 1e3:.2f} us/launch (plain version "
          f"{t['plain_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.2f} us"
          f" by {t['bound_by']}, {t['bytes'] / 1e6:.2f} MB moved)")
    torch.cuda.empty_cache()
    line = {"linear": 239, "gated_linear": 303}[backend]
    return {"name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/fused_recurrent/csrc/"
                      f"{name}.cu",
            "replaces": f"src/repro/kernels/fused_recurrent/kernel.py:{line}",
            "launches": launches[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None}


# each trained backend's attention kernels: forward, dq, dk/dv; their IDs;
# the Pallas lines they replace; what their CUDA kernels' names share; the
# CUDA kernel each runs in bf16 (its route: tensor cores or FMAs)
TRAIN_KERNELS = {
    "linear": (("linear_attention_fwd", "linear_attention_bwd_dq",
                "linear_attention_bwd_dkv"), ("B2", "B3-dq", "B3-dkv"),
               "linear_attention/kernel.py", (71, 158, 177), "sweep",
               ("linear_sweep_fwd_tc (bf16 tensor cores)",
                "linear_sweep_dq_tc (bf16 tensor cores)",
                "linear_sweep_dkv_tc (bf16 tensor cores)")),
    "gated_linear": (("gated_linear_attention_fwd",
                      "gated_linear_attention_bwd_dq",
                      "gated_linear_attention_bwd_dkv"),
                     ("B8", "B9-dq", "B9-dkv"),
                     "gated_linear_attention/kernel.py", (85, 212, 232),
                     "decay_sweep",
                     ("decay_sweep_fwd_tc (bf16 tensor cores)",
                      "decay_sweep_dq_tc (bf16 tensor cores)",
                      "decay_sweep_dkv_tc (bf16 tensor cores)"))}


def slice_model(backend, dtype, dev):
    """The training slices' model and batch: qwen3-0.6b at full width, 2
    layers, compute in ``dtype``, fp32 weights from seed 0, batch 2 x 256
    tokens from seed 1."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(get_config("qwen3-0.6b").with_backend(backend),
                              n_layers=2, dtype=dtype)
    params0 = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    toks = torch.randint(0, cfg.vocab_size, (2, 257), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    return cfg, params0, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def training_slice(backend, dev, phase) -> None:
    """Phases 9 and 11: 2 layers at qwen3-0.6b's full widths, fp32, batch
    2 x 256 tokens, weights from seed 0. Through the backend's attention
    kernels (B2/B3, B8/B9) and through their plain versions: the loss
    (rtol 1e-5), every gradient leaf (normwise 1e-4: fp32 sums in other
    orders through two layers and the head), and the parameters after
    one AdamW step (within 1e-6 wherever the plain gradient is above that
    tolerance; Adam's first step is ±lr by the gradient's sign, which
    rounding may flip where it is below)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import GradAccumulator, adamw, cosine_warmup
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import leaves, tree_map
    names, ids = TRAIN_KERNELS[backend][:2]
    cfg, params0, batch = slice_model(backend, "float32", dev)
    runs = {}
    for kernel in (True, False):
        reset_launches()
        loss, _, grads = GradAccumulator(1).run(
            lambda p, b: lm.lm_loss(p, b, cfg, attention_kernel=kernel),
            params0, batch)
        params = tree_map(lambda x: x.detach().clone(), params0)
        opt = adamw(cosine_warmup(3e-4, warmup=20, total=8), weight_decay=0.1)
        params, _, m = make_train_step(cfg, opt, attention_kernel=kernel)(
            params, opt.init(params), batch)
        torch.cuda.synchronize()
        runs[kernel] = (loss, leaves(grads), leaves(params), m,
                        read_launches())
    (loss_k, g_k, p_k, m_k, n_k), (loss_p, g_p, p_p, m_p, n_p) = (
        runs[True], runs[False])
    # two backward passes per route (the gradients, then the train
    # step); the forward kernel twice per layer and pass: forward and
    # remat recompute
    want = dict(zip(names, (2 * 2 * cfg.n_layers, 2 * cfg.n_layers,
                            2 * cfg.n_layers)))
    got = {k: n for k, n in n_k.items() if n}
    if got != want or any(n_p.values()):
        raise AssertionError(f"phase {phase}: launches {got} on the kernel "
                             f"route (want {want}), {n_p} on the plain "
                             f"route")
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(m_k["loss"], m_p["loss"], rtol=1e-5, atol=0.0)
    g_err = max(normwise(a, b, 1e-4, f"phase {phase} gradient leaf")
                for a, b in zip(g_k, g_p))
    p_err, n_flip, n_small = 0.0, 0, 0
    for a, b, g in zip(p_k, p_p, g_p):
        big = g.abs() > 1e-4 * g.abs().max()
        d = (a - b).abs()
        p_err = max(p_err, d[big].max().item() if big.any() else 0.0)
        n_small += int((~big).sum())
        n_flip += int((d[~big] > 1e-6).sum())
    if p_err > 1e-6:
        raise AssertionError(f"phase {phase}: parameters after one step "
                             f"differ by {p_err:.3e}")
    if not all(torch.isfinite(x).all() for x in g_k + p_k):
        raise AssertionError(f"phase {phase}: non-finite gradients or "
                             f"parameters")
    print(f"phase {phase}: {backend} training slice, 2 layers full width "
          f"fp32, batch 2 x 256: loss {loss_k.item():.6f} vs plain "
          f"{loss_p.item():.6f}; {len(g_k)} gradient leaves max normwise "
          f"|Δg|={g_err:.3e}; params after one AdamW step max|Δ|="
          f"{p_err:.3e} where |g| > 1e-4 max|g| ({n_flip} of {n_small} "
          f"elements below it moved apart); {'/'.join(ids)} launches {got} "
          f"over two passes ({ids[0]} twice per layer and pass: forward and "
          f"remat recompute)")


# The bf16 slices (phases 9 and 11): the kernel route against the plain
# route, both in bf16 compute, which round the attention core's operands in
# other places (the tensor-core routes feed bf16 score tiles, state copies
# and scaled operands to their products; the plain versions compute in
# fp32 from the bf16 inputs); the difference then passes through two bf16
# layers, the head and the backward. The loss relative, every gradient
# leaf normwise (max|Δ| over max|plain|); PERF.md §6 gives the measured
# errors beside these limits (loss 1.2e-5 and leaves 1.5e-2 at most).
BF16_SLICE_TOL = {"loss": 1e-4, "leaf": 5e-2}


def training_slice_bf16(backend, dev, phase) -> None:
    """Phases 9 and 11, second part: ``training_slice``'s 2-layer model in
    bf16 compute (fp32 master weights, as the main path trains), so that
    the attention kernels take their bf16 (tensor-core) routes inside the
    model: the loss and every gradient leaf through the kernels against
    the same through ``attention_kernel=False``, at BF16_SLICE_TOL."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import GradAccumulator
    from repro_torch.tree import leaves
    names, ids = TRAIN_KERNELS[backend][:2]
    cfg, params0, batch = slice_model(backend, "bfloat16", dev)
    runs = {}
    for kernel in (True, False):
        reset_launches()
        loss, _, grads = GradAccumulator(1).run(
            lambda p, b: lm.lm_loss(p, b, cfg, attention_kernel=kernel),
            params0, batch)
        torch.cuda.synchronize()
        runs[kernel] = (loss, leaves(grads), read_launches())
    (loss_k, g_k, n_k), (loss_p, g_p, n_p) = runs[True], runs[False]
    # one backward pass; the forward kernel twice per layer (forward and
    # remat recompute)
    want = dict(zip(names, (2 * cfg.n_layers, cfg.n_layers, cfg.n_layers)))
    got = {k: n for k, n in n_k.items() if n}
    if got != want or any(n_p.values()):
        raise AssertionError(f"phase {phase}: bf16 launches {got} on the "
                             f"kernel route (want {want}), {n_p} on the "
                             f"plain route")
    if not all(torch.isfinite(x).all() for x in g_k + [loss_k]):
        raise AssertionError(f"phase {phase}: non-finite bf16 loss or "
                             f"gradients")
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if not loss_err <= BF16_SLICE_TOL["loss"]:
        raise AssertionError(f"phase {phase}: bf16 loss {loss_k.item()} vs "
                             f"plain {loss_p.item()}: relative {loss_err:.3e}"
                             f" > {BF16_SLICE_TOL['loss']}")
    g_err = [normwise(a, b, BF16_SLICE_TOL["leaf"],
                      f"phase {phase} bf16 gradient leaf {i}")
             / b.float().abs().max().item()
             for i, (a, b) in enumerate(zip(g_k, g_p))]
    print(f"phase {phase}: {backend} training slice in bf16 compute, 2 layers"
          f" full width, batch 2 x 256: loss {loss_k.item():.6f} vs plain "
          f"{loss_p.item():.6f} (relative {loss_err:.3e}, limit "
          f"{BF16_SLICE_TOL['loss']}); {len(g_k)} gradient leaves, max|Δg| "
          f"over max|g|: largest {max(g_err):.3e}, median "
          f"{sorted(g_err)[len(g_err) // 2]:.3e} (limit "
          f"{BF16_SLICE_TOL['leaf']}); {'/'.join(ids)} launches {got}")


def profile_train_step(loop, batch, kernel) -> dict:
    """Device time by kernel over one training step (torch.profiler) and
    the device busy share: device time over the step's wall time; the
    rows of the attention kernels (named ``kernel``) all printed."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        loop.params, loop.opt_state, m = loop.step_fn(
            loop.params, loop.opt_state, batch)
        m["loss"].item()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows, _ = profile_rows(prof)
    total = sum(t for t, _, _ in rows)
    print(f"  profile: one training step {wall_ms:.3f} ms wall under the "
          f"profiler")
    if not total:
        print("  profile: the profiler reported no device time "
              "(not measured)")
        return {"busy": None, "sweep_ms": None, "rows": []}
    print(f"  profile: {total / 1e3:.3f} ms device time per step; device "
          f"busy {100 * total / 1e3 / wall_ms:.1f}% of the step")
    for i, (t, key, count) in enumerate(rows):
        if i < 16 or kernel in key:
            print(f"    {100 * t / total:5.1f}%  {t / 1e3:9.3f} ms  "
                  f"x{count:<5d} {key[:90]}")
    kinds = {}
    for t, key, count in rows:
        kind = next((k for k, words in TRAIN_KINDS if any(
            w in key for w in words)), "other")
        ms, n = kinds.get(kind, (0.0, 0))
        kinds[kind] = (ms + t / 1e3, n + count)
    print("  device time by kind: " + "; ".join(
        f"{k} {ms:.3f} ms ({100 * ms / (total / 1e3):.1f}%, {n} launches)"
        for k, (ms, n) in sorted(kinds.items(), key=lambda kv: -kv[1][0])))
    return {"busy": total / 1e3 / wall_ms, "device_ms": total / 1e3,
            "rows": rows}


# kernel names by kind, first match wins
TRAIN_KINDS = (("B2/B3", ("sweep_kernel", "linear_sweep")),
               ("B8/B9", ("decay_sweep",)),
               ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
               ("cumsum", ("scan",)),
               ("reduction", ("reduce_kernel",)),
               ("copy or cast", ("copy", "Memcpy", "Memset")),
               ("elementwise", ("elementwise",)))


def training_main_path(backend, dev, gen, phase) -> list:
    """Phases 10 and 12: ``launch/train.py``'s ``build`` and ``TrainLoop``
    on the full qwen3-0.6b under ``backend``, batch 8 x seq 1,024, 8 steps
    (2 warm-up, 6 timed), lr 3e-4 with warmup 20; every kernel's launch
    count set to 0 just before and read just after. Returns the
    backend's attention kernels' records for the kernels line (without
    ``max_abs_err``)."""
    import math
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    names, ids, pallas, lines, kernel, bf16_kernels = TRAIN_KERNELS[backend]
    args = train.parse_args(["--arch", "qwen3-0.6b", "--backend", backend,
                             "--batch", "8", "--seq-len", "1024", "--steps",
                             "8", "--lr", "3e-4", "--warmup", "20",
                             "--seed", "0", "--log-every", "1"])
    cfg = train.config(args)
    torch.cuda.reset_peak_memory_stats()
    loop = train.build(args)
    n_params = lm.param_count(loop.params)
    # JAX's eval_shape counts; gated adds the decay projection and the
    # groupnorm
    want_params = {"linear": 596_049_920, "gated_linear": 654_942_208}[
        backend]
    if n_params != want_params:
        raise AssertionError(f"phase {phase}: {n_params} parameters, want "
                             f"{want_params}")
    reset_launches()
    out = loop.run()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps, n_layers = out["step"], cfg.n_layers
    want = dict(zip(names, (2 * n_layers * steps, n_layers * steps,
                            n_layers * steps)))
    got = {k: n for k, n in launches.items() if n}
    if steps != 8 or got != want:
        raise AssertionError(f"phase {phase}: {steps} steps, launches {got} "
                             f"(want {want})")
    losses = [m["loss"] for m in out["metrics"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase {phase}: non-finite losses {losses}")
    times = [m["step_time"] for m in out["metrics"]]
    ms = sum(times[2:]) / len(times[2:]) * 1e3
    tok_s = args.batch * args.seq_len / ms * 1e3
    print(f"phase {phase}: training main path qwen3-0.6b {backend} "
          f"({n_params} params, fp32 master, bf16 compute, remat="
          f"{cfg.remat}), batch {args.batch} x seq {args.seq_len}: "
          f"ms_per_step={ms:.3f} tokens_per_s={tok_s:.1f} (mean of steps "
          f"3-8; step times ms {[round(t * 1e3, 3) for t in times]}), peak "
          f"memory {peak / 1e9:.3f} GB (torch.cuda.max_memory_allocated)")
    print(f"  losses {[round(x, 4) for x in losses]}; grad_norm "
          f"{[round(m['grad_norm'], 4) for m in out['metrics']]}")
    print(f"  launches per step: {ids[0]} {got[names[0]] // steps} "
          f"(forward + remat recompute), {ids[1]} {got[names[1]] // steps}, "
          f"{ids[2]} {got[names[2]] // steps}")
    batch = loop.put_batch(loop.dataset.batch_at(steps))
    prof = profile_train_step(loop, batch, kernel)
    if prof["busy"] is not None:
        print(f"  device busy {100 * prof['busy']:.1f}% of a profiled step; "
              f"{prof['device_ms']:.3f} ms device time against "
              f"{ms:.3f} ms per step unprofiled")
    if backend == "gated_linear":
        # B9's bf16 route forms dg inside its dk/dv launch: the step runs
        # no flip or cumulative-sum kernel (the eager epilogue it
        # replaced did)
        epi = [(t, key, n) for t, key, n in prof["rows"]
               if "flip" in key or "scan" in key or "cumsum" in key]
        if epi:
            raise AssertionError(f"phase {phase}: flip or cumsum kernels in "
                                 f"the gated step: {epi}")
        print(f"  flip or cumsum kernels in the profiled step: none "
              f"({len(prof['rows'])} device rows)")
    del loop, out, batch
    torch.cuda.empty_cache()

    rows = args.batch * cfg.n_heads
    timer = {"linear": time_linear_attention,
             "gated_linear": time_gated_linear_attention}[backend]
    t = timer(rows, args.seq_len, cfg.head_dim, cfg.linear_chunk, gen, dev)
    if backend == "linear":
        r = t["bwd"]
        print(f"B3 as a whole (ops.bwd: the dq launch, then the dk/dv launch) "
              f"rows={rows} T={args.seq_len} D={cfg.head_dim} bf16: "
              f"{r['ms'] * 1e3:.2f} us (dq {t[names[1]]['ms'] * 1e3:.2f} + "
              f"dk/dv {t[names[2]]['ms'] * 1e3:.2f} us timed alone); bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
              f"({r['bytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.2f} GFLOP on "
              f"bf16 tensor cores), {r['two_sweep_ms'] * 1e3:.2f} us for any "
              f"two sweeps ({r['two_sweep_bytes'] / 1e6:.2f} MB); plain "
              f"version {r['plain_ms'] * 1e3:.2f} us")
    if backend == "gated_linear":
        r, old = t["bwd"], t["old_epilogue_ms"]
        print(f"B9 as a whole (ops.bwd: the dq launch, then the dk/dv launch "
              f"with dg) rows={rows} T={args.seq_len} D={cfg.head_dim} bf16: "
              f"{r['ms'] * 1e3:.2f} us (dq {t[names[1]]['ms'] * 1e3:.2f} + "
              f"dk/dv/dg {t[names[2]]['ms'] * 1e3:.2f} us timed alone); "
              f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
              f"({r['bytes'] / 1e6:.2f} MB, {r['flops'] / 1e9:.2f} GFLOP on "
              f"bf16 tensor cores); plain version {r['plain_ms'] * 1e3:.2f} "
              f"us; the eager dg epilogue it replaced (ref.dg_epilogue and "
              f"the casts of dq and dk) alone {old * 1e3:.2f} us")
    records = []
    for name, line, cuda_kernel in zip(names, lines, bf16_kernels):
        r = t[name]
        print(f"{name} [{cuda_kernel}] rows={rows} T={args.seq_len} "
              f"D={cfg.head_dim} bf16: {r['ms'] * 1e3:.2f} us/launch (plain "
              f"version "
              f"{r['plain_ms'] * 1e3:.2f} us; library call: none; bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} on bf16 "
              f"tensor cores, {r['fp32_bound_ms'] * 1e3:.2f} us at the fp32 "
              f"rate; {r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.2f} "
              f"MB moved)")
        stem = pallas.split("/")[0]
        records.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/{stem}/csrc/{stem}.cu",
            "replaces": f"src/repro/kernels/{pallas}:{line}",
            "launches": launches[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "kernel": cuda_kernel})
    torch.cuda.empty_cache()
    return records


def softmax_slice(dev, phase) -> None:
    """Phase 13: a 2-layer model at qwen3-0.6b's full widths under softmax
    in fp32, batch 4, prompt 64: prefill through B10, then 16 greedy
    steps over the KV cache, against the same with prefill through B10's
    plain version (``attention_kernel=False``): greedy tokens identical,
    logits within 1e-4, the caches within 1e-5, B10 launched once per
    layer in the kernel route's prefill and never on the plain route."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").with_backend("softmax"), n_layers=2,
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (4, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    runs = {}
    for kernel in (True, False):
        reset_launches()
        logits, st = lm.prefill(params, prompt, cfg, attention_kernel=kernel)
        launched = {k: n for k, n in read_launches().items() if n}
        want = {"flash_attention_fwd": cfg.n_layers} if kernel else {}
        if launched != want:
            raise AssertionError(f"phase {phase}: prefill launched "
                                 f"{launched} (attention_kernel={kernel}), "
                                 f"want {want}")
        st = lm.pad_decode_state(st, cfg, 64 + 16)
        tok = lm.sample_token(logits, 0.0)
        all_logits, toks = [logits], [tok]
        for i in range(16):
            logits, st = lm.decode_step(params, st, tok, 64 + i, cfg)
            tok = lm.sample_token(logits, 0.0)
            all_logits.append(logits)
            toks.append(tok)
        if {k: n for k, n in read_launches().items() if n} != launched:
            raise AssertionError(f"phase {phase}: decode launched a kernel")
        runs[kernel] = (torch.stack(all_logits), torch.stack(toks),
                        [c for group in st["stack"] for c in
                         (group.k_cache, group.v_cache)])
    (lg_k, tok_k, c_k), (lg_p, tok_p, c_p) = runs[True], runs[False]
    if not torch.equal(tok_k, tok_p):
        raise AssertionError(f"phase {phase}: greedy tokens differ")
    torch.testing.assert_close(lg_k, lg_p, rtol=1e-4, atol=1e-4)
    for a, b in zip(c_k, c_p):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    if not torch.isfinite(lg_k).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    print(f"phase {phase}: softmax 2-layer full-width fp32 slice, batch 4, "
          f"prefill 64 + 16 greedy steps: tokens identical, max|Δlogit|="
          f"{(lg_k - lg_p).abs().max().item():.3e}, max|Δcache|="
          f"{max((a - b).abs().max().item() for a, b in zip(c_k, c_p)):.3e}"
          f", flash_attention_fwd launched {cfg.n_layers} times in the "
          f"kernel route's prefill, 0 in the plain route's")


def softmax_generate_main_path(dev, gen, phase) -> dict:
    """Phase 14: ``serve --mode generate --backend softmax`` on the full
    28-layer qwen3-0.6b in bf16 (random weights from seed 0), batch 8,
    prompt 512, 64 generated tokens, with every kernel's launch count set
    to 0 just before and read just after: B10 once per layer in each
    prefill (the entry point's warm-up and the timed one), no other
    kernel; KV caches of 576 rows. Then a profile of 4 decode steps over
    a 576-row cache and B10 timed beside its bounds, its plain version and
    ``scaled_dot_product_attention``, with a profile of one prefill.
    Returns B10's record for the kernels line (without ``max_abs_err``),
    timed at the prefill's shape."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    args = serve.parse_args(["--arch", "qwen3-0.6b", "--backend", "softmax",
                             "--batch", "8", "--prompt-len", "512",
                             "--gen-len", "64", "--seed", "0"])
    full = get_config(args.arch).with_backend("softmax")
    name = "flash_attention_fwd"
    reset_launches()
    result = serve.generate(args)
    launches = read_launches()
    got = {k: n for k, n in launches.items() if n}
    if result["prefill_launches"] != full.n_layers or \
            got != {name: 2 * full.n_layers} or result["decode_launches"]:
        raise AssertionError(f"phase {phase}: {result['prefill_launches']} "
                             f"B10 launches in the timed prefill, "
                             f"{result['decode_launches']} decode-kernel "
                             f"launches, {got} in the run; want "
                             f"{full.n_layers}, 0 and {2 * full.n_layers}")
    toks = result["tokens"]
    if toks.shape != (args.batch, args.gen_len) or not (
            (toks >= 0) & (toks < full.vocab_size)).all():
        raise AssertionError(f"phase {phase}: bad generated tokens")
    max_len = args.prompt_len + args.gen_len
    cache_bytes = (full.n_layers * 2 * args.batch * max_len
                   * full.n_kv_heads * full.head_dim * 2)     # k, v bf16
    if result["state_mib"] != cache_bytes / 2**20:
        raise AssertionError(f"phase {phase}: KV cache {result['state_mib']}"
                             f" MiB, want {cache_bytes / 2**20}")
    print(f"phase {phase}: softmax main path "
          f"prefill_ms={result['prefill_ms']:.3f} "
          f"decode_ms_per_token={result['decode_ms_per_token']:.4f} "
          f"tok_s={result['tokens_per_s']:.1f} "
          f"kv_cache_mib={result['state_mib']:.1f} ({max_len} rows) "
          f"{name}.launches={launches[name]} (timed prefill "
          f"{result['prefill_launches']} = {full.n_layers} layers, warm-up "
          f"prefill {full.n_layers}); decode kernels launched 0 times "
          f"(plain KV-cache read)")

    # where a decode step's device time goes: the main path's prompt and
    # cache length, full model, bf16
    params = lm.cast_params(
        lm.init_params(torch.Generator(device=dev).manual_seed(0), full),
        torch.bfloat16)
    prompt = torch.randint(0, full.vocab_size, (args.batch, args.prompt_len),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    logits, st = lm.prefill(params, prompt, full)
    st = lm.pad_decode_state(st, full, max_len)
    profile_prefill(params, full, prompt, "flash_fwd")
    device_ms = profile_decode(params, full, st, torch.argmax(logits, -1),
                               args.prompt_len)
    if not torch.isfinite(logits).all() or not all(
            torch.isfinite(t).all() for group in st.values()
            for layer in group for t in layer if t is not None):
        raise AssertionError(f"phase {phase}: non-finite logits or cache")
    if device_ms is not None:
        busy = device_ms / result["decode_ms_per_token"]
        print(f"  device busy {100 * busy:.1f}% of a decode step "
              f"({device_ms:.3f} ms device time per step over "
              f"{result['decode_ms_per_token']:.3f} ms per token)")
    del params, st, logits
    torch.cuda.empty_cache()

    # B10 at the prefill's shape (q of 16 heads over K/V of 8) and, for
    # the line of continuity with PR 18's table, with K/V of 16 heads
    t = {}
    for hkv in (full.n_kv_heads, full.n_heads):
        t[hkv] = r = time_flash_attention(args.batch, full.n_heads, hkv,
                                          args.prompt_len, full.head_dim,
                                          gen, dev)
        print(f"{name} rows={args.batch * full.n_heads} kv_rows="
              f"{args.batch * hkv} T=S={args.prompt_len} D={full.head_dim} "
              f"bf16 causal: {r['ms'] * 1e3:.2f} us/launch (plain version "
              f"{r['plain_ms'] * 1e3:.2f} us; library call "
              f"scaled_dot_product_attention(is_causal=True, enable_gqa="
              f"True) {r['library_ms'] * 1e3:.2f} us, max|Δ| against the "
              f"kernel {r['library_max_abs_diff']:.3e}; bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} on bf16 "
              f"tensor cores, {r['fp32_bound_ms'] * 1e3:.2f} us at the fp32 "
              f"rate; {r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.2f} "
              f"MB moved)")
    t = t[full.n_kv_heads]
    host_us, resolve_us = wrapper_host_us(args.batch, full.n_heads,
                                          full.n_kv_heads, args.prompt_len,
                                          full.head_dim, gen, dev)
    print(f"  host time per {name} call (wrapper and launch): "
          f"{host_us:.1f} us; one Path.resolve() of its source, which "
          f"build.load_library no longer makes per launch: "
          f"{resolve_us:.1f} us")
    return {"name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention/csrc/"
                      "flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:61",
            "launches": launches[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on a GPU",
              file=sys.stderr)
        return 1
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.fused_recurrent import ops
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.linear_attention import ops as LA
    from repro_torch.kernels.lookup import ops as LU

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    phase_s = {}

    def done(phase, t0):
        phase_s[phase] = time.perf_counter() - t0
        print(f"  [phase {phase}: {phase_s[phase]:.1f} s]")

    # -- 1. device and build ---------------------------------------------
    t0 = time.perf_counter()
    card = nvidia_smi()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} "
          f"count {torch.cuda.device_count()}")
    # one nvcc each, all started together
    build.build([ops.SOURCE, ops.GATED_SOURCE, LU.SOURCE, LA.SOURCE,
                 GL.SOURCE, FA.SOURCE])
    ops.load()
    ops.load_gated()
    LU.load()
    LA.load()
    GL.load()
    FA.load()
    print(f"phase 1: built and loaded the kernels in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_SECONDS})")
    for name, log in build.BUILD_LOG.items():
        for line in ptxas_notes(log):
            print(f"  {name}: {line}")
    # the bf16 routes of B10, B8/B9 and B2/B3 run on the tensor cores
    for source, ids in ((FA.SOURCE, "B10"), (GL.SOURCE, "B8/B9"),
                        (LA.SOURCE, "B2/B3")):
        n_hgmma = hgmma_count(build, source)
        if not n_hgmma:
            raise AssertionError(f"phase 1: no HGMMA in {source.name}'s "
                                 f"library: {ids}'s bf16 route is not on "
                                 f"the tensor cores")
        print(f"  {source.name}: {n_hgmma} HGMMA (wgmma) instructions in "
              f"the built library (cuobjdump --dump-sass)")
    done(1, t0)

    # -- 2. kernels against their plain versions --------------------------
    t0 = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(0)
    errs = {}
    for n, d in ((128, 128), (12, 16)):         # main path, smoke width
        for w in (1, 8):
            for normalize in (False, True):
                for varlen in (False, True):
                    err = check_decode_linear(n, d, w, normalize, varlen,
                                              gen, dev)
                    if (d, w, normalize, varlen) == (128, 1, True, False):
                        errs["decode_linear"] = err   # the main path's
    print("phase 2: decode_linear agrees with its plain version "
          "(S, z rtol 1e-5; o within 1 bf16 ulp; masked rows bitwise)")
    for dtype in (torch.bfloat16, torch.float32):
        for w in (1, 8):
            for varlen in (False, True):
                for decay in ("mild", "scalar", "strong", "zero"):
                    err = check_decode_gated(128, 128, w, dtype, varlen,
                                             decay, gen, dev)
                    if (dtype, w, varlen, decay) == (torch.bfloat16, 1,
                                                     False, "mild"):
                        errs["decode_gated"] = err    # the main path's
    for varlen in (False, True):                      # smoke width
        check_decode_gated(12, 16, 8, torch.bfloat16, varlen, "mild", gen,
                           dev)
        check_decode_gated(12, 16, 8, torch.float32, varlen, "scalar", gen,
                           dev)
    print("phase 2: decode_gated agrees with its plain version (S rtol "
          "1e-6; o within 1e-5 fp32, 1 bf16 ulp bf16; lens-0 rows bitwise, "
          "masked o 0)")
    # the lookup main path's wave: 256 rows of the 16,384-row store, of
    # which the first 8,192 hold documents
    errs["mass_lookup_indexed"] = check_lookup_indexed(
        16384, 256, 1, 64, 1, gen, dev, n_live=8192)
    check_lookup_indexed(1024, 256, 4, 100, 4, gen, dev)   # paper width
    check_lookup_indexed(64, 32, 5, 64, 4, gen, dev)       # M tiles, pad
    check_lookup_indexed(8, 64, 2, 64, None, gen, dev)     # repeated rows
    check_lookup_indexed(256, 64, 3, 128, None, gen, dev)  # K = 128
    for kd in (64, 100, 256):
        err = check_mass_lookup(64, 4, kd, gen, dev)
        if kd == 100:
            errs["mass_lookup"] = err
    for dk, dv in ((64, 64), (100, 48)):
        for dtype in (torch.float32, torch.bfloat16):
            err = check_fused_decode(256, dk, dv, dtype, gen, dev)
            if (dk, dtype) == (64, torch.float32):
                errs["fused_decode"] = err
    print(f"phase 2: mass_lookup_indexed, mass_lookup and fused_decode "
          f"agree with their plain versions (o rtol/atol {LOOKUP_TOL}, "
          f"non-symmetric states; fused_decode's state bitwise)")
    # B2/B3: the training main path's shape, then T a multiple of the
    # chunk but not of the kernels' tiles (32 tokens in fp32, 64 in
    # bf16), at D = 128 and 16
    errs.update(check_linear_attention_rows(128, 1024, 128, torch.bfloat16,
                                            128, gen, dev))
    check_linear_attention_rows(6, 272, 128, torch.float32, 16, gen, dev)
    for d in (128, 16):
        for bh, t, chunk in ((6, 272, 16), (4, 75, 75), (6, 48, 16),
                             (6, 200, 40)):
            check_linear_attention_rows(bh, t, d, torch.bfloat16, chunk,
                                        gen, dev)
    check_linear_attention_wrapper(40, 16, torch.float32, 16, gen, dev)
    for dtype in (torch.float32, torch.bfloat16):      # T % 128 != 0
        check_linear_attention_wrapper(200, 128, dtype, 128, gen, dev)
    check_linear_attention_autograd(gen, dev)
    print(f"phase 2: linear_attention_fwd, _bwd_dq and _bwd_dkv agree with "
          f"their plain versions (normwise {LA_TOL}; B2's states far from "
          f"symmetric)")
    # B8/B9: the gated training main path's shape at the model's decay;
    # fp32 at a T that is a multiple of the chunk but not of the 32-token
    # tile, at a ragged T (the chunk drops to T = 75), at D = 16, through
    # the wrapper (padding, per-head decay); then at the clamp
    errs.update(check_gla_rows(128, 1024, 128, torch.bfloat16, 128, "model",
                               gen, dev))
    check_gla_rows(128, 1024, 128, torch.bfloat16, 128, "mild", gen, dev)
    for bh, t, d, chunk in ((6, 272, 128, 16), (4, 75, 128, 75),
                            (6, 48, 16, 16)):
        check_gla_rows(bh, t, d, torch.float32, chunk, "mild", gen, dev)
    # the bf16 routes take 64-token tiles: T = 272, 75, 48 and 200 are not
    # multiples of it; D = 16 and 128; the model's decay and the mild one
    for d in (128, 16):
        for bh, t, chunk in ((6, 272, 16), (4, 75, 75), (6, 48, 16),
                             (6, 200, 40)):
            for decay in ("model", "mild"):
                check_gla_rows(bh, t, d, torch.bfloat16, chunk, decay, gen,
                               dev)
    check_gla_wrapper(40, 16, torch.float32, 16, False, gen, dev)
    check_gla_wrapper(200, 128, torch.float32, 128, True, gen, dev)
    for scalar in (False, True):                    # per-head decay too
        check_gla_wrapper(200, 128, torch.bfloat16, 128, scalar, gen, dev)
    check_gla_wrapper(75, 16, torch.bfloat16, 16, True, gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        check_gla_clamp(dtype, gen, dev)
    check_decay_limit(gen, dev)
    print(f"phase 2: gated_linear_attention_fwd (inclusive, exclusive + u), "
          f"_bwd_dq and _bwd_dkv agree with their plain versions (normwise "
          f"{LA_TOL}; the fp32 state within {LA_TOL['float32']}) and, at the "
          f"clamp and at each route's min_log_decay limit, with gla_scan")
    # B10: the softmax prefill main path's shape (B 8 x H 16 q rows over 8
    # kv heads, T = S = 512, bf16), the same with K/V of 16 heads, then
    # each D the kernel takes on both routes with ragged T, t_off < S - T
    # and s_real < S, grouped (Hkv < H) and one to one, and the wrapper's
    # padding
    errs["flash_attention_fwd"] = check_flash_attention(
        128, 512, 512, 128, torch.bfloat16, gen, dev, kv_heads=8, heads=16)
    check_flash_attention(128, 512, 512, 128, torch.bfloat16, gen, dev)
    for dtype in (torch.bfloat16, torch.float32):
        check_flash_attention(8, 77, 300, 128, dtype, gen, dev, t_off=5,
                              s_real=290, kv_heads=2, heads=4)
        check_flash_attention(12, 96, 160, 16, dtype, gen, dev, t_off=10,
                              s_real=100, kv_heads=2, heads=6)
        check_flash_attention(12, 200, 200, 64, dtype, gen, dev,
                              s_real=150)
        check_flash_attention(12, 130, 130, 16, dtype, gen, dev,
                              kv_heads=3, heads=6)
        check_flash_attention(4, 128, 256, 64, dtype, gen, dev, kv_heads=1,
                              heads=2)
    check_flash_attention(4, 200, 200, 128, torch.float32, gen, dev)
    check_flash_attention(6, 64, 64, 128, torch.bfloat16, gen, dev)
    check_flash_wrapper(2, 3, 3, 200, 200, torch.float32, gen, dev)
    check_flash_wrapper(2, 3, 3, 72, 200, torch.bfloat16, gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        check_flash_wrapper(2, 16, 8, 72, 200, dtype, gen, dev)
    print("phase 2: flash_attention_fwd agrees with its plain version and, "
          "where T = S - t_off, with JAX's oracle (fp32 1e-5; bf16 normwise "
          "8e-3 and 2e-2 elementwise), K/V read by kv head")
    done(2, t0)

    # -- 3. the linear slice, kernel vs plain recurrence, fp32 -------------
    t0 = time.perf_counter()
    slice_kernel_vs_reference("linear", dev, 3)
    done(3, t0)

    # -- 4. the linear generate main path ---------------------------------
    t0 = time.perf_counter()
    records = [generate_main_path("linear", dev, gen, 4)]
    done(4, t0)

    # -- 5. the lookup slice at the paper's width, kernel vs plain ---------
    t0 = time.perf_counter()
    lookup_slice(dev)
    torch.cuda.empty_cache()
    done(5, t0)

    # -- 6. the lookup main path ------------------------------------------
    t0 = time.perf_counter()
    main6 = lookup_main_path(dev)
    engine = main6["result"]["engine"]
    times = time_lookup_kernels(engine.store["c"], len(engine), gen, dev)
    for name, t in times.items():
        lib = ("" if t["library_ms"] is None else
               f"; library call {t['library_ms'] * 1e3:.2f} us")
        print(f"{name} {t['shape']}: {t['ms'] * 1e3:.2f} us/launch "
              f"(plain version {t['plain_ms'] * 1e3:.2f} us{lib}; bound "
              f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, "
              f"{t['bytes'] / 1e6:.2f} MB moved)")
    print(f"  gather + bmm (two calls, for information) at the B4 shape: "
          f"{times['mass_lookup_indexed']['gather_bmm_ms'] * 1e3:.2f} us")
    replaces = {"mass_lookup_indexed": 69, "mass_lookup": 41,
                "fused_decode": 116}
    for name, line in replaces.items():
        t = times[name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/lookup/csrc/lookup.cu",
            "replaces": f"src/repro/kernels/lookup/kernel.py:{line}",
            "launches": main6["launches"][name],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    del main6, engine, times
    torch.cuda.empty_cache()
    done(6, t0)

    # -- 7. the gated slice, kernel vs plain recurrence, fp32 --------------
    t0 = time.perf_counter()
    slice_kernel_vs_reference("gated_linear", dev, 7)
    done(7, t0)

    # -- 8. the gated generate main path ----------------------------------
    t0 = time.perf_counter()
    records.append(generate_main_path("gated_linear", dev, gen, 8))
    done(8, t0)

    # -- 9. the training slice, kernel vs plain, fp32 and bf16 --------------
    t0 = time.perf_counter()
    training_slice("linear", dev, 9)
    training_slice_bf16("linear", dev, 9)
    torch.cuda.empty_cache()
    done(9, t0)

    # -- 10. the training main path ------------------------------------------
    t0 = time.perf_counter()
    records.extend(training_main_path("linear", dev, gen, 10))
    done(10, t0)

    # -- 11. the gated training slice, kernel vs plain, fp32 and bf16 -------
    t0 = time.perf_counter()
    training_slice("gated_linear", dev, 11)
    training_slice_bf16("gated_linear", dev, 11)
    torch.cuda.empty_cache()
    done(11, t0)

    # -- 12. the gated training main path ------------------------------------
    t0 = time.perf_counter()
    records.extend(training_main_path("gated_linear", dev, gen, 12))
    done(12, t0)

    # -- 13. the softmax slice, B10 vs its plain version, fp32 -------------
    t0 = time.perf_counter()
    softmax_slice(dev, 13)
    torch.cuda.empty_cache()
    done(13, t0)

    # -- 14. the softmax generate main path ---------------------------------
    t0 = time.perf_counter()
    records.append(softmax_generate_main_path(dev, gen, 14))
    done(14, t0)

    for r in records:
        r["max_abs_err"] = errs[r["name"]]
    print(f"phases (s): {json.dumps({k: round(v, 1) for k, v in phase_s.items()})}"
          f" total {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
