"""Serving entry point (port of ``repro/launch/serve.py``, modes
``generate``, ``stream``, ``spec``, ``retrieve`` and ``lookup``).

``--mode generate``: one static batch of requests. Prefill the prompts
once, then decode autoregressively. ``--backend`` picks the mechanism:
``linear`` (paper §3; decode kernel ``decode_linear``) or
``gated_linear`` (paper §4, data-dependent decay with a per-head
groupnorm; decode kernel ``decode_gated``) decode at O(k²) per token
with no KV cache (the decode state has the same size at any context
length), each decode step running the backend's fused recurrent CUDA
kernel once per layer; ``softmax`` (paper §2, the baseline) prefills
through the causal flash-attention CUDA kernel (B10) once per layer and
decodes against a KV cache of prompt + generated length, read in plain
PyTorch at O(pos) per token. ``--arch`` takes the dense qwen3-0.6b,
yi-34b, internlm2-20b, phi3-mini-3.8b (head dim 96) and musicgen-large
(head dim 64, layernorm, GELU), under every backend in ``--mode
generate`` and ``--mode stream``; rwkv6-1.6b, whose RWKV-6 blocks have
no attention (``--backend`` does not apply to it): its prefill runs the
exclusive route of the gated chunked kernel (B8, with the per-head bonus
u) once per layer, its decode RWKV-6's recurrence in plain PyTorch;
zamba2-7b, the hybrid of 68 Mamba-2 blocks and one shared attention
block applied at 13 sites (head dim 112), under every backend: each
Mamba-2 block prefills through the inclusive route of the same kernel
(B8, with its final state) once per layer and decodes in plain PyTorch,
the shared attention as the backend's attention does; the MoE configs
deepseek-moe-16b and
qwen3-moe-235b-a22b (the experts in plain batched products, as in JAX)
and llama-3.2-vision-90b, whose
cross blocks attend to a memory of ``n_img_tokens`` patch embeddings
drawn from a generator of its own (the vision frontend is a stub) and
encoded once in prefill: C = φ(K)ᵀV per layer under the linear family,
K and V under softmax. Parameters are built in the compute type.

``--mode stream``: continuous batching under a synthetic Poisson request
stream (``make_request_mix``, the JAX package's workload draw for draw).
The fixed-slot ``DecodeEngine`` admits requests between segments —
bucket-padded batched varlen prefill waves, prompts longer than
``--prefill-chunk`` ingested chunk by chunk between decode segments —
and decodes ``--segment-len`` slot-masked steps at a time. The linear
family launches its recurrent kernel (B1 or B7) once per layer and step;
under ``--ingest recurrent`` (the default) every ingest chunk is one more
launch per layer, with per-row lengths. ``--backend softmax`` serves the
KV-cache baseline through the same engine: every admission wave's varlen
prefill launches the causal flash-attention kernel (B10) once per
layer, decode and ingest chunks read and write the caches in plain
PyTorch (a chunk as single-token steps). It serves the dense and MoE
configs; a config with cross blocks is refused (ValueError), since the
engine has no path for a memory, as JAX's has none. ``--prefix-cache
auto|on`` (JAX's flags, with ``--cache-bytes``) turns on the engine's
prefix cache: a prompt whose chunk-aligned prefix is cached admits as
one state copy plus its suffix's continuation chunks (the linear family
keeps one fixed-size state a prefix, softmax refcounted KV blocks);
``on`` raises where the backend cannot cache (per-request admission:
rwkv6-1.6b, zamba2-7b). ``--fork N`` submits each prompt for N
continuations encoded once (N completions a request).

Durability in ``--mode stream`` (JAX's flags): ``--journal PATH``
writes every submit, cancel and ack to a write-ahead journal before it
takes effect, ``--checkpoint-dir DIR`` checkpoints the engine every
``--checkpoint-every`` events, ``--crash-at-event N`` kills the engine at
event N (exit code 3) and ``--recover`` restores the newest checkpoint,
replays the journal past it and finishes the stranded requests, each
acked once. SIGINT or SIGTERM drains: the segment under way finishes and
the engine checkpoints. ``--backends A,B`` serves a fleet of
``fleet_demo_config``'s smoke configs behind one queue, ``--replicas N``
engines a group with failover (``--journal-dir`` for their journals).

``--mode spec``: speculative decoding against plain continuous
batching on one workload, in fp32 (JAX's ``spec``): every request
drafts ``--speculate-k`` tokens a round (``--draft ngram``, ``model`` or
``replay``), one masked window of K+1 tokens verifies every
speculative slot (B1/B7 once per layer) and one more rewinds the slots
that rejected part of it; the mode asserts the tokens equal plain
greedy's and prints acceptance, rounds, rewinds, tokens per round and
both runs' tokens/s.

``--mode retrieve``: the paper's encode-once / query-many with the
``DocumentStore``: ``--batch`` documents of 750 hidden states of width
100 each compressed to C = HᵀH, then 100 timed ``batched_lookup`` waves
of one query per document; the store's size against the raw hidden
states', and queries per second.

``--mode lookup``: memory serving. Encode ``--n-docs`` documents once
into fixed-size k×k states resident on the device, then answer two
passes of ``--n-queries`` single-query requests in waves of
``--wave-size``, each wave one launch of the indexed lookup kernel.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --backend gated_linear --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --backend softmax --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --prompt-len 16 --gen-len 8 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch deepseek-moe-16b --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b \\
      --backend softmax --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch musicgen-large --smoke --device cpu --prompt-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch llama-3.2-vision-90b --smoke --device cpu --prompt-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \\
      --smoke --device cpu --prompt-len 16 --gen-len 8 --batch 2
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --backend gated_linear --batch 8 --prompt-len 512 --gen-len 64
  PYTHONPATH=src python -m repro_torch.launch.serve --arch zamba2-7b \\
      --smoke --device cpu --backend softmax --prompt-len 16 --gen-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --backend softmax --prompt-len 16 --gen-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --arch qwen3-0.6b --slots 8 --segment-len 8 --n-requests 32 \\
      --prompt-len 512 --gen-len 64 --arrival-rate 0.25
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --smoke --device cpu --slots 4 --n-requests 16 --arrival-rate 0.5
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --backend softmax --arch qwen3-0.6b --slots 8 --segment-len 8 \\
      --n-requests 32 --prompt-len 512 --gen-len 64 --arrival-rate 0.25 \\
      --prefill-chunk 512
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --backend softmax --smoke --device cpu --slots 4 --n-requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --arch rwkv6-1.6b --slots 8 --segment-len 8 --n-requests 32 \\
      --prompt-len 512 --gen-len 64 --arrival-rate 0.25
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --arch rwkv6-1.6b --smoke --device cpu --slots 4 --n-requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --arch zamba2-7b --smoke --device cpu --slots 4 --n-requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --prefix-cache on --fork 3 --slots 8 --n-requests 8 \\
      --prompt-len 256 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --smoke --device cpu --prefix-cache on --fork 3 --slots 4 \\
      --n-requests 4 --prompt-len 40 --gen-len 8 --prefill-chunk 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --smoke --device cpu --journal build/wal.journal \\
      --checkpoint-dir build/ck --crash-at-event 3    # exit code 3
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --smoke --device cpu --journal build/wal.journal \\
      --checkpoint-dir build/ck --recover
  PYTHONPATH=src python -m repro_torch.launch.serve --mode stream \\
      --backends mamba2,rwkv6 --replicas 2 --slots 4 --n-requests 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode spec \\
      --arch qwen3-0.6b --slots 8 --n-requests 16 --prompt-len 128 \\
      --gen-len 64 --speculate-k 6 --draft ngram
  PYTHONPATH=src python -m repro_torch.launch.serve --mode spec --smoke \\
      --device cpu --slots 3 --n-requests 5 --prompt-len 12 --gen-len 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieve \\
      --batch 4096
  PYTHONPATH=src python -m repro_torch.launch.serve --mode retrieve \\
      --device cpu --batch 16
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lookup \\
      --n-docs 8192 --doc-len 750 --n-queries 131072 --wave-size 256
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lookup \\
      --device cpu --n-docs 16 --doc-len 24 --n-queries 64 --wave-size 16

Runs on CUDA unless ``--device cpu`` is given; weights, prompts,
documents and queries are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.configs.base import ModelConfig, with_depth
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.fused_recurrent import ops as FR
from repro_torch.kernels.gated_linear_attention import ops as GL
from repro_torch.kernels.lookup import ops as LU
from repro_torch.models import lm
from repro_torch.models.attention import CrossMemory


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(args) -> Dict[str, Any]:
    """Prefill + generation on one static batch. Prints the lines of the
    JAX package's ``generate`` and returns the measured numbers, the
    generated tokens, the cross memory's bytes per cross layer and
    sequence (0 without cross blocks), and the launches of the backend's
    kernels: ``prefill_launches`` in the timed prefill, of B10 (softmax
    attention; the linear family's attention prefills in plain PyTorch)
    and of B8 (rwkv6-1.6b's exclusive route, the Mamba-2 blocks'
    inclusive one), each kernel's in ``prefill_launches_by``; and
    ``decode_launches`` of B1 or B7 in the timed generation (0 under
    softmax, whose cache read is plain PyTorch, and for RWKV-6, whose
    decode is)."""
    device = resolve_device(args.device)
    cfg = serving_config(args)
    backend = cfg.attention_backend
    counts = layer_counts(cfg)
    rwkv = is_rwkv(cfg)
    prefill_kernels = {name: k for name, k, on in (
        ("gated_linear_attention_fwd", GL.fwd,
         counts["rwkv"] or counts["mamba"]),
        ("flash_attention_fwd", FA.fwd,
         counts["attn"] and backend == "softmax")) if on}
    decode_kernel = {"linear": FR.decode_linear,
                     "gated_linear": FR.decode_gated}.get(
                         backend if counts["attn"] else None)
    # independent generator streams: params / prompt / sampling / memory
    gens = [torch.Generator(device=device).manual_seed(args.seed * 4 + i)
            for i in range(4)]
    g_params, g_prompt, g_sample, g_memory = gens
    params = lm.init_params(g_params, cfg)

    b, t_p, t_g = args.batch, args.prompt_len, args.gen_len
    prompt = torch.randint(0, cfg.vocab_size, (b, t_p), generator=g_prompt,
                           device=device)
    # the cross blocks' memory: precomputed patch embeddings (the vision
    # frontend is a stub), as JAX draws them
    memory = (torch.randn((b, cfg.n_img_tokens, cfg.d_model),
                          generator=g_memory, device=device,
                          dtype=torch.bfloat16)
              if cfg.n_img_tokens else None)

    def count(kernel) -> int:
        return 0 if kernel is None else kernel.launches

    def by_prefill_kernel() -> Dict[str, int]:
        return {name: k.launches for name, k in prefill_kernels.items()}

    # warm-up, untimed: one prefill and two decode steps, so the kernels
    # are built and loaded and the library has picked its matmul kernels
    # before the clock starts
    logits, states = lm.prefill(params, prompt, cfg, memory=memory)
    states = lm.pad_decode_state(states, cfg, max_len=t_p + 2)
    lm.generate(params, states, torch.argmax(logits, -1), t_p, 2, cfg)
    _sync(device)

    prefill0 = by_prefill_kernel()
    t0 = time.perf_counter()
    logits, states = lm.prefill(params, prompt, cfg, memory=memory)
    states = lm.pad_decode_state(states, cfg, max_len=t_p + t_g)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_by = {k: n - prefill0[k] for k, n in by_prefill_kernel().items()}

    tok0 = lm.sample_token(logits, args.temperature, g_sample)
    decode0 = count(decode_kernel)
    t0 = time.perf_counter()
    toks, states = lm.generate(params, states, tok0, t_p, t_g - 1, cfg,
                               temperature=args.temperature,
                               generator=g_sample)
    _sync(device)
    t_decode = time.perf_counter() - t0
    decode_launches = count(decode_kernel) - decode0
    out = torch.cat([tok0[:, None], toks], dim=1)
    if out.shape != (b, t_g):
        raise RuntimeError(f"generated {tuple(out.shape)}, want {(b, t_g)}")

    n_dec = max(t_g - 1, 1)
    state_mib = lm.state_bytes(states) / 2**20
    pattern, reps, tail = cfg.pattern_and_repeats
    n_cross = pattern.count("cross") * reps + tail.count("cross")
    cross_bytes = sum(t.nbytes for group in states.values() for st in group
                      if isinstance(st, CrossMemory) for t in st
                      if t is not None) // max(n_cross * b, 1)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    kernels = [decode_kernel.__name__ if decode_kernel else
               "plain KV-cache read; prefill kernel flash_attention_fwd"
               if counts["attn"] else None,
               "plain RWKV-6 recurrence; prefill kernel "
               "gated_linear_attention_fwd, exclusive + u" if rwkv else None,
               "Mamba-2: prefill kernel gated_linear_attention_fwd, plain "
               "decode" if counts["mamba"] else None]
    kernels = "(" + "; ".join(k for k in kernels if k) + ")"
    print(f"arch={cfg.name} backend={'rwkv6' if rwkv else backend} "
          f"decode_kernel={cfg.decode_kernel} {kernels} device={where}")
    print(f"prefill {t_p} toks x{b}: {t_prefill*1e3:.0f} ms")
    print(f"decode  {t_g} toks x{b}: {t_decode/n_dec*1e3:.2f} ms/tok "
          f"({b*n_dec/t_decode:.0f} tok/s)")
    print(f"decode state: {state_mib:.1f} MiB "
          f"({'O(1) in context' if cfg.fixed_state_decode else 'KV cache'})")
    if n_cross:
        kept = ("K and V of its rows" if backend == "softmax"
                else "C and z, fp32")
        size = (f"{cross_bytes / 2**20:.2f} MiB" if cross_bytes >= 2**20
                else f"{cross_bytes / 2**10:.1f} KiB")
        print(f"cross memory: {cfg.n_img_tokens} image tokens encoded once, "
              f"{size} per cross layer and sequence ({kept}), {n_cross} "
              f"cross layers")
    return {"prefill_ms": t_prefill * 1e3,
            "decode_ms_per_token": t_decode / n_dec * 1e3,
            "tokens_per_s": b * n_dec / t_decode,
            "state_mib": state_mib, "tokens": out,
            "cross_memory_bytes": cross_bytes,
            "prefill_launches": sum(prefill_by.values()),
            "prefill_launches_by": prefill_by,
            "decode_launches": decode_launches}


def is_rwkv(cfg: ModelConfig) -> bool:
    """True for a pure RWKV-6 stack (no attention layer)."""
    pattern, _, tail = cfg.pattern_and_repeats
    return set(pattern) | set(tail) == {"rwkv"}


def layer_counts(cfg: ModelConfig) -> Dict[str, int]:
    """Layers of each family: ``attn`` (self-attention: attn and
    shared_attn sites), ``cross``, ``mamba`` and ``rwkv``."""
    pattern, reps, tail = cfg.pattern_and_repeats
    kinds = list(pattern) * reps + list(tail)
    return {"attn": kinds.count("attn") + kinds.count("shared_attn"),
            **{k: kinds.count(k) for k in ("cross", "mamba", "rwkv")}}


def serving_config(args) -> ModelConfig:
    """The config of ``--arch`` (``--smoke``: its reduced copy) under
    ``--backend`` (``linear`` unless given; in zamba2-7b it applies to
    the shared attention), cut to ``--n-layers``, its
    parameters built in the compute type: serving never needs the fp32
    master copy, whose build and cast would peak at three times the
    served bytes. A pure RWKV-6 stack has no attention layer: it keeps
    its config's ``attention_backend``, and ``--backend`` raises
    ValueError."""
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    if args.n_layers:
        cfg = with_depth(cfg, args.n_layers)
    if is_rwkv(cfg):
        if args.backend is not None:
            raise ValueError(f"{cfg.name} has no attention layer: "
                             f"--backend {args.backend} does not apply")
    else:
        cfg = cfg.with_backend(args.backend or "linear")
    return dataclasses.replace(cfg, param_dtype=cfg.dtype)


def make_request_mix(rng: np.random.Generator, n_requests: int,
                     prompt_len: int, gen_len: int, vocab_size: int,
                     arrival_rate: float):
    """Synthetic workload (the JAX package's, draw for draw): Poisson
    arrivals (exponential inter-arrival times, ``arrival_rate`` requests
    per decode step; 0 = all at once) and a skewed generation-length mix
    — most requests are short, every 4th runs ``gen_len`` tokens."""
    t = 0.0
    out = []
    for i in range(n_requests):
        if arrival_rate > 0:
            t += rng.exponential(1.0 / arrival_rate)
        prompt = rng.integers(0, vocab_size, size=prompt_len,
                              dtype=np.int64).astype(np.int32)
        g = gen_len if i % 4 == 0 else max(1, gen_len // 8)
        out.append((prompt, g, t))
    return out


def stream_launches(cfg: ModelConfig, stats: Dict[str, Any], ingest: str,
                    admission: str = "batched",
                    one_token_prompts: int = 0) -> int:
    """Launches of the backend's kernel that a stream run with these
    stats makes. Linear family, its recurrent kernel: one per attention
    layer and decode step of every segment (masked steps included), one
    per attention layer and recurrent ingest chunk, and one per
    attention layer and speculative verify and rewind pass (ModelDraft's
    own: ``draft_launches``). Softmax, B10: one
    per attention layer and prefill pass, i.e. each batched-admission
    wave and each of the ``one_token_prompts`` that batched admission
    encodes alone, or under per-request admission each prefill. RWKV-6
    (per-request admission), B8's exclusive route: one per layer and
    prefill. Mamba-2 blocks' B8 launches: ``ssd_stream_launches``."""
    counts = layer_counts(cfg)
    if is_rwkv(cfg):
        return counts["rwkv"] * stats["prefills"]
    if cfg.attention_backend == "softmax":
        passes = (stats["prefills"] if admission == "per_request"
                  else stats["prefill_dispatches"] + one_token_prompts)
        return counts["attn"] * passes
    chunks = stats["ingest_chunks"] if ingest == "recurrent" else 0
    return counts["attn"] * (stats["segment_len"] * stats["segments"]
                             + chunks + stats.get("spec_rounds", 0)
                             + stats.get("spec_rewind_dispatches", 0))


def draft_launches(cfg: ModelConfig, dispatches: Dict[str, int]) -> int:
    """Launches of the draft model's kernel by a ``ModelDraft`` with
    these ``dispatches``: linear family, B1/B7 once per attention layer
    and drafting step and once per flush of buffered commits; softmax,
    B10 once per attention layer and admission prefill."""
    counts = layer_counts(cfg)
    if cfg.attention_backend == "softmax":
        return counts["attn"] * dispatches["prefills"]
    return counts["attn"] * (dispatches["steps"] + dispatches["flushes"])


def ssd_stream_launches(cfg: ModelConfig, stats: Dict[str, Any]) -> int:
    """B8 launches of the Mamba-2 blocks in a stream run: one per mamba
    layer and prefill (admission is per request; ingest chunks and
    decode step the plain recurrence)."""
    return layer_counts(cfg)["mamba"] * stats["prefills"]


class _Drainer:
    """SIGINT/SIGTERM → finish the segment under way, drain, exit 0.

    The handler only sets a flag, which the serving loop reads between
    scheduler events, so a signal never tears a segment (or a checkpoint
    write) in half. A second signal falls to the handler that was there
    before (the way out if draining itself hangs), and leaving the block
    puts every previous handler back."""

    def __init__(self):
        self.requested = False
        self._prev = {}

    def __enter__(self):
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                self._prev[sig] = signal.signal(sig, self._on_signal)
            except ValueError:          # not the main thread
                pass
        return self

    def __exit__(self, *exc):
        for sig, prev in self._prev.items():
            signal.signal(sig, prev)

    def _on_signal(self, sig, frame):
        self.requested = True
        signal.signal(sig, self._prev.get(sig, signal.SIG_DFL))


def fleet_launches(fleet) -> Dict[str, int]:
    """Kernel launches that a fleet run with its replicas' stats makes,
    by kernel: each attention group's ``stream_launches``, the Mamba-2
    blocks' and RWKV-6's B8 launches (one per layer and prefill)."""
    want: Dict[str, int] = {}
    for reps in fleet._replicas.values():
        for rs in reps:
            eng = rs.engine
            cfg, st = eng.cfg, eng.stats.to_dict()
            counts = layer_counts(cfg)
            if is_rwkv(cfg) or counts["mamba"]:
                n = (counts["rwkv"] + counts["mamba"]) * st["prefills"]
                want["gated_linear_attention_fwd"] = want.get(
                    "gated_linear_attention_fwd", 0) + n
            if counts["attn"]:
                name = STREAM_KERNELS[cfg.attention_backend][0]
                want[name] = want.get(name, 0) + stream_launches(
                    cfg, st, eng.ingest, eng.admission)
    return want


def stream_fleet(args) -> Dict[str, Any]:
    """A fleet under the stream workload (JAX's ``stream_fleet``): the
    Poisson mix round-robins over the backend groups of ``--backends``
    (``fleet_demo_config``'s smoke-scale configs, which share the
    vocabulary) behind one admission queue, each group ``--replicas``
    engines with heartbeat and breaker failover. Prints JAX's lines (but
    its compiled-program count: the port compiles none) and each
    kernel's launches against ``fleet_launches``; returns the
    completions, the fleet's stats, the launches and the fleet."""
    from repro_torch.serving import FleetEngine, fleet_demo_config

    device = resolve_device(args.device)
    names = [b.strip() for b in args.backends.split(",") if b.strip()]
    groups = {}
    for i, name in enumerate(names):
        cfg = fleet_demo_config(name)
        gen = torch.Generator(device=device).manual_seed(args.seed * 4 + i)
        groups[name] = (lm.init_params(gen, cfg), cfg)
    max_len = args.prompt_len + args.gen_len + args.segment_len
    fleet = FleetEngine(
        groups, n_slots=args.slots, segment_len=args.segment_len,
        max_len=max_len, temperature=args.temperature, seed=args.seed,
        max_queue=args.max_queue, shed_policy=args.shed_policy,
        replicas=args.replicas, journal_dir=args.journal_dir,
        checkpoint_dir=args.checkpoint_dir,
        prefix_cache=PREFIX_CACHE[args.prefix_cache],
        cache_bytes=args.cache_bytes)
    vocab = min(cfg.vocab_size for _, cfg in groups.values())
    rng = np.random.default_rng(args.seed)
    requests = make_request_mix(rng, args.n_requests, args.prompt_len,
                                args.gen_len, vocab, args.arrival_rate)
    routed = {}
    for i, (prompt, g, arrival) in enumerate(requests):
        uid = fleet.submit(prompt, g, backend=names[i % len(names)],
                           arrival=arrival)
        routed[uid] = names[i % len(names)]

    counters = dict(STREAM_KERNELS.values())
    before = {k: fn.launches for k, fn in counters.items()}
    t0 = time.perf_counter()
    completions = fleet.run("continuous")
    _sync(device)
    dt = time.perf_counter() - t0
    launches = {k: fn.launches - before[k] for k, fn in counters.items()}
    want = fleet_launches(fleet)

    total = sum(len(c.tokens) for c in completions)
    print(f"fleet backends={','.join(names)} slots={args.slots}/group "
          f"segment={args.segment_len}")
    print(f"stream: {len(completions)} requests, {total} tokens in "
          f"{dt:.2f} s ({total / dt:.0f} tok/s)")
    stats = fleet.stats()
    for name in names:
        g = stats["groups"][name]
        toks = sum(len(c.tokens) for c in completions
                   if routed.get(c.uid) == name)
        print(f"  {name}: {toks} toks, backend={g['backend']} "
              f"fixed_state={g['fixed_size_state']} "
              f"state/slot={g['state_bytes_per_slot'] / 1024:.1f} KiB, "
              f"slot util {g['stats']['slot_utilization']:.2f}")
    if args.replicas > 1:
        print(f"replicas={args.replicas}/group "
              f"failovers={stats['failovers']} "
              f"readmitted={stats['readmitted']}")
    on_cpu = ("" if device.type == "cuda" else
              " (CPU tensors run the plain versions: no launch)")
    for name, n in sorted(want.items()):
        print(f"{name}: {launches[name]} launches; the replicas' stats "
              f"give {n}{on_cpu}")
    if len(completions) != args.n_requests:
        raise RuntimeError(f"{len(completions)} completions for "
                           f"{args.n_requests} requests")
    return {"exit_code": 0, "completions": completions, "stats": stats,
            "launches": launches, "want_launches": want, "seconds": dt,
            "tokens_per_s": total / dt, "fleet": fleet}


PREFIX_CACHE = {"off": None, "auto": "auto", "on": True}
STREAM_KERNELS = {"linear": ("decode_linear", FR.decode_linear),
                  "gated_linear": ("decode_gated", FR.decode_gated),
                  "softmax": ("flash_attention_fwd", FA.fwd),
                  "rwkv6": ("gated_linear_attention_fwd", GL.fwd)}


def stream(args) -> Dict[str, Any]:
    """Continuous batching under a synthetic Poisson request stream.
    Prints the lines of the JAX package's ``stream`` and returns the
    measured numbers (tokens/s and ms per segment over the timed run,
    slot utilisation, mean latency in decode steps), the engine's stats,
    the completions, the engine itself, and the launches of the
    backend's recurrent kernel in the timed run (``decode_launches``;
    ``warmup_stats`` are the untimed warm-up's), and with Mamba-2 blocks
    their B8 launches (``ssd_launches``, against ``ssd_stream_launches``
    as ``want_ssd_launches``); ``exit_code`` 0.

    Durability (JAX's flags): ``--journal`` journals every submit,
    cancel and ack; ``--checkpoint-dir`` checkpoints the engine every
    ``--checkpoint-every`` events; ``--crash-at-event N`` kills the
    engine at event N (``exit_code`` 3, the journal and checkpoints left
    as they are) and ``--recover`` restores the newest checkpoint,
    replays the journal and finishes the stranded requests instead of
    submitting new ones. SIGINT or SIGTERM drains: the segment under way
    finishes, the engine checkpoints (with ``--checkpoint-dir``) and the
    call returns ``drained`` with ``exit_code`` 0. A durable run has no
    warm-up, which its journal and event counts would record.
    ``--backends`` (or ``--replicas`` > 1) serves a fleet:
    :func:`stream_fleet`."""
    from repro_torch.serving import (DecodeEngine, FaultInjector,
                                     InjectedCrash, backend_for_config)

    if args.replicas > 1 and not args.backends:
        args.backends = args.backend or "linear"
    if args.backends:
        return stream_fleet(args)
    device = resolve_device(args.device)
    cfg = serving_config(args)
    backend = backend_for_config(cfg)
    rwkv = is_rwkv(cfg)
    mamba = layer_counts(cfg)["mamba"]
    name, kernel = STREAM_KERNELS["rwkv6" if rwkv else
                                  cfg.attention_backend]
    gen = torch.Generator(device=device).manual_seed(args.seed * 4)
    params = lm.init_params(gen, cfg)
    max_len = args.prompt_len + args.gen_len + args.segment_len
    engine = DecodeEngine(
        params, cfg, backend=backend, n_slots=args.slots,
        segment_len=args.segment_len, max_len=max_len,
        temperature=args.temperature, seed=args.seed,
        admission=args.admission, prefill_chunk=args.prefill_chunk,
        ingest=args.ingest, max_queue=args.max_queue,
        shed_policy=args.shed_policy,
        degrade_threshold=args.degrade_threshold,
        prefix_cache=PREFIX_CACHE[args.prefix_cache],
        cache_bytes=args.cache_bytes, journal=args.journal,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        injector=(None if args.crash_at_event is None else
                  FaultInjector(crash=(args.crash_at_event,))))
    rng = np.random.default_rng(args.seed)
    requests = make_request_mix(rng, args.n_requests, args.prompt_len,
                                args.gen_len, cfg.vocab_size,
                                args.arrival_rate)

    durable = bool(args.journal or args.checkpoint_dir or args.recover
                   or args.crash_at_event is not None)
    warmup_stats, warmup_ones = None, 0
    if not durable:
        # warm-up, untimed: the first prompt through admission, ingest
        # and one segment, so the kernels are loaded and the library has
        # picked its matmul kernels before the clock starts
        engine.submit(requests[0][0], min(2, requests[0][1]))
        engine.run()
        _sync(device)
        warmup_stats = engine.stats.to_dict()
        warmup_ones = int(len(requests[0][0]) == 1)
        if engine.cache is not None:
            # the warm-up's entries would make the timed run's first
            # admission a hit: the timed run starts cold, as JAX's does
            engine.cache.clear()
        engine.reset()

    ones = 0
    if args.recover:
        if engine.journal is None and engine._ckpt_mgr is None:
            raise SystemExit(
                "--recover needs --journal and/or --checkpoint-dir")
        n_journaled = (len(engine.journal.unacked_submits())
                       if engine.journal is not None else 0)
        engine.recover_in_place()
        print(f"recover: {n_journaled} unacked request(s) replayed "
              f"from the journal")
    else:
        for prompt, g, arrival in requests:
            engine.submit(prompt, g, arrival=arrival, fork=args.fork)
        ones = sum(len(p) == 1 for p, _, _ in requests)
    # a recovered engine's counters start from its checkpoint's
    stats0 = engine.stats.to_dict()
    launches0, ssd0 = kernel.launches, GL.fwd.launches
    t0 = time.perf_counter()
    with _Drainer() as drain:
        try:
            while engine.has_work() and not drain.requested:
                engine.step("continuous")
        except InjectedCrash as e:
            # a simulated hard kill: no drain, no last checkpoint; the
            # journal and the last periodic checkpoint are what recovery
            # gets
            print(f"crash: injected at event {e.event_idx} "
                  f"(journal/checkpoint left as-is; restart with "
                  f"--recover)")
            return {"exit_code": 3, "crashed_at": e.event_idx,
                    "engine": engine,
                    "decode_launches": kernel.launches - launches0,
                    "ssd_launches": GL.fwd.launches - ssd0}
    _sync(device)
    dt = time.perf_counter() - t0
    launches = kernel.launches - launches0
    ssd_launches = GL.fwd.launches - ssd0
    completions = engine.completions()

    if drain.requested:
        in_flight = (sum(1 for r in engine._slot_req if r is not None)
                     + sum(1 for r in engine._ingest_req if r is not None)
                     + len(engine._queue) + len(engine._suspended))
        if engine._ckpt_mgr is not None:
            engine.save_checkpoint()
        print(f"graceful shutdown: segment finished, {in_flight} "
              f"in-flight request(s) "
              + ("journaled + checkpointed for --recover"
                 if engine.journal is not None
                 or engine._ckpt_mgr is not None else "dropped"))
        if args.stats_json:
            with open(args.stats_json, "w") as f:
                f.write(engine.stats.to_json())
            print(f"stats written to {args.stats_json}")
        return {"exit_code": 0, "drained": True, "in_flight": in_flight,
                "engine": engine, "completions": completions,
                "decode_launches": launches}

    acks = None
    if engine.journal is not None:
        acks = engine.journal.acked()
        uids = {c.uid for c in completions}
        lost = sorted(uids - set(acks))
        zero_loss = not lost and len(acks) == len(uids)
        print(f"durability: acks={len(acks)} completions={len(uids)} "
              f"lost={len(lost)} "
              f"zero_loss={'PASS' if zero_loss else 'FAIL'}")
    # every submitted request resolves to a completion, fork=N ones to N;
    # a recovered run's count comes from the journal
    if not args.recover and len(completions) != args.n_requests * args.fork:
        raise RuntimeError(f"{len(completions)} completions for "
                           f"{args.n_requests} requests x fork {args.fork}")

    st = engine.stats
    total = sum(len(c.tokens) for c in completions)
    lat = [c.finished_step - c.admitted_step for c in completions
           if c.admitted_step >= 0]
    statuses: Dict[str, int] = {}
    for c in completions:
        statuses[c.status] = statuses.get(c.status, 0) + 1
    want = (stream_launches(cfg, st.to_dict(), engine.ingest,
                            engine.admission, ones)
            - stream_launches(cfg, stats0, engine.ingest, engine.admission))
    state_mib = lm.state_bytes(engine.state) / 2**20
    linear_mib = (backend_for_config(cfg.with_backend("linear"))
                  .state_bytes_per_slot(max_len) * args.slots / 2**20)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    softmax = cfg.attention_backend == "softmax" and not rwkv
    kernels = ("plain KV-cache read; prefill kernel flash_attention_fwd"
               if softmax else
               f"plain RWKV-6 recurrence; prefill kernel {name}, exclusive "
               f"+ u" if rwkv else name)
    if mamba:
        kernels += ("; Mamba-2: prefill kernel gated_linear_attention_fwd, "
                    "plain decode")
    print(f"arch={cfg.name} "
          f"backend={'rwkv6' if rwkv else cfg.attention_backend} "
          f"slots={args.slots} segment={args.segment_len} "
          f"decode_kernel={cfg.decode_kernel} ({kernels}) "
          f"device={where}")
    print(f"stream: {len(completions)} requests, {total} tokens in "
          f"{dt:.2f} s ({total / dt:.0f} tok/s, "
          f"{dt / max(st.segments, 1) * 1e3:.2f} ms per segment)")
    print(f"slot utilization {st.slot_utilization:.2f} over "
          f"{st.segments} segments; mean latency "
          f"{np.mean(lat):.0f} decode steps" if lat else
          "no request was served")
    print("status: " + " ".join(
        f"{k}={v}" for k, v in sorted(statuses.items())))
    if st.shed or st.preemptions or st.quarantined or st.degrade_transitions:
        print(f"lifecycle: shed={st.shed} preempt={st.preemptions} "
              f"resume={st.resumes} quarantine={st.quarantined} "
              f"retries={st.retries} failed={st.failed} "
              f"degrade_flips={st.degrade_transitions}")
    print(f"admission={engine.admission} ingest={engine.ingest} "
          f"chunk={engine.prefill_chunk}: "
          f"{st.prefills} prompts in {st.admission_batches} batched "
          f"waves (mean batch {st.mean_admission_batch:.1f}), "
          f"{st.ingest_chunks} ingest chunks "
          f"(interleave {st.interleave_ratio:.2f}), "
          f"{st.prefill_jit_misses} admission jit misses")
    if engine.cache is not None:
        c = engine.cache.counters()
        print(f"prefix cache ({engine.cache.name}): "
              f"hits={st.cache_hits} misses={st.cache_misses} "
              f"cached_prefix_tokens={st.cached_prefix_tokens} "
              f"forks={st.forks} evictions={st.cache_evictions} "
              f"bytes={c['bytes_used']}/{engine.cache.max_bytes}")
    formula = ("layers x prefills" if rwkv or (
                   softmax and engine.admission == "per_request")
               else "layers x (admission waves + 1-token prefills)"
               if softmax
               else "layers x (segment_len x segments + recurrent ingest "
                    "chunks)")
    on_cpu = ("" if device.type == "cuda" else
              " (CPU tensors run the plain versions: no launch)")
    if mamba:
        formula = "attention " + formula
    print(f"{name}: {launches} launches in the timed run; {formula} = "
          f"{want}{on_cpu}")
    want_ssd = (ssd_stream_launches(cfg, st.to_dict())
                - ssd_stream_launches(cfg, stats0))
    if mamba:
        print(f"gated_linear_attention_fwd: {ssd_launches} launches in the "
              f"timed run; mamba layers x prefills = {want_ssd}{on_cpu}")
    kind = f"KV cache of {max_len} rows" if softmax else "O(1) in context"
    print(f"decode state: {state_mib:.2f} MiB for {args.slots} slots "
          f"({kind}" + (")" if rwkv else
                       f"; the linear state at these slots: "
                       f"{linear_mib:.2f} MiB)"))
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(st.to_json())
        print(f"stats written to {args.stats_json}")
    return {"exit_code": 0, "tokens_per_s": total / dt, "seconds": dt,
            "ms_per_segment": dt / max(st.segments, 1) * 1e3,
            "slot_utilization": st.slot_utilization,
            "mean_latency_steps": float(np.mean(lat)) if lat else 0.0,
            "statuses": statuses,
            "tokens": total, "stats": st.to_dict(),
            "warmup_stats": warmup_stats, "decode_launches": launches,
            "want_launches": want,
            "warmup_launches": (0 if warmup_stats is None else
                                stream_launches(cfg, warmup_stats,
                                                engine.ingest,
                                                engine.admission,
                                                warmup_ones)),
            "ssd_launches": ssd_launches, "want_ssd_launches": want_ssd,
            "warmup_ssd_launches": (0 if warmup_stats is None else
                                    ssd_stream_launches(cfg, warmup_stats)),
            "acks": None if acks is None else len(acks),
            "state_mib": state_mib, "linear_state_mib": linear_mib,
            "completions": completions, "engine": engine}


def _top2_margin(params, cfg: ModelConfig, prompt: np.ndarray,
                 tokens: np.ndarray, i: int) -> float:
    """The top-2 logit margin of the plain greedy choice of ``tokens[i]``
    (the prompt and ``tokens[:i]`` prefilled): how near a tie the token
    where speculation and plain greedy part was."""
    seq = np.concatenate([prompt, tokens[:i]]).astype(np.int64)
    logits, _ = lm.prefill(params, torch.from_numpy(seq)[None].to(
        params["embed"].device), cfg)
    top = torch.topk(logits[0].float(), 2).values
    return float(top[0] - top[1])


def spec(args) -> Dict[str, Any]:
    """Speculative decoding against plain continuous batching on one
    workload (the JAX package's ``spec``): ``--n-requests`` prompts of
    ``--prompt-len`` random tokens (JAX's draw from ``--seed``), each
    ``--gen-len`` tokens, every request submitted with ``speculate_k =
    --speculate-k``, in fp32 activations (the verify window sums in
    another order than the sequential step, and the mode asserts that
    the speculative tokens equal plain greedy's token for token; fp32
    keeps the argmax margins above that). ``--draft ngram`` (prompt
    lookup), ``model`` (a second model of the config, weights from
    generator seed 4·seed + 1) or ``replay`` (the timed plain run's own
    tokens: acceptance near 1). A short warm-up of each kind (the first
    two requests, 8 tokens each), then a timed plain run and a timed
    speculative run. Prints JAX's lines and the launches of
    the backend's kernel in each timed run against ``stream_launches``
    (plus ``draft_launches``); returns them with the tokens/s, the
    stats of the speculative run, both runs' completions and the
    engine. Raises AssertionError, with the top-2 logit margin where the
    first token differs, if speculation changes a token."""
    from repro_torch.serving import (DecodeEngine, ModelDraft, NgramDraft,
                                     ReplayDraft, backend_for_config)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(serving_config(args), dtype="float32",
                              param_dtype="float32")
    rwkv = is_rwkv(cfg)
    name, kernel = STREAM_KERNELS["rwkv6" if rwkv else
                                  cfg.attention_backend]
    params = lm.init_params(
        torch.Generator(device=device).manual_seed(args.seed * 4), cfg)
    k = args.speculate_k
    max_len = args.prompt_len + args.gen_len + max(args.segment_len, k) + 1
    draft = None
    if args.draft == "ngram":
        draft = NgramDraft()
    elif args.draft == "model":
        dparams = lm.init_params(
            torch.Generator(device=device).manual_seed(args.seed * 4 + 1),
            cfg)
        draft = ModelDraft(dparams, cfg, n_slots=args.slots,
                           max_len=max_len)
    engine = DecodeEngine(
        params, cfg, backend=backend_for_config(cfg), n_slots=args.slots,
        segment_len=args.segment_len, max_len=max_len, seed=args.seed,
        draft=draft, admission=args.admission,
        prefill_chunk=args.prefill_chunk, ingest=args.ingest)
    rng = np.random.default_rng(args.seed)
    requests = [(rng.integers(0, cfg.vocab_size, size=args.prompt_len,
                              dtype=np.int64).astype(np.int32),
                 args.gen_len) for _ in range(args.n_requests)]

    def run_once(speculate_k, reqs):
        engine.reset()
        for prompt, g in reqs:
            engine.submit(prompt, g, speculate_k=speculate_k)
        launches0 = kernel.launches
        drafted0 = dict(draft.dispatches) if args.draft == "model" else {}
        t0 = time.perf_counter()
        comps = engine.run("continuous")
        _sync(device)
        dt = time.perf_counter() - t0
        own = {key: n - drafted0[key] for key, n in draft.dispatches.items()
               } if args.draft == "model" else None
        return (comps, dt, kernel.launches - launches0, own,
                engine.stats.to_dict())

    def want_launches(stats, own):
        return (stream_launches(cfg, stats, engine.ingest, engine.admission)
                + (draft_launches(cfg, own) if own is not None else 0))

    # untimed warm-ups of each kind (the first two requests, 8 tokens
    # each) build and load the kernels before the clock starts; the
    # replay draft replays the timed plain run
    warm = [(p, min(g, 8)) for p, g in requests[:2]]
    *_, w_own, w_stats = run_once(0, warm)
    want_warm = want_launches(w_stats, w_own)
    comps_plain, t_plain, plain_launches, _, plain_stats = run_once(
        0, requests)
    if args.draft == "replay":
        engine.draft = ReplayDraft({ReplayDraft.key(p): c.tokens for (p, _), c
                                    in zip(requests, comps_plain)})
    *_, w_own, w_stats = run_once(k, warm)
    want_warm += want_launches(w_stats, w_own)
    comps_spec, t_spec, spec_launches, own, _ = run_once(k, requests)
    st = engine.stats
    for (prompt, _), a, b in zip(requests, comps_plain, comps_spec):
        if not np.array_equal(a.tokens, b.tokens):
            n = min(len(a.tokens), len(b.tokens))
            i = next((j for j in range(n) if a.tokens[j] != b.tokens[j]), n)
            margin = _top2_margin(params, cfg, prompt, a.tokens, i)
            raise AssertionError(
                f"speculative decode diverged from plain greedy on request "
                f"{a.uid} at token {i} ({b.tokens[i:i + 1]} against "
                f"{a.tokens[i:i + 1]}); top-2 logit margin there {margin}")

    total = sum(len(c.tokens) for c in comps_spec)
    want = stream_launches(cfg, st.to_dict(), engine.ingest,
                           engine.admission)
    want_plain = want_launches(plain_stats, None)
    want_draft = draft_launches(cfg, own) if own is not None else 0
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"arch={cfg.name} backend={'rwkv6' if rwkv else cfg.attention_backend}"
          f" slots={args.slots} speculate_k={k} draft={args.draft} "
          f"dtype=float32 device={where}")
    print(f"spec:  {total} tokens in {t_spec:.2f} s "
          f"({total / t_spec:.0f} tok/s) — acceptance "
          f"{st.acceptance_rate:.2f}, {st.spec_rounds} rounds, "
          f"{st.spec_rewinds} rewinds in "
          f"{st.spec_rewind_dispatches} varlen dispatches, "
          f"{st.tokens_per_round:.2f} tokens per round")
    print(f"plain: {total} tokens in {t_plain:.2f} s "
          f"({total / t_plain:.0f} tok/s) — speculative speedup "
          f"{t_plain / t_spec:.2f}x, outputs bit-identical")
    on_cpu = ("" if device.type == "cuda" else
              " (CPU tensors run the plain versions: no launch)")
    print(f"{name}: {spec_launches} launches in the timed spec run (want "
          f"{want} + the draft's {want_draft}), {plain_launches} in the "
          f"plain run (want {want_plain}){on_cpu}")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(st.to_json())
        print(f"stats written to {args.stats_json}")
    return {"spec_tokens_per_s": total / t_spec,
            "plain_tokens_per_s": total / t_plain,
            "spec_seconds": t_spec, "plain_seconds": t_plain,
            "tokens": total, "stats": st.to_dict(),
            "plain_stats": plain_stats, "spec_launches": spec_launches,
            "want_spec_launches": want + want_draft,
            "draft_launches": want_draft, "plain_launches": plain_launches,
            "want_plain_launches": want_plain,
            "want_warmup_launches": want_warm, "draft_dispatches": own,
            "completions": comps_spec, "plain_completions": comps_plain,
            "requests": requests, "engine": engine}


def retrieve(args) -> Dict[str, Any]:
    """Encode once, query many, with the ``DocumentStore`` (the JAX
    package's ``retrieve``): ``--batch`` documents of n = 750 hidden
    states of width k = 100 (the paper's), each compressed once to
    C = HᵀH (O(k²) whatever n), then one untimed and 100 timed
    ``batched_lookup`` waves answering one query per document. Prints
    the store's MiB against the raw hidden states' and queries/s, and
    returns them with the hidden states, the queries, the store and the
    last wave's answers (for a caller's check against Hᵀ(Hq))."""
    from repro_torch.core import DocumentState, DocumentStore
    device = resolve_device(args.device)
    k_dim, n, docs = 100, 750, args.batch
    g_h, g_q = (torch.Generator(device=device).manual_seed(args.seed * 4 + i)
                for i in range(2))
    h = torch.randn((docs, n, k_dim), generator=g_h, device=device)
    store = DocumentStore()
    for i in range(docs):
        store.add(f"doc{i}", DocumentState.from_hidden_states(h[i]))
    q = torch.randn((docs, k_dim), generator=g_q, device=device)
    ids = [f"doc{i}" for i in range(docs)]
    store.batched_lookup(ids, q)
    _sync(device)
    iters = 100
    t0 = time.perf_counter()
    for _ in range(iters):
        out = store.batched_lookup(ids, q)
    _sync(device)
    dt = (time.perf_counter() - t0) / iters
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    store_mib, raw_mib = store.nbytes / 2**20, h.nbytes / 2**20
    print(f"retrieve: k={k_dim} n={n} docs={docs} device={where}")
    print(f"store: {len(store)} docs, {store_mib:.1f} MiB (raw hidden "
          f"states would be {raw_mib:.1f} MiB)")
    print(f"lookup: {docs / dt:.0f} queries/s, O(k²) each")
    return {"queries_per_s": docs / dt, "store_mib": store_mib,
            "raw_mib": raw_mib, "h": h, "queries": q, "answers": out,
            "store": store, "iters": iters}


def lookup(args) -> Dict[str, Any]:
    """Memory serving: ingest once, pin resident, serve query waves.
    Prints the lines of the JAX package's ``lookup`` and returns the
    measured numbers, the B4 kernel's launches in the timed pass
    (``lookup_launches``), and what a caller needs to check answers: the
    engine, its document ids, the queries and the first uid of the timed
    pass (request ``i`` of that pass asks ``queries[i]`` of document
    ``doc_ids[(i * 7) % len(doc_ids)]``)."""
    from repro_torch.core.state import DocumentStore
    from repro_torch.qa.gru import gru_params
    from repro_torch.serving import LookupEngine

    device = resolve_device(args.device)
    k_dim, vocab, d_embed = 64, 1000, 32
    # independent generator streams: embedding / GRU / queries
    g_embed, g_gru, g_query = (
        torch.Generator(device=device).manual_seed(args.seed * 4 + i)
        for i in range(3))
    encoder = {"embed": torch.randn((vocab, d_embed), generator=g_embed,
                                    device=device) * 0.1,
               "gru": gru_params(g_gru, d_embed, k_dim)}
    engine = LookupEngine(
        encoder, backend=args.lookup_backend, wave_size=args.wave_size,
        max_queue=args.max_queue, shed_policy=args.shed_policy,
        device=device)

    rng = np.random.default_rng(args.seed)
    t0 = time.perf_counter()
    if args.load:
        store = DocumentStore.load(args.load, device=device)
        for doc_id in store.ids():
            engine.pin(doc_id, store.get(doc_id))
        print(f"pinned {len(engine)} persisted memories from {args.load}")
    else:
        for i in range(args.n_docs):
            engine.ingest(f"doc{i}", rng.integers(0, vocab,
                                                  size=args.doc_len))
        engine.flush()
    _sync(device)
    ingest_s = time.perf_counter() - t0
    doc_ids = list(engine.rows())

    queries = torch.randn((args.n_queries, k_dim), generator=g_query,
                          device=device).cpu().numpy()
    for i in range(args.n_queries):           # warm pass
        engine.submit(doc_ids[i % len(doc_ids)], queries[i])
    engine.run()
    warm = engine.stats.queries
    timed_uids = [engine.submit(doc_ids[(i * 7) % len(doc_ids)], queries[i],
                                priority=i % 3)
                  for i in range(args.n_queries)]
    launches0 = LU.mass_lookup_indexed.launches
    waves0 = engine.stats.waves
    t0 = time.perf_counter()
    engine.run()
    _sync(device)
    dt = time.perf_counter() - t0
    launches = LU.mass_lookup_indexed.launches - launches0

    st = engine.stats
    served = st.queries - warm
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    print(f"lookup backend={st.backend} "
          f"fixed_size_memory={engine.backend.fixed_size_memory} "
          f"device={where}")
    print(f"memories: {st.documents} resident "
          f"({st.ingest_waves} varlen ingest waves = "
          f"{st.ingest_dispatches} dispatches, {st.pinned} pinned), "
          f"{engine.resident_bytes/2**20:.2f} MiB; ingest {ingest_s:.3f} s")
    print(f"serve: {served} queries in {dt:.3f} s "
          f"({served/max(dt, 1e-9):.0f} lookups/s) — "
          f"{st.waves} waves = {st.lookup_dispatches} dispatches "
          f"({st.queries_per_wave:.1f} queries/wave, "
          f"{st.multi_memory_waves} mixed-memory waves)")
    if st.shed:
        print(f"shed: {st.shed} (policy={engine.shed_policy})")
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            f.write(st.to_json())
        print(f"stats written to {args.stats_json}")
    if st.lookup_dispatches != st.waves:
        raise RuntimeError(f"{st.lookup_dispatches} lookup dispatches for "
                           f"{st.waves} waves: want one per wave")
    return {"lookups_per_s": served / max(dt, 1e-9), "serve_s": dt,
            "ingest_s": ingest_s,
            "resident_mib": engine.resident_bytes / 2**20,
            "waves": st.waves, "timed_waves": st.waves - waves0,
            "lookup_dispatches": st.lookup_dispatches,
            "multi_memory_waves": st.multi_memory_waves,
            "lookup_launches": launches, "engine": engine,
            "doc_ids": doc_ids, "queries": queries,
            "timed_uid0": timed_uids[0]}


def parse_args(argv: Optional[Sequence[str]] = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="generate",
                    choices=["generate", "stream", "spec", "retrieve",
                             "lookup"])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--n-layers", type=int, default=None,
                    help="cut the model to this many layers, whole repeats"
                         " of its layer pattern (a model too large for one"
                         " card; widths unchanged)")
    ap.add_argument("--backend", default=None,
                    choices=["linear", "gated_linear", "softmax"],
                    help="linear (paper §3; the default), gated_linear "
                         "(paper §4 decay) or softmax (the KV-cache "
                         "baseline), zamba2-7b's shared attention "
                         "included; not for rwkv6-1.6b, which has no "
                         "attention layer")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen-len", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 = categorical sampling")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--max-queue", type=int, default=None,
                    help="bound the admission queue; a full queue sheds"
                         " per --shed-policy (status='shed')")
    ap.add_argument("--shed-policy", default="reject_new",
                    choices=["reject_new", "evict_lowest"])
    ap.add_argument("--stats-json", default=None, metavar="PATH",
                    help="write the stream, spec or lookup stats (the "
                         "lifecycle and speculative counters included) to "
                         "PATH as JSON")
    # stream mode (continuous batching)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--segment-len", type=int, default=8)
    ap.add_argument("--n-requests", type=int, default=16)
    ap.add_argument("--arrival-rate", type=float, default=0.0,
                    help="requests per decode step (0 = all at t=0)")
    ap.add_argument("--admission", default="auto",
                    choices=["auto", "batched", "per_request"],
                    help="prompt ingestion: bucket-padded batched varlen"
                         " prefill + chunked ingest (batched) vs prefill"
                         " of each request alone (per_request)")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="max prompt tokens per ingest pass (rounded up to"
                         " a power of two); longer prompts are chunked and"
                         " interleaved with decode segments")
    ap.add_argument("--ingest", default="auto",
                    choices=["auto", "recurrent", "parallel"],
                    help="continuation chunks through the recurrent decode"
                         " kernel with per-row lengths (recurrent; auto) "
                         "or the plain chunked prefill forms (parallel)")
    ap.add_argument("--prefix-cache", default="off",
                    choices=list(PREFIX_CACHE),
                    help="stream mode: the content-hash prefix cache; a "
                         "cached prompt prefix admits as one state copy "
                         "plus its suffix's ingest (fixed-size states) or "
                         "reuses refcounted KV blocks (softmax); 'on' "
                         "raises where the backend cannot cache, 'auto' "
                         "turns it off there")
    ap.add_argument("--cache-bytes", type=int, default=64 << 20,
                    help="stream mode: the prefix cache's byte budget (LRU "
                         "eviction)")
    ap.add_argument("--fork", type=int, default=1, metavar="N",
                    help="stream mode: n-best, each prompt encoded once "
                         "and forked into N continuations (uids "
                         "uid..uid+N-1)")
    ap.add_argument("--degrade-threshold", type=float, default=None,
                    help="stream mode: waiting requests per slot beyond "
                         "which the engine degrades (speculation off, "
                         "half ingest chunks); None disables")
    # durability (stream mode)
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="write-ahead request journal: every submit, "
                         "cancel and ack is fsync'd to PATH before it takes"
                         " effect; a restarted engine replays it")
    ap.add_argument("--journal-dir", default=None, metavar="DIR",
                    help="fleet mode: per-replica journals under DIR")
    ap.add_argument("--checkpoint-dir", default=None, metavar="DIR",
                    help="engine checkpoints (slot states + scheduler)"
                         " under DIR; atomic, keep-N retention")
    ap.add_argument("--checkpoint-every", type=int, default=4,
                    metavar="N", help="checkpoint every N scheduler"
                    " events (0 = only on graceful shutdown)")
    ap.add_argument("--recover", action="store_true",
                    help="restore the newest checkpoint, replay the"
                         " journal past it, and finish the stranded"
                         " work instead of submitting new requests")
    ap.add_argument("--replicas", type=int, default=1,
                    help="fleet mode: replicas per backend group"
                         " (heartbeat + circuit-breaker failover)")
    ap.add_argument("--backends", default=None, metavar="A,B,...",
                    help="serve a fleet (stream mode): comma-separated "
                         "backend groups of fleet_demo_config (linear, "
                         "gated_linear, softmax, mamba2, rwkv6), one slot "
                         "group each behind a single admission queue")
    ap.add_argument("--crash-at-event", type=int, default=None,
                    metavar="N", help="chaos: hard-kill the engine at"
                    " scheduler event N (exit 3; restart with"
                    " --recover)")
    # spec mode (speculative decoding)
    ap.add_argument("--speculate-k", type=int, default=6,
                    help="draft tokens per verify round")
    ap.add_argument("--draft", default="ngram",
                    choices=["ngram", "model", "replay"],
                    help="draft provider: prompt-lookup n-grams (free), a "
                         "second model with its own slot states, or the "
                         "plain run's own tokens (acceptance near 1)")
    # lookup mode (memory serving)
    ap.add_argument("--n-docs", type=int, default=128,
                    help="lookup mode: memories to ingest")
    ap.add_argument("--doc-len", type=int, default=64,
                    help="lookup mode: tokens per synthetic document")
    ap.add_argument("--n-queries", type=int, default=1024,
                    help="lookup mode: queries in the storm")
    ap.add_argument("--wave-size", type=int, default=64,
                    help="lookup mode: max requests per query wave")
    ap.add_argument("--lookup-backend", default="linear",
                    choices=["linear", "softmax"],
                    help="fixed-size k×k memories through the indexed "
                         "lookup kernel vs the full-hidden-state "
                         "softmax baseline")
    ap.add_argument("--load", default=None, metavar="PATH",
                    help="lookup mode: pin a persisted DocumentStore "
                         "(.npz) instead of synthesising documents")
    args = ap.parse_args(argv)
    if args.mode == "lookup" and args.load and \
            args.lookup_backend != "linear":
        ap.error(
            f"--load pins a persisted compressed (k×k) DocumentStore, "
            f"which only the fixed-size linear backend can serve; "
            f"--lookup-backend {args.lookup_backend} keeps full "
            f"hidden states resident and cannot pin compressed "
            f"memories (drop --load and ingest documents instead)")
    return args


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = parse_args(argv)
    if args.mode == "lookup":
        lookup(args)
    elif args.mode == "stream":
        return stream(args)["exit_code"]
    elif args.mode == "spec":
        spec(args)
    elif args.mode == "retrieve":
        retrieve(args)
    else:
        generate(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
