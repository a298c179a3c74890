"""Serving entry point (port of ``repro/launch/serve.py``, modes
``generate`` and ``lookup``).

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
PyTorch at O(pos) per token.

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
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-0.6b \\
      --smoke --device cpu --backend softmax --prompt-len 16 --gen-len 8
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lookup \\
      --n-docs 8192 --doc-len 750 --n-queries 131072 --wave-size 256
  PYTHONPATH=src python -m repro_torch.launch.serve --mode lookup \\
      --device cpu --n-docs 16 --doc-len 24 --n-queries 64 --wave-size 16

Runs on CUDA unless ``--device cpu`` is given; weights, prompts,
documents and queries are random, drawn from ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.device import resolve_device
from repro_torch.kernels.flash_attention import ops as FA
from repro_torch.kernels.fused_recurrent import ops as FR
from repro_torch.kernels.lookup import ops as LU
from repro_torch.models import lm


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generate(args) -> Dict[str, Any]:
    """Prefill + generation on one static batch. Prints the lines of the
    JAX package's ``generate`` and returns the measured numbers, the
    generated tokens, and the launches of the backend's kernels:
    ``prefill_launches`` of B10 in the timed prefill (softmax; 0 for the
    linear family, whose prefill is plain PyTorch) and
    ``decode_launches`` of B1 or B7 in the timed generation (0 under
    softmax, whose cache read is plain PyTorch)."""
    device = resolve_device(args.device)
    cfg = (get_smoke_config(args.arch) if args.smoke
           else get_config(args.arch))
    cfg = cfg.with_backend(args.backend)
    backend = cfg.attention_backend
    prefill_kernel = FA.fwd if backend == "softmax" else None
    decode_kernel = {"linear": FR.decode_linear,
                     "gated_linear": FR.decode_gated}.get(backend)
    # independent generator streams: params / prompt / sampling
    gens = [torch.Generator(device=device).manual_seed(args.seed * 4 + i)
            for i in range(3)]
    g_params, g_prompt, g_sample = gens
    params = lm.cast_params(lm.init_params(g_params, cfg),
                            lm.dtype_of(cfg.dtype))

    b, t_p, t_g = args.batch, args.prompt_len, args.gen_len
    prompt = torch.randint(0, cfg.vocab_size, (b, t_p), generator=g_prompt,
                           device=device)

    def count(kernel) -> int:
        return 0 if kernel is None else kernel.launches

    # warm-up, untimed: one prefill and two decode steps, so the kernels
    # are built and loaded and the library has picked its matmul kernels
    # before the clock starts
    logits, states = lm.prefill(params, prompt, cfg)
    states = lm.pad_decode_state(states, cfg, max_len=t_p + 2)
    lm.generate(params, states, torch.argmax(logits, -1), t_p, 2, cfg)
    _sync(device)

    prefill0 = count(prefill_kernel)
    t0 = time.perf_counter()
    logits, states = lm.prefill(params, prompt, cfg)
    states = lm.pad_decode_state(states, cfg, max_len=t_p + t_g)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    prefill_launches = count(prefill_kernel) - prefill0

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
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "cpu")
    kernels = (f"({decode_kernel.__name__})" if decode_kernel else
               "(plain KV-cache read; prefill kernel flash_attention_fwd)")
    print(f"arch={cfg.name} backend={backend} "
          f"decode_kernel={cfg.decode_kernel} {kernels} device={where}")
    print(f"prefill {t_p} toks x{b}: {t_prefill*1e3:.0f} ms")
    print(f"decode  {t_g} toks x{b}: {t_decode/n_dec*1e3:.2f} ms/tok "
          f"({b*n_dec/t_decode:.0f} tok/s)")
    print(f"decode state: {state_mib:.1f} MiB "
          f"({'O(1) in context' if cfg.fixed_state_decode else 'KV cache'})")
    return {"prefill_ms": t_prefill * 1e3,
            "decode_ms_per_token": t_decode / n_dec * 1e3,
            "tokens_per_s": b * n_dec / t_decode,
            "state_mib": state_mib, "tokens": out,
            "prefill_launches": prefill_launches,
            "decode_launches": decode_launches}


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
                    choices=["generate", "lookup"])
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--backend", default="linear",
                    choices=["linear", "gated_linear", "softmax"],
                    help="generate mode: linear (paper §3), gated_linear"
                         " (paper §4 decay) or softmax (the KV-cache "
                         "baseline)")
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
                    help="write the lookup stats to PATH as JSON")
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
    else:
        generate(args)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
