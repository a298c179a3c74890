#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. Device: the card's name and power limit, and the build of every CUDA
   kernel of the port from the sources in this checkout; each kernel's
   registers, spills and ptxas's notes on serialized wgmmas; the HGMMA
   instructions in B10's, B8/B9's and B2/B3's libraries (their bf16
   routes run on the tensor cores), and the UBLKCP instructions in the
   lookup library by opcode (B4/B5 copy each state into shared memory by
   ``cp.async.bulk``, B6's bulk route in and back out), which must not
   spill, nor may B1's and B7's (their state in registers at every D),
   nor B10's (at every D, 112 included); the registers and spills of
   every D = 112 instantiation (B1, B7, B10, B2/B3, B8/B9) and of the
   exclusive backward's at every D, printed (at D = 16 and 64 its two
   launches take two rows a block, ``exclusive_dq_tc`` and
   ``exclusive_dkv_tc``, which must not spill).
2. Each kernel against its plain PyTorch version on the card, at the
   main path's shapes and at the smoke width (B1 and B7 also 64 tokens
   wide under per-row lengths, the stream path's ingest; B10 at each D
   it takes, with K/V of fewer heads than q, and against JAX's oracle;
   B2, B3, B8 and B9 in bf16 at T not a multiple of their 64-token
   tile, D = 16 and 128, B3's and B9's launches each on its own, B2
   and B8 (inclusive and exclusive + u) with a final state far from
   symmetric; B8/B9 at the decay clamp and at each route's
   ``min_log_decay`` limit against ``gla_scan``, and a value past the
   limit refused; B4 and B5 on both
   routes, even K by bulk copies (K = 256 through the ring, M = 130 in
   tiles of 4, K % 4 == 2) and odd K direct, and rows outside the store
   NaN; B6 on both routes, its state bit for bit, at the paper's width,
   the LM's 128 × 128, 256 × 256 (direct), rows of 200 bytes (bulk) and
   an odd Dk·Dv (direct)); B10's lse route (the softmax training
   forward) at every check, the training path's T = S = 1024 included,
   its o bit for bit the null-lse route's and
   its log-sum-exp against the plain version's (fp32 1e-5, bf16 1e-4,
   relative to max(1, |lse|)), also through the wrapper's padding. The
   MoE and vision paths' new shapes: B1 at N = 256 and 512 rows (fp32
   and bf16), B10 at 64 q heads over 8 and over 4 kv heads. The dense
   family's: B1 (normalised and not, varlen, W = 1, 8 and 64) and B7 at
   D = 64 and 96 and B1 at yi-34b's 448 rows, fp32 and bf16, the state
   bit for bit; B10 at D = 96 on both routes (T = S = 512, ragged T and
   S, groups of 6 and 7, through the wrapper) and at 32 over 32, 48 over
   8 and 56 over 8 heads. The training kernels at the head dims 96 and
   64 (phi3-mini-3.8b; musicgen-large and RWKV-6): B2, B3, B8 (inclusive,
   and exclusive + u) and B9 in fp32 and bf16 at T not a multiple of
   their tiles and at the training rows (batch 8 x 32 heads, T =
   1,024), B3's and B9's launches each on its own, the final states far
   from symmetric, through the wrappers, B8/B9 at the clamp and at each
   route's limit; B8's exclusive route with a bonus u per head at
   rwkv6-1.6b's prefill shape (batch 8 x 32 heads, T = 512, D = 64) and
   at the clamp against ``gla_scan``. zamba2-7b's: B1 and B7 at D = 112
   (448 threads; the serving rows, batch 8 x 32 heads, and the smoke
   rows) with the state bit for bit, B10 at D = 112 on both routes (32
   over 32 heads, ragged T and S, groups of 6 and 7, the wrapper), and
   B8's inclusive route with its state at the SSD prefill's shape
   (batch 8 x 112 heads, T = 512, N = 64, zamba2's decays) in fp32 and
   bf16, o's error printed as a share of its limit. This slice's: B2,
   B3, B8 and B9 at D = 112 as at 96 and 64; the exclusive backward
   (``bwd_exclusive``: its dq launch with du per row, its dk/dv launch
   with dg) at rwkv6-1.6b's training shape (batch 8 x 32 heads, T =
   1,024, D = 64, u per head drawn at random) in fp32 and bf16 against
   its plain version, each launch alone, and under autograd against
   autograd of the plain exclusive forward, du included; at ragged T
   and D = 16, 96, 112, 128; at 1, 3 and 255 rows (the last block of
   two rows holding one) with u per head and with one u for every row;
   and B8's exclusive bf16 o at T = 1,024 with the decays at and near the
   clamp, as a share of its limit.
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
   kernels timed beside their bounds, plain versions and library calls
   (B4 also L2-warm and at the paper's width, with gather + ``bmm``; B6
   also at the LM's 128 × 128 in bf16, with ``baddbmm`` + ``bmm``), and
   the launch floor of that timing harness.
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
   heads) and with K/V of 16 heads, and with its lse.

15. The engine slice (continuous batching, ``DecodeEngine``): 2 layers at
   qwen3-0.6b's full widths in fp32, linear, gated and softmax, 4 slots,
   segments of 4 steps; ingest chunks of 8 with prompts of 1 to 40
   tokens and one request of a single token, then chunks of 64 (the
   stream path's) with prompts of up to 200 tokens, whose continuation
   chunks run B1/B7 64 tokens wide. The engine through B1/B7 (decode
   under per-slot masks, chunked ingest with per-row lengths) against
   the same engine under ``decode_kernel="reference"``: completions
   token for token and the stats identical; each request run alone
   (``lm.prefill`` + ``lm.generate``) gives the same tokens; B1/B7
   launched layers x (segment_len x segments + ingest chunks) times and
   no other kernel. Softmax: admission waves through B10 against the
   engine with B10's plain version in every prefill, B10 launched
   layers x (waves + 1-token prefills) times, per-step ingest and gated
   cache rows in plain PyTorch.
16. The stream main path: ``repro_torch.launch.serve --mode stream`` on
   qwen3-0.6b cut to 8 of its 28 layers (``SERVE_TIME_LAYERS``, for the
   run's time) in bf16 (random weights from seed 0),
   linear, gated and softmax: 8 slots, segments of 8, 32 requests of 512
   prompt tokens (7 continuation chunks of 64 each; softmax admits each
   prompt whole, ``--prefill-chunk 512``, through B10) and 8 or 64
   generated tokens, 0.25 arrivals per decode step; tokens/s, ms per
   segment, slot utilisation, mean latency, the admission stats, the
   launches against the formula above, the decode state's MiB beside the
   linear state's, every request complete, and a profile of two decode
   steps of a segment (device busy share).
17. The softmax training slice as phase 9: 2 layers at full width, B10
   (with its lse) forward and the plain blockwise flash backward against
   ``attention_kernel=False``, in fp32 (loss, every gradient leaf, one
   AdamW step) and in bf16 compute (loss and every leaf).
18. The softmax training main path as phase 10: ``launch/train.py
   --backend softmax``, batch 8 x seq 1,024, 8 steps; B10 launches per
   step (forward and remat recompute: 56), a profile of one step by
   kind, and the plain flash backward timed alone (its share of the
   step).
19. The retrieve main path: ``serve --mode retrieve --batch 4096`` at the
   paper's width (k = 100, n = 750): queries/s, the store's MiB against
   the raw hidden states', 256 sampled answers against Hᵀ(Hq) in fp64.
20. The MoE slice: one MoE layer of deepseek-moe-16b and of
   qwen3-moe-235b-a22b at full width in fp32, ``moe_apply`` against
   ``moe_dense_oracle`` where nothing drops, the routing of phase 21's
   prefill tokens against the CPU's, and the dispatch's kept set (at
   the prefill's capacity, and at a factor of 0.5 where pairs drop)
   equal to the CPU's on the same expert ids; then deepseek-moe-16b (2
   layers) and qwen3-moe-235b-a22b (1 layer; 94 do not fit one card) at
   full width in fp32 under linear, gated_linear and softmax: prefill +
   16 greedy steps through B1/B7 and B10 against
   ``decode_kernel="reference"`` (tokens identical, logits within 1e-4).
21. The MoE generate main path: ``serve --arch deepseek-moe-16b`` at full
   width and depth (28 layers, parameters built in bf16), linear, batch
   8, prompt 512, 64 tokens: prefill ms, ms/token against the step's
   bound by bytes, the state's MiB, B1 launched 28 x 63 times in the
   timed generation (+ 28 x 2 in the warm-up), a profile of 4 decode
   steps (device busy share, the largest device operations).
22. MoE training: deepseek-moe-16b at full width, 2 layers, batch 2 x
   512, through B2/B3 against ``attention_kernel=False`` in fp32 (loss,
   aux, every gradient leaf, one AdamW step) and in bf16 compute (loss,
   every leaf) at phase 9's tolerances; then ``launch/train.py --arch
   deepseek-moe-16b --n-layers 2``, batch 8 x 1,024, 4 steps: ms/step,
   peak memory, finite losses and aux, B2/B3 launches.
23. The cross slice: llama-3.2-vision-90b at full width, one unit of its
   pattern (4 attn + 1 cross), fp32, batch 2, 6,404 image tokens, xgate
   0.5: kernels against the reference route under linear and softmax
   (tokens identical, logits within 1e-4), and one cross layer's linear
   lookup against the paper's identity in fp64 (normwise 1e-4).
24. The vision generate main path: ``serve --arch llama-3.2-vision-90b
   --n-layers 10`` (bf16), batch 4, prompt 512, 64 tokens, linear then
   softmax: prefill ms with the memory's encode, ms/token, B1 / B10
   launches, the cross memory per layer and sequence (linear C and z
   against softmax K and V).

25. The dense slice: yi-34b, internlm2-20b, phi3-mini-3.8b and
   musicgen-large (layernorm, GELU) at full width, 2 layers, fp32,
   under linear, gated_linear and softmax: prefill + 16 greedy steps
   through B1/B7 and B10 against ``decode_kernel="reference"`` (tokens
   identical, logits within 1e-4).
26. The dense generate main path: ``serve --arch <id>`` at full width
   in bf16, batch 8, prompt 512, 64 tokens: phi3-mini-3.8b and
   musicgen-large under all three backends, yi-34b under linear and
   softmax, cut to 8, 12 and 4 layers (``DENSE_CUTS``: the run's time;
   the memory the earlier phases hold printed first; any depth cut to
   what fits, and printed, if the card cannot hold a config whole):
   prefill ms, ms/token beside the step's bound by bytes, B1/B7 or B10
   launches exactly layers x steps, a profile of 4 decode steps (busy
   share), both backends' decode-state MiB, peak memory; yi-34b's linear
   state against its KV cache and their crossover; B1, B7 and B10 timed
   at each config's shapes beside their bounds, plain versions and
   (B10) ``scaled_dot_product_attention``.
27. The dense stream path: ``serve --mode stream --arch musicgen-large
   --backend linear --n-layers 12`` at phase 16's traffic: layernorm and B1 at D = 64
   under per-slot masks and per-row ingest lengths, its launches
   exactly as phase 16's formula.

28. The dense training slices: phi3-mini-3.8b (head dim 96) and
   musicgen-large (64) at full width, 2 layers, under linear and
   gated_linear, as phases 9 and 11: B2/B3 or B8/B9 against
   ``attention_kernel=False`` in fp32 (loss, every gradient leaf, one
   AdamW step) and in bf16 compute (loss, every leaf).
29. The dense training main path: ``launch/train.py --arch <id>`` for
   phi3-mini-3.8b and musicgen-large under linear and gated_linear,
   bf16 compute, fp32 master, remat per layer, batch 8 x 1,024, 6 steps,
   the depth cut in whole layers to what fits beside the memory the
   earlier phases hold and to ``TRAIN_TIME_LAYERS`` (8 and 12 layers:
   the run's time; printed): ms/step, tokens/s, peak memory against
   the reckoning, finite losses, launches exactly layers x steps (the
   forward kernel twice), a profile of one step by kind; the kernels
   timed at each config's shape beside their bounds and plain versions.
30. The rwkv6 slice: rwkv6-1.6b at full width, 2 layers, fp32, a bonus u
   drawn per head: prefill through B8's exclusive route + 16 greedy
   steps against the prefill's plain version (tokens identical, logits
   within 1e-4) (its training: phase 36).
31. The rwkv6 generate main path: ``serve --arch rwkv6-1.6b`` at full
   width and depth (24 layers) in bf16, batch 8, prompt 512, 64 tokens:
   exactly 24 B8 launches per prefill and no other kernel, prefill ms,
   ms/token beside the step's bound by bytes, the state's MiB, a profile
   of 4 decode steps, and B8's exclusive route timed at the prefill's
   shape beside its bounds and plain version.
32. The rwkv6 stream path: ``serve --mode stream --arch rwkv6-1.6b`` at
   phase 16's traffic: per-request admission, B8 once per layer and
   prefill, every request its budget.

33. The zamba2 and feature-gate slices: zamba2-7b at full width cut to
   one pattern unit (5 Mamba-2 blocks + 1 shared attention), fp32, under
   linear, gated_linear and softmax, and qwen3-0.6b at full width, 2
   layers, with the paper's feature gate under linear and gated_linear:
   prefill + 16 greedy steps through the kernels (B8 in each Mamba-2
   prefill, B1/B7 or B10 in the attention) against the reference route
   (tokens identical, logits within 1e-4) (its training: phase 36).
34. The zamba2 generate main path: ``serve --arch zamba2-7b --n-layers
   12`` at full width (``ZAMBA_SERVE_LAYERS``: 2 of its 13 units, the
   tail dropped, to keep the whole run short; bf16), batch 8, prompt
   512, 64 tokens, under linear, gated_linear and softmax: B8 exactly 10
   launches a prefill, B1/B7 2 a decode step or B10 2 a prefill, and no other kernel; prefill ms, ms/token beside the step's bound by bytes, the
   state (Mamba-2 and attention) against the KV cache, peak memory, a
   profile of 4 decode steps; then B1, B7 and B10 at D = 112 and B8 at
   the SSD prefill's shape timed beside their bounds, plain versions and
   (B10) ``scaled_dot_product_attention``.
35. The zamba2 stream path: ``serve --mode stream --arch zamba2-7b
   --n-layers 12`` under linear at phase 16's traffic: per-request admission, B8 once per
   Mamba-2 layer and prefill, B1 once per attention site and decode
   step, every request its budget.

36. The zamba2 and rwkv6 training slices: zamba2-7b at full width, one
   unit (5 Mamba-2 + the shared attention at D = 112), under linear,
   gated_linear and softmax, and rwkv6-1.6b at full width, 2 layers, u
   drawn at random (its init is 0), in fp32 and in bf16 compute, through
   the kernels (B2/B3, B8/B9 or B10 in the attention, B8/B9 in each
   Mamba-2 block, B8's exclusive route and the exclusive backward in each
   RWKV-6 block) against ``attention_kernel=False``: the loss (phase 9's
   limits), and every gradient leaf of one step with the plain route
   taking the kernel route's attention outputs, as phase 22 pins the MoE
   routing (``pinned_training_slice``), launches exact.
37. The zamba2 training main path: ``launch/train.py --arch zamba2-7b
   --n-layers N`` under linear, gated_linear and softmax, fp32 master,
   bf16 compute, remat per unit, batch 8 x 1,024, 6 steps, the depth cut
   by phase 29's rule to whole units (2 of 13, the tail dropped;
   printed): ms/step,
   tokens/s, peak memory against the parameters, gradients and moments,
   launches exactly per step and kind of layer, a profile of one step
   (the kernels' share of device time).
38. The rwkv6 training main path: ``launch/train.py --arch rwkv6-1.6b``
   whole, as phase 37; then B2, B3, B8 and B9 at zamba2's shared
   attention (batch 8 x 32 heads, T = 1,024, D = 112) and B8's exclusive
   route and the exclusive backward at rwkv6's (D = 64) timed beside
   their bounds and plain versions; B8 and B9 (inclusive) at the same
   rows, T and D (musicgen-large's training shape), the exclusive
   backward's dq, dk/dv and whole each printed beside B9's.

39. The paper's QA experiment (§5) at its published widths (k = 100,
   embeddings 100, batch 64, fp32): (a) one Adam step of each variant
   (none, linear, gated_linear, softmax and the §6 second_order) on the
   card against the same step on the CPU from the same parameters and
   batch: the loss within rtol 1e-5, every gradient leaf and every
   parameter after the step within normwise 1e-4; (b) ``run_figure1``
   and ``train_qa("second_order")`` at their defaults, cut from 400 to
   ``QA_STEPS`` steps (printed): each variant's validation curve, best
   accuracy and ms a step, finite losses and the last validation loss
   below the first; (c) the paper's document length, 748 tokens, under
   linear and softmax: ms a training step, encode ms, lookup µs for a
   wave of 64 x 4 queries, and the bytes a document holds (C 40,000
   against H 299,200). No kernel: JAX's QA is jnp.
40. Checkpointed training: ``launch/train.py``'s ``build`` and
   ``TrainLoop`` on qwen3-0.6b under linear (B2/B3) at full width cut to
   4 layers, batch 8 x 1,024, async saves every 4 steps into a directory
   under ``build/`` (removed at the end): run A 12 steps; run B crashed
   at step 8 by ``--fail-at-step`` and resumed by a fresh loop at 8, its
   parameters, AdamState and losses bit for bit run A's; a preemption
   request at step 3 (a blocking save, a resume at 3 bit for bit); the
   bytes on disk, the host ms inside ``save``, the writer's GB/s, the
   restores' seconds and ms a step with a save and without.

41. The spec slice: qwen3-0.6b at full width, 2 layers, fp32, under
   linear, gated_linear and softmax: the ``DecodeEngine`` with plain,
   speculative (K = 6) and K = 3 requests and a draft of the plain run's
   tokens with every ninth changed (windows accepted whole or cut at
   every point), one speculative request preempted and resumed, through
   the kernels (the K+1-token verify and the batched varlen rewind
   through B1/B7, B10 in admission) in lock step with the same engine
   under ``decode_kernel="reference"``: the engine state within 1e-5
   after every step, completions and stats identical, every token plain
   greedy's; the slots not speculating bit for bit through every round,
   the speculative ones through every segment; launches exact.
42. The spec main path: ``serve --mode spec`` on qwen3-0.6b cut to 8
   of its 28 layers (``SERVE_TIME_LAYERS``) in fp32, 8 slots, 16
   requests of 128 prompt tokens, 64 tokens each, K = 6: the ``ngram``
   draft under all three backends,
   ``replay`` (the plain run's tokens) and ``model`` (a second
   qwen3-0.6b from seed 1) under linear; spec tokens equal plain greedy
   for every request, launches exactly layers x (segment steps + ingest
   chunks + verify rounds + rewind passes) plus the model draft's own;
   acceptance, rounds, rewinds, tokens per round, spec against plain
   tokens/s.
43. The lifecycle main path: the engine on qwen3-0.6b cut to 8 of 28
   layers in fp32, linear and softmax, 8 slots, 32 requests (JAX's mix, 128
   prompt tokens): an explicit preempt and resume, a NaN poisoned into
   a busy slot (found by the finite probe, the slot quarantined, the
   request retried from its checkpoint), a sabotaged speculative round
   (rewinds, no token moves), cancels, a deadline, both shed policies
   and a degradation flip: every request's tokens the clean run's, the
   counts exact, launches exactly ``stream_launches`` a run.
44. The prefix cache main path: the engine on qwen3-0.6b cut to 8 of
   28 layers in fp32, linear and softmax, 8 slots, segments of 8,
   chunks of 64, 16 requests at step 0 of one seeded 192-token prefix
   and a 64-token suffix each, 16 tokens each: off (no cache), cold (an
   empty 1 GiB cache), warm (``reset``: the cache survives) and, under
   linear, reloaded (``save_cache``, a fresh engine, ``load_cache``):
   every request's tokens the same in every run, the counts exactly the
   CPU dry run's (cold 8 misses and 8 hits of 192 tokens, warm 16 hits,
   no insert, no eviction, no B10 launch and no varlen prefill; softmax
   copies 24 and 48 blocks), launches exactly ``stream_launches`` a run,
   every paged block's refcount 0 and every entry bit for bit after each
   run; the cache's bytes for the prefix flat under linear (one entry)
   and one block per 64 tokens under softmax; each run's seconds and
   tokens/s. Then ``serve --mode stream --prefix-cache on --fork 3
   --slots 8 --n-requests 8 --prompt-len 256 --gen-len 16``: 24
   completions off 8 prefills and 16 forks, each member's tokens its
   primary's.
45. Engine durability: the engine on the full 28-layer qwen3-0.6b in
   fp32, linear and softmax, 8 slots, segments of 8, chunks of 64, 32
   requests of JAX's mix (128 prompt tokens, 32 or 4 generated), a
   write-ahead journal and checkpoints every 4 events under ``build/``
   (removed at the end): uncrashed; killed at events 5 and 7 and
   ``DecodeEngine.recover``-ed from the journal and the newest
   checkpoint; killed at event 5 and recovered from the journal alone:
   every uid's tokens the uncrashed run's (else the top-2 margin), one
   ack per uid in each journal file, the decode state exactly 8 slots of
   the predicted bytes, each drive's launches exactly ``stream_launches``
   (a recovery's less what its checkpoint restored); the checkpoint and
   journal bytes, save, restore, replay and append times. Then ``serve
   --mode stream --journal --checkpoint-dir --crash-at-event 5`` (exit
   code 3) and ``--recover`` (each of 32 requests acked once).
46. The fleet and the lookup engine's durability: a ``FleetEngine`` of
   qwen3-0.6b whole in fp32 under linear, gated_linear and softmax, 2
   replicas of 4 slots a group, 24 requests; replica 0 of linear
   crashes, fails over, and every uid completes once with its group's
   single-engine tokens; a fleet checkpoint and ``FleetEngine.recover``
   reach them too; launches exactly ``fleet_launches``. ``serve --mode
   stream --backends mamba2,rwkv6 --replicas 2`` at the demo configs
   (B8). A ``LookupEngine`` at k = 100 over 1,024 documents of 750
   tokens: its checkpoint restores the store bitwise and 16,384 queries
   in waves of 256 answer bitwise alike; ``HedgedLookup`` over 2
   replicas, unkilled and with one killed (8,192 hedges), the same
   answers; B4 once a wave.

47. The sharded paths, two ranks on the one card, each a process this
   phase spawns, in a gloo group with CUDA tensors (NCCL refuses two
   ranks on one device; gloo's point-to-point goes through host memory):
   first each collective the checks reach (``dist.all_reduce`` and the
   functional all-gather, reduce-scatter, all-reduce and all-to-all
   DTensor redistributes through) is tried on a CUDA tensor by a pair of
   ranks of its own, since a gap in gloo's CUDA path can crash a process;
   a check that reaches one that gloo cannot run runs at world size 1
   over NCCL instead, which the phase prints. Then: a train step (``lm_loss`` and
   every gradient leaf) of qwen3-0.6b at full width, 2 layers, linear,
   bf16, on meshes (1, 2) and (2, 1) against one rank at phase 9's bf16
   limits, B2/B3 launches per rank equal to one rank's; prefill + 16
   greedy steps under linear and softmax on (1, 2) in fp32, the tokens
   identical to one rank's and B1 / B10 launches per rank equal to one
   rank's; deepseek-moe-16b's MoE layer through ``moe_apply_shard_map``
   (32 experts a rank) against the einsum path within 1e-5, the routing
   identical; GPipe, 2 stages of 2 layers, against the plain loss and
   gradients; parameters saved on (1, 2) and restored on (2, 1) bit for
   bit.

Each main path (phases 4, 6, 8, 10, 12, 14, 16, 18, 19, 21, 22's
``launch/train.py`` run, 24, 26, 27, 29, 31, 32, 34, 35, 37, 38, 40, 42,
43, 44, 45, 46 and 47, in each rank) is driven with
every kernel's launch count set to 0 just before it and read just after.

The last line is {"ok": true, "device": {...}}; the line before it the
kernels' JSON record; before that the card's name and power limit.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet) and the least time of a launch:
# one reckoning with the dry run's roofline (launch/roofline.py)
from repro_torch.launch.roofline import (  # noqa: E402
    HBM_BW as PEAK_BYTES_PER_S, PEAK_FLOPS_BF16 as PEAK_BF16_TC_FLOPS,
    PEAK_FLOPS_FP32 as PEAK_FP32_FLOPS, bound)
# the lookup kernels' outputs against their plain versions: fp32 sums in
# another order (the JAX kernel tests' tolerance)
LOOKUP_TOL = 1e-4


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def sass_text(build, source) -> str:
    """The SASS of ``source``'s built library (cuobjdump --dump-sass)."""
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "--dump-sass",
                           str(build._lib_path(source))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout


def sass_count(build, source, opcode) -> int:
    """Instructions ``opcode`` (HGMMA: wgmma; UBLKCP: cp.async.bulk) in
    the SASS of ``source``'s built library."""
    return sass_text(build, source).count(opcode)


def sass_opcodes(build, source, opcode) -> dict:
    """The same instructions by full opcode (``UBLKCP.S.G``, ...)."""
    import collections
    import re
    return dict(collections.Counter(re.findall(
        rf"\b{opcode}(?:\.\w+)*", sass_text(build, source))))


def spills(log: str) -> list:
    """From ``nvcc -Xptxas=-v`` output: the lines that report a spill."""
    import re
    return [line.strip() for line in log.splitlines()
            if re.search(r"[1-9]\d* bytes spill (stores|loads)", line)]


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


def check_decode_linear(n, d, w, normalize, varlen, gen, dev,
                        dtype=None, bitwise=False) -> float:
    """Kernel vs plain version, q/k/v in ``dtype`` (bf16 by default; o
    within one bf16 ulp, fp32 o within rtol 1e-5); with ``bitwise``, S
    and z must equal the plain version's bit for bit. Returns the
    largest |o difference|."""
    import torch
    from repro_torch.kernels.fused_recurrent import ops, ref
    dtype = dtype or torch.bfloat16
    x = decode_inputs(n, d, w, dtype, gen, dev)
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
    tag = (f"n={n} d={d} w={w} normalize={normalize} varlen={varlen} "
           f"{str(dtype).split('.')[-1]}")
    torch.testing.assert_close(s_k, s_r, rtol=1e-5, atol=1e-6, msg=tag)
    if dtype == torch.float32:
        torch.testing.assert_close(o_k, o_r, rtol=1e-5, atol=1e-6, msg=tag)
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
    if bitwise and not same:
        raise AssertionError(f"decode_linear {tag}: S or z not bitwise the "
                             f"plain version's")
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


def check_decode_gated(n, d, w, dtype, varlen, decay, gen, dev,
                       bitwise=False) -> float:
    """B7 against its plain version; returns the largest |o difference|.
    S within rtol 1e-6 (positive inputs: no cancellation; with
    ``bitwise``, bit for bit), o within 1e-5 (fp32) or 1 bf16 ulp, lens-0
    rows bitwise unchanged, masked o 0."""
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
    if bitwise and n_diff:
        raise AssertionError(f"decode_gated {tag}: {n_diff} state elements "
                             f"not bitwise the plain version's")
    print(f"  decode_gated {tag}: max|Δo|={err:.3e} (relative {rel:.2e}; "
          f"{ulps:.2f} bf16 ulp), max|ΔS|={d_s:.3e}, {n_diff} of "
          f"{s_k.numel()} state elements not bitwise equal")
    return err


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


def check_lookup_nan_rows(kd, gen, dev) -> None:
    """B4 with rows -1 and N among valid ones: NaN answers for those two,
    the others against the plain version."""
    import torch
    from repro_torch.kernels.lookup import ops as LU, ref as LR
    n, b, m = 32, 8, 3
    store = nonsymmetric(gen, dev, n, kd, kd)
    q = torch.randn((b, m, kd), generator=gen, device=dev)
    rows = torch.tensor([5, -1, 0, 31, n, 7, 5, 2], dtype=torch.int32,
                        device=dev)
    o = LU.mass_lookup_indexed(store, rows, q)
    torch.cuda.synchronize()
    bad = (rows < 0) | (rows >= n)
    if not torch.isnan(o[bad]).all():
        raise AssertionError(f"K={kd}: rows outside the store not NaN")
    torch.testing.assert_close(
        o[~bad], LR.mass_lookup_indexed_ref(store, rows[~bad], q[~bad]),
        rtol=LOOKUP_TOL, atol=LOOKUP_TOL, msg=f"K={kd} valid rows")
    print(f"  mass_lookup_indexed K={kd}: rows -1 and {n} NaN, "
          f"{int((~bad).sum())} others agree")


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
    LOOKUP_TOL (fp32) or 2e-2 (bf16 output), on the route that
    ``ops.decode_route`` names for the shape."""
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
    tag = (f"N={n} Dk={dk} Dv={dv} {str(dtype).split('.')[-1]} "
           f"({LU.decode_route(dk, dv)} route)")
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
    flops, n_bytes = ops.decode_linear_work(x["s"], x["q"], x["k"], x["v"],
                                            z=x["z"], normalize=True)
    return dict(ms=ms, plain_ms=plain_ms, **bound(n_bytes, flops))


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
    flops, n_bytes = ops.decode_gated_work(x["s"], x["q"], x["k"], x["v"],
                                           g)
    return dict(ms=ms, plain_ms=plain_ms, **bound(n_bytes, flops))


def time_lookup_kernels(store, n_live, gen, dev) -> dict:
    """B4 at the lookup main path's wave (B = 256 rows of the served
    store, M = 1), cycling over 16 row sets (64 MiB of distinct states,
    more than the 50 MB L2) so each launch reads its states from device
    memory; the same with one row set on every launch, so that its 4 MB
    of states sit in L2; B4 at the paper's width (B = 256 rows of M =
    PAPER_M = 4 queries into N = 1,024 states of K = PAPER_K = 100),
    cycling over 8 such stores (328 MB) and 16 row sets; B5 at the
    paper's width (N = 256 documents); B6 at N = 256, Dk = Dv = 100,
    fp32, and at the LM's decode shape, N = 128, Dk = Dv = 128, bf16 q, k
    and v, beside ``baddbmm`` + ``bmm`` on fp32 inputs; each over 16
    buffers of inputs for the same reason; and the launch floor, a
    one-element in-place add timed the same way. Together
    the floor, the L2-warm time and the cold one split B4's time into
    launch, latency and transfer."""
    import torch
    from repro_torch.configs.paper_qa import PAPER_K, PAPER_M
    from repro_torch.kernels.lookup import ops as LU, ref as LR
    n_bufs, b, kd = 16, 256, store.shape[-1]
    out = {}

    def b4(store, rows, q, shape, n_stores=1):
        """B4 and its yardsticks over the row sets ``rows`` (and stores)."""
        stores = store if isinstance(store, list) else [store]
        rows_long = [r.long() for r in rows]
        n = len(rows)
        # the mean over the row sets of each wave's work
        works = [LU.mass_lookup_indexed_work(stores[0], r, q) for r in rows]
        flops = sum(f for f, _ in works) / n
        n_bytes = sum(b_ for _, b_ in works) / n
        return dict(
            ms=graph_ms(lambda i: LU.mass_lookup_indexed(
                stores[i % len(stores)], rows[i % n], q,
                block_m=q.shape[1]), 2 * n_bufs),
            plain_ms=graph_ms(lambda i: LR.mass_lookup_indexed_ref(
                stores[i % len(stores)], rows[i % n], q), 2 * n_bufs),
            gather_bmm_ms=graph_ms(lambda i: torch.bmm(
                q, stores[i % len(stores)].index_select(
                    0, rows_long[i % n]).mT), 2 * n_bufs),
            library_ms=None, shape=shape,
            **bound(n_bytes, flops))

    rows = [torch.randint(0, n_live, (b,), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(n_bufs)]
    q = torch.randn((b, 1, kd), generator=gen, device=dev)
    shape = f"N={store.shape[0]} B={b} M=1 K={kd}"
    out["mass_lookup_indexed"] = b4(store, rows, q, shape)
    out["mass_lookup_indexed L2-warm"] = b4(store, rows[:1], q,
                                            shape + ", one row set")

    n, m, kp = 1024, PAPER_M, PAPER_K
    stores = [torch.randn((n, kp, kp), generator=gen, device=dev)
              for _ in range(8)]
    rows = [torch.randint(0, n, (b,), generator=gen, device=dev,
                          dtype=torch.int32) for _ in range(n_bufs)]
    q = torch.randn((b, m, kp), generator=gen, device=dev)
    out["mass_lookup_indexed paper width"] = b4(
        stores, rows, q, f"N={n} (8 stores) B={b} M={m} K={kp}")
    del stores

    n = 256
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
        **bound(*LU.mass_lookup_work(cs[0], q)[::-1]))
    del cs

    def b6(n, d, dtype):
        """B6 and its yardstick, S += k vᵀ by ``baddbmm_`` then o = Sᵀq by
        ``bmm`` (on fp32 copies of q, k and v, made outside the timing)."""
        ss = [torch.randn((n, d, d), generator=gen, device=dev)
              for _ in range(n_bufs)]
        qd, kd_, vd = (torch.randn((n, d), generator=gen, device=dev).to(
            dtype) for _ in range(3))
        q1, k1, v1 = qd.float()[:, None], kd_.float()[:, :, None], \
            vd.float()[:, None]

        def library(i):
            s = ss[i % n_bufs].baddbmm_(k1, v1)
            return torch.bmm(q1, s)

        return dict(
            ms=graph_ms(lambda i: LU.fused_decode(ss[i % n_bufs], qd, kd_,
                                                  vd), 2 * n_bufs),
            plain_ms=graph_ms(lambda i: LR.decode_ref(ss[i % n_bufs], qd,
                                                      kd_, vd), 2 * n_bufs),
            baddbmm_bmm_ms=graph_ms(library, 2 * n_bufs), library_ms=None,
            shape=f"N={n} Dk={d} Dv={d} {str(dtype).split('.')[-1]}",
            **bound(*LU.fused_decode_work(ss[0], qd, kd_, vd)[::-1]))

    out["fused_decode"] = b6(n, kp, torch.float32)        # paper width
    out["fused_decode LM shape"] = b6(128, 128, torch.bfloat16)

    one = torch.zeros(1, device=dev)
    out["launch floor"] = dict(
        ms=graph_ms(lambda i: one.add_(1.0), 2 * n_bufs),
        shape="one-element in-place add")
    return out


def print_lookup_times(times) -> None:
    """One line per timed lookup kernel (and the launch floor)."""
    for name, t in times.items():
        line = f"{name} {t['shape']}: {t['ms'] * 1e3:.2f} us/launch"
        if "plain_ms" in t:
            extra = [f"plain version {t['plain_ms'] * 1e3:.2f} us"]
            if t.get("library_ms") is not None:
                extra.append(f"library call {t['library_ms'] * 1e3:.2f} us")
            if "gather_bmm_ms" in t:
                extra.append(f"gather + bmm (two calls) "
                             f"{t['gather_bmm_ms'] * 1e3:.2f} us")
            if "baddbmm_bmm_ms" in t:
                extra.append(f"baddbmm + bmm (two calls) "
                             f"{t['baddbmm_bmm_ms'] * 1e3:.2f} us")
            extra.append(f"bound {t['bound_ms'] * 1e3:.2f} us by "
                         f"{t['bound_by']}, {t['bytes'] / 1e6:.2f} MB moved")
            line += f" ({'; '.join(extra)})"
        print(line)


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
    returns device ms per step, or None when the profiler saw none. The
    positions are on the device, as ``lm.generate`` passes them: a
    Python int would be copied to the card, and the stream synchronised,
    in every layer."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import lm
    positions = torch.arange(pos, pos + steps, dtype=torch.int32,
                             device=tok.device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        t0 = time.perf_counter()
        for i in range(steps):
            logits, states = lm.decode_step(params, states, tok,
                                            positions[i], cfg)
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
    out = {}
    for name, kern, plain, (ops, n_bytes) in (
            ("linear_attention_fwd",
             lambda i: LA.fwd(q, k, v, chunk=chunk),
             lambda i: LR.chunked_fwd_ref(q, k, v, chunk=chunk),
             LA.fwd_work(q, k, v)),
            ("linear_attention_bwd_dq",
             lambda i: LA.bwd_dq(k, v, do, chunk=chunk),
             lambda i: LR.chunked_bwd_dq_ref(k, v, do, chunk=chunk),
             LA.bwd_dq_work(k, v, do)),
            ("linear_attention_bwd_dkv",
             lambda i: LA.bwd_dkv(q, k, v, do, chunk=chunk),
             lambda i: LR.chunked_bwd_dkv_ref(q, k, v, do, chunk=chunk),
             LA.bwd_dkv_work(q, k, v, do)),
            ("bwd",
             lambda i: LA.bwd(q, k, v, do, chunk=chunk),
             lambda i: LR.chunked_bwd_ref(q, k, v, do, chunk=chunk),
             LA.bwd_work(q, k, v, do))):
        out[name] = dict(ms=graph_ms(kern, 4, replays=5),
                         plain_ms=graph_ms(plain, 2, replays=3),
                         library_ms=None,
                         fp32_bound_ms=bound(n_bytes, ops)["bound_ms"],
                         **bound(n_bytes, ops, PEAK_BF16_TC_FLOPS))
    # two sweeps (a forward one for dq, a reverse one for dk and dv) each
    # read their inputs and write their outputs: 4 + 6 tensors
    two = LA.bwd_dq_work(k, v, do)[1] + LA.bwd_dkv_work(q, k, v, do)[1]
    out["bwd"]["two_sweep_bytes"] = two
    out["bwd"]["two_sweep_ms"] = bound(two, 0.0)["bound_ms"]
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


def check_gla_clamp(dtype, gen, dev, lo=-1.0, d=128) -> None:
    """g ≡ lo = min_log_decay (−1: the default clamp; or the route's
    ``DECAY_LIMIT``), T = 1,024, D = ``d``, chunk 128: B8 and B9 through
    the autograd function, all finite and within normwise 1e-5 (fp32) or
    8e-3 (bf16) of ``gla_scan`` and its autograd gradients, evaluated in
    fp32 on the same values (the chunk-128 plain version is NaN there,
    as JAX's is)."""
    import torch
    from repro_torch.core.gated import gla_scan
    from repro_torch.kernels.gated_linear_attention import ops as GL
    q, k, v, do, g = (x.reshape(1, 2, 1024, d) for x in gla_rows(
        2, 1024, d, dtype, "clamp", gen, dev))
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
          f"T=1024, D={d}, chunk 128, {name}): all finite; max|Δ| against "
          f"gla_scan and its autograd in fp32 "
          + ", ".join(f"{n} {e:.3e}" for n, e in zip(names, errs))
          + f" (normwise {LA_TOL[name]}); the chunk-128 plain version: "
          f"{100 * nan_share:.1f}% of o NaN")


def check_decay_limit(gen, dev, d=128) -> None:
    """Each route at its ``DECAY_LIMIT`` (bf16 −1.25, fp32 −1.5) with g
    held there (``check_gla_clamp``) at D = ``d``, and a CUDA call of
    ``fwd``, ``bwd_dq`` and ``bwd_dkv`` just past it refused with
    ValueError."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    for dtype in (torch.bfloat16, torch.float32):
        lo = GL.DECAY_LIMIT[dtype]
        check_gla_clamp(dtype, gen, dev, lo=lo, d=d)
        q, k, v, do, g = gla_rows(2, 64, d, dtype, "mild", gen, dev)
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
    out = {}
    for name, kern, plain, (ops, n_bytes) in (
            ("gated_linear_attention_fwd",
             lambda i: GL.fwd(q, k, v, g, chunk=chunk),
             lambda i: GR.chunked_fwd_ref(q, k, v, g, chunk=chunk),
             GL.fwd_work(q, k, v, g)),
            ("gated_linear_attention_bwd_dq",
             lambda i: GL.bwd_dq(q, k, v, g, do, chunk=chunk),
             lambda i: GR.bwd_dq_ref(q, k, v, g, do, chunk=chunk),
             GL.bwd_dq_work(q, k, v, g, do)),
            ("gated_linear_attention_bwd_dkv",
             lambda i: GL.bwd_dkv(q, k, v, g, do, qdq, chunk=chunk),
             lambda i: GR.bwd_dkv_dg_ref(q, k, v, g, do, qdq, chunk=chunk),
             GL.bwd_dkv_work(q, k, v, g, do)),
            ("bwd",
             lambda i: GL.bwd(q, k, v, g, do, chunk=chunk),
             lambda i: GR.chunked_bwd_ref(q, k, v, g, do, chunk=chunk),
             GL.bwd_work(q, k, v, g, do))):
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
    The lse route (``want_lse``, the softmax training forward): its o
    bit for bit the null-lse route's, its lse against the plain
    version's at LSE_TOL. Returns the largest |Δo| against the plain
    version."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.flash_attention import ref as FR
    kv_rows = bh if kv_heads is None else bh // heads * kv_heads
    q, k, v = (torch.randn((n_r, n, d), generator=gen, device=dev).to(dtype)
               for n_r, n in ((bh, t), (kv_rows, s), (kv_rows, s)))
    o = FA.fwd(q, k, v, t_off=t_off, s_real=s_real, kv_heads=kv_heads)
    o_l, lse = FA.fwd(q, k, v, t_off=t_off, s_real=s_real,
                      kv_heads=kv_heads, want_lse=True)
    torch.cuda.synchronize()
    o_r, lse_r = FA.fwd(q, k, v, t_off=t_off, s_real=s_real,
                        kv_heads=kv_heads, kernel=False, want_lse=True)
    if not torch.equal(o, o_l):
        raise AssertionError(f"flash_attention_fwd: the lse route's o "
                             f"differs from the null-lse route's")
    lse_tol = LSE_TOL[str(dtype).split(".")[-1]]
    lse_err = ((lse - lse_r).abs() / lse_r.abs().clamp(min=1.0)).max().item()
    if not lse_err <= lse_tol:
        raise AssertionError(f"flash_attention_fwd: lse {lse_err:.3e} from "
                             f"the plain version's, limit {lse_tol}")
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
          + tag_bf16 + f"; lse route: o bitwise, lse within {lse_err:.3e}"
          f" (relative, limit {lse_tol})")
    return (o.float() - o_r.float()).abs().max().item()


# B10's log-sum-exp against its plain version's, relative to max(1, |lse|):
# fp32, the same fp32 sums in another order; bf16, the same scores from
# bf16 inputs through ex2.approx
LSE_TOL = {"float32": 1e-5, "bfloat16": 1e-4}


def check_flash_wrapper(b, h, hkv, t, s, dtype, gen, dev, d=128) -> None:
    """(B, H, T, D) q and (B, Hkv, S, D) k, v through
    ``ops.flash_attention`` (padding T and S to the JAX wrapper's tiles),
    kernel route against ``kernel=False``."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    q, k, v = (torch.randn((b, n_h, n, d), generator=gen, device=dev).to(
        dtype) for n_h, n in ((h, t), (hkv, s), (hkv, s)))
    o = FA.flash_attention(q, k, v)
    o_l, lse = FA.flash_attention(q, k, v, want_lse=True)
    o_r, lse_r = FA.flash_attention(q, k, v, kernel=False, want_lse=True)
    torch.cuda.synchronize()
    name = str(dtype).split('.')[-1]
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    torch.testing.assert_close(o.float(), o_r.float(), rtol=tol, atol=tol)
    if not torch.equal(o, o_l) or lse.shape != (b, h, t):
        raise AssertionError(f"flash_attention wrapper: lse route o or lse "
                             f"{tuple(lse.shape)} wrong")
    torch.testing.assert_close(lse, lse_r, rtol=LSE_TOL[name],
                               atol=LSE_TOL[name])
    print(f"  flash_attention wrapper B={b} H={h} Hkv={hkv} T={t} S={s} "
          f"D={d} {name}: max|Δo|="
          f"{(o.float() - o_r.float()).abs().max().item():.3e} against "
          f"kernel=False; lse (sliced from the padded rows) max|Δ|="
          f"{(lse - lse_r).abs().max().item():.3e}")


def time_flash_attention(b, h, hkv, t, d, gen, dev, n_bufs=4) -> dict:
    """B10 at the prefill main path's shape (B·H q rows over B·Hkv kv
    rows, T = S, bf16, causal, t_off 0), with the lse (the training
    forward's route, ``lse_ms``, bound with the lse's bytes
    ``lse_bound_ms``), its plain version, and the library call
    ``scaled_dot_product_attention(is_causal=True, enable_gqa=True)`` on
    the same inputs, from CUDA-graph replays over ``n_bufs`` input sets
    (beyond the 50 MB L2). SDPA's grouped heads map
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
    flops, n_bytes = FA.fwd_work(*rows[0], t_off=0, s_real=t)
    lse_bytes = FA.fwd_work(*rows[0], t_off=0, s_real=t,
                            want_lse=True)[1] - n_bytes
    out = dict(
        ms=graph_ms(lambda i: FA.fwd(*rows[i % n_bufs], kv_heads=hkv),
                    2 * n_bufs, replays=5),
        lse_ms=graph_ms(lambda i: FA.fwd(*rows[i % n_bufs], kv_heads=hkv,
                                         want_lse=True),
                        2 * n_bufs, replays=5),
        lse_bound_ms=bound(n_bytes + lse_bytes, flops,
                           PEAK_BF16_TC_FLOPS)["bound_ms"],
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
            "gated_linear_attention_bwd_exclusive_dq": GL.bwd_exclusive_dq,
            "gated_linear_attention_bwd_exclusive_dkv": GL.bwd_exclusive_dkv,
            "flash_attention_fwd": FA.fwd}


def reset_launches() -> None:
    for fn in launch_counters().values():
        fn.launches = 0


def read_launches() -> dict:
    return {name: fn.launches for name, fn in launch_counters().items()}


DECODE_KERNEL = {"linear": "decode_linear", "gated_linear": "decode_gated"}


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
                      "decay_sweep_dkv_tc (bf16 tensor cores)")),
    # one kernel: B10's forward with the lse; the backward is plain
    "softmax": (("flash_attention_fwd",), ("B10",),
                "flash_attention/kernel.py", (61,), "flash_fwd",
                ("flash_fwd_tc (bf16 tensor cores)",))}


# RWKV-6's time-mix in training: B8's exclusive route forward, and the
# exclusive backward's two launches
EXCLUSIVE_KERNELS = ("gated_linear_attention_fwd",
                     "gated_linear_attention_bwd_exclusive_dq",
                     "gated_linear_attention_bwd_exclusive_dkv")


def train_launches(cfg) -> dict:
    """Kernel launches of one training step (the forward, its remat
    recompute and the backward) by kernel, from the config's layer kinds:
    an attention site runs its backend's kernels (``TRAIN_KERNELS``;
    softmax B10 alone, its backward plain), a Mamba-2 block B8/B9, an
    RWKV-6 block ``EXCLUSIVE_KERNELS``. Under remat per unit a repeat's
    forward kernel runs twice (forward, recompute); a tail's once."""
    pattern, reps, tail = cfg.pattern_and_repeats
    out = {}
    for kinds, times, remat in ((pattern, reps, cfg.remat == "unit"),
                                (tail, 1, False)):
        for kind in kinds:
            names = (TRAIN_KERNELS["gated_linear"][0] if kind == "mamba"
                     else EXCLUSIVE_KERNELS if kind == "rwkv"
                     else TRAIN_KERNELS[cfg.attention_backend][0])
            for i, name in enumerate(names):
                out[name] = out.get(name, 0) + times * (
                    2 if i == 0 and remat else 1)
    return out


def slice_model(backend, dtype, dev, arch="qwen3-0.6b", seq=256,
                n_layers=2):
    """The training slices' model and batch: ``arch`` at full width,
    ``n_layers`` layers (whole repeats of its pattern, no tail), compute
    in ``dtype``, fp32 weights from seed 0, batch 2 x ``seq`` tokens from
    seed 1; RWKV-6's bonus u drawn at random (its init is zero, where the
    bonus adds nothing)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import with_depth
    from repro_torch.models import lm
    cfg = dataclasses.replace(
        with_depth(get_config(arch), n_layers).with_backend(backend),
        dtype=dtype)
    params0 = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    for group in params0["stack"]:      # RWKV-6's bonus off its zero init
        if "u_bonus" in group:
            group["u_bonus"].normal_(0.0, 0.5, generator=torch.Generator(
                device=dev).manual_seed(3))
    toks = torch.randint(0, cfg.vocab_size, (2, seq + 1), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(1))
    return cfg, params0, {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def training_slice(backend, dev, phase, arch="qwen3-0.6b", seq=256) -> None:
    """Phases 9, 11, 17, 22 and 28: 2 layers at ``arch``'s full widths,
    fp32, batch 2 x ``seq`` tokens, weights from seed 0. Through the
    backend's attention kernels (B2/B3, B8/B9, B10) and through their plain
    versions: the loss and the MoE router's aux (rtol 1e-5), every
    gradient leaf (normwise 1e-4: fp32 sums in other orders through two
    layers and the head), and the parameters after one AdamW step
    (within 1e-6 wherever the plain gradient is above that tolerance;
    Adam's first step is ±lr by the gradient's sign, which rounding may
    flip where it is below)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import GradAccumulator, adamw, cosine_warmup
    from repro_torch.runtime import make_train_step
    from repro_torch.tree import leaves, tree_map
    cfg, params0, batch = slice_model(backend, "float32", dev, arch, seq)
    runs = {}
    for kernel in (True, False):
        reset_launches()
        loss, metrics, grads = GradAccumulator(1).run(
            lambda p, b: lm.lm_loss(p, b, cfg, attention_kernel=kernel),
            params0, batch)
        params = tree_map(lambda x: x.detach().clone(), params0)
        opt = adamw(cosine_warmup(3e-4, warmup=20, total=8), weight_decay=0.1)
        params, _, m = make_train_step(cfg, opt, attention_kernel=kernel)(
            params, opt.init(params), batch)
        torch.cuda.synchronize()
        runs[kernel] = (loss, leaves(grads), leaves(params), m,
                        read_launches(), metrics["aux"])
    (loss_k, g_k, p_k, m_k, n_k, aux_k), (loss_p, g_p, p_p, m_p, n_p,
                                          aux_p) = runs[True], runs[False]
    # two backward passes per route (the gradients, then the train
    # step); the forward kernel twice per layer and pass: forward and
    # remat recompute
    want = {k: 2 * n for k, n in train_launches(cfg).items()}
    got = {k: n for k, n in n_k.items() if n}
    if got != want or any(n_p.values()):
        raise AssertionError(f"phase {phase}: launches {got} on the kernel "
                             f"route (want {want}), {n_p} on the plain "
                             f"route")
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0.0)
    torch.testing.assert_close(aux_k, aux_p, rtol=1e-5, atol=0.0)
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
    print(f"phase {phase}: {arch} {backend} training slice, {cfg.n_layers} "
          f"layers full width fp32, batch 2 x {seq}: loss "
          f"{loss_k.item():.6f} vs plain "
          f"{loss_p.item():.6f}, aux {aux_k.item():.6f} vs "
          f"{aux_p.item():.6f}; {len(g_k)} gradient leaves max normwise "
          f"|Δg|={g_err:.3e}; params after one AdamW step max|Δ|="
          f"{p_err:.3e} where |g| > 1e-4 max|g| ({n_flip} of {n_small} "
          f"elements below it moved apart); launches {got} over two passes "
          f"(each forward kernel twice a layer and pass: forward and remat "
          f"recompute)")


# The bf16 slices (phases 9 and 11): the kernel route against the plain
# route, both in bf16 compute, which round the attention core's operands in
# other places (the tensor-core routes feed bf16 score tiles, state copies
# and scaled operands to their products; the plain versions compute in
# fp32 from the bf16 inputs); the difference then passes through two bf16
# layers, the head and the backward. The loss relative, every gradient
# leaf normwise (max|Δ| over max|plain|); PERF.md §6 gives the measured
# errors beside these limits (loss 1.2e-5 and leaves 1.5e-2 at most).
BF16_SLICE_TOL = {"loss": 1e-4, "leaf": 5e-2}


@contextlib.contextmanager
def moe_routing(calls, replay=None):
    """``models.moe.route`` under a harness: each call's expert ids are
    appended to ``calls``; with ``replay`` (the ``calls`` of an earlier
    run through the same model) call i takes replay[i]'s ids instead of
    its own top-k, its weights and aux computed from its own
    probabilities at those ids as ``route`` does, and ``calls`` gets how
    many of its tokens chose another set of experts."""
    import torch
    from repro_torch.models import moe as MOE
    route = MOE.route

    def pinned(router_w, x_flat, top_k):
        weights, experts, aux = route(router_w, x_flat, top_k)
        if replay is None:
            calls.append(experts)
            return weights, experts, aux
        experts_r = replay[len(calls)]
        calls.append(int((experts.sort(-1).values
                          != experts_r.sort(-1).values).any(-1).sum()))
        probs = torch.softmax(x_flat.float() @ router_w.float(), dim=-1)
        w = probs.gather(-1, experts_r)
        n, e = probs.shape
        counts = torch.zeros(e, dtype=torch.float32, device=probs.device)
        counts.scatter_add_(0, experts_r.reshape(-1),
                            torch.ones(experts_r.numel(),
                                       device=probs.device))
        return (w / (w.sum(dim=-1, keepdim=True) + 1e-9), experts_r,
                e * torch.sum(counts / n * probs.mean(dim=0)) / top_k)

    MOE.route = pinned
    try:
        yield calls
    finally:
        MOE.route = route


def training_slice_bf16(backend, dev, phase, arch="qwen3-0.6b",
                        seq=256) -> None:
    """Phases 9, 11, 17, 22 and 28, second part: ``training_slice``'s
    2-layer model in bf16 compute (fp32 master weights, as the main path
    trains), so that the attention kernels take their bf16 (tensor-core) routes
    inside the model: the loss and every gradient leaf through the
    kernels against the same through ``attention_kernel=False``, at
    BF16_SLICE_TOL; the MoE router's aux beside the loss.

    With MoE the plain route takes the kernel route's expert ids
    (``moe_routing``): the two routes' bf16 attention outputs differ by
    an ulp here and there, and where a token's 6th and 7th router
    probabilities lie that close, its top-k set flips, which moves its
    hidden state by a whole expert's share: unpinned, the head's
    gradient column of such a token's label moves past the 5e-2 limit
    (PERF.md §6 gives the reading). Pinned, the routes
    differ by the kernels' rounding alone, as in the dense slices; the
    flips the plain route would have made are printed."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import GradAccumulator
    from repro_torch.tree import leaves
    cfg, params0, batch = slice_model(backend, "bfloat16", dev, arch, seq)
    runs, routing = {}, {True: [], False: []}
    for kernel in (True, False):
        reset_launches()
        pin = (moe_routing(routing[kernel], None if kernel else routing[True])
               if cfg.moe is not None else contextlib.nullcontext())
        with pin:
            loss, metrics, grads = GradAccumulator(1).run(
                lambda p, b: lm.lm_loss(p, b, cfg, attention_kernel=kernel),
                params0, batch)
        torch.cuda.synchronize()
        runs[kernel] = (loss, leaves(grads), read_launches(),
                        metrics["aux"].item())
    (loss_k, g_k, n_k, aux_k), (loss_p, g_p, n_p, aux_p) = (runs[True],
                                                          runs[False])
    # one backward pass; the forward kernel twice per layer (forward and
    # remat recompute)
    want = train_launches(cfg)
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
    print(f"phase {phase}: {arch} {backend} training slice in bf16 compute, "
          f"{cfg.n_layers} layers full width, batch 2 x {seq}: loss "
          f"{loss_k.item():.6f} "
          f"vs plain {loss_p.item():.6f} (relative {loss_err:.3e}, limit "
          f"{BF16_SLICE_TOL['loss']}); aux {aux_k:.6f} vs {aux_p:.6f}; "
          f"{len(g_k)} gradient leaves, max|Δg| over max|g|: largest "
          f"{max(g_err):.3e}, median {sorted(g_err)[len(g_err) // 2]:.3e} "
          f"(limit {BF16_SLICE_TOL['leaf']}); launches {got}"
          + (f"; routing pinned to the kernel route's, where the plain "
             f"route's own top-k sets differ for {routing[False]} tokens "
             f"of {batch['tokens'].numel()} per router call (forward, "
             f"remat recompute)" if cfg.moe is not None else ""))


@contextlib.contextmanager
def attention_forward_pinned(outputs, replay=None):
    """The training kernels' forwards (``fwd`` of B2's, B8's and B10's ops
    modules, kernel or plain route) under a harness: each call's output is
    appended to ``outputs``; with ``replay`` (the ``outputs`` of an earlier
    run through the same model) call i returns replay[i] instead of its
    own, which must have the same shapes and types. The wrappers keep the
    modules' launch counts."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.linear_attention import ops as LA
    saved = []
    for mod in (LA, GL, FA):
        def pinned(*args, _orig=mod.fwd, **kwargs):
            out = _orig(*args, **kwargs)
            parts = out if isinstance(out, tuple) else (out,)
            if replay is None:
                outputs.append(tuple(None if x is None else x.detach().clone()
                                     for x in parts))
                return out
            want = replay[len(outputs)]
            outputs.append(None)
            if [None if x is None else (x.shape, x.dtype) for x in parts] != \
                    [None if x is None else (x.shape, x.dtype) for x in want]:
                raise AssertionError("pinned attention forward: call "
                                     f"{len(outputs) - 1} differs in shape")
            return want if isinstance(out, tuple) else want[0]
        pinned.launches = mod.fwd.launches
        saved.append((mod, mod.fwd))
        mod.fwd = pinned
    try:
        yield outputs
    finally:
        for mod, orig in saved:
            orig.launches = mod.fwd.launches
            mod.fwd = orig
        torch.cuda.synchronize()


def pinned_training_slice(backend, dev, phase, arch, n_layers, dtype) -> dict:
    """Phase 36: ``arch`` at full width, ``n_layers`` layers, compute in
    ``dtype``, batch 2 x 256, weights from seed 0 (RWKV-6's u drawn). The
    loss through the kernels (their forwards) against the loss through
    the plain versions (fp32 rtol 1e-5, bf16 1e-4); then one step's every
    gradient leaf through the kernels (launched exactly
    ``train_launches`` times) against the plain versions' with the plain
    route taking the kernel route's attention outputs
    (``attention_forward_pinned``), as phase 22 pins the MoE routing: the
    leaves hold the backward kernels inside the model (fp32 normwise
    1e-4, bf16 ``BF16_SLICE_TOL``). These models' gradients amplify a
    last-bit difference of the forward past those limits: on the plain
    route itself RWKV-6's bf16 gradient leaves lie up to 58% from an fp64
    step's and Mamba-2's decay leaves (a_log) up to 27%, and in fp32 the
    a_log leaves lie 5e-5 (plain) and 7e-5 (kernels) from fp64, so two
    correct routes differ past the pairwise limits (PERF.md §6)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.optim import GradAccumulator
    from repro_torch.tree import leaves
    cfg, params0, batch = slice_model(backend, dtype, dev, arch, 256,
                                      n_layers)
    loss_tol, leaf_tol = ((1e-5, 1e-4) if dtype == "float32" else
                          (BF16_SLICE_TOL["loss"], BF16_SLICE_TOL["leaf"]))
    runs, outputs = {}, {True: [], False: []}
    for kernel in (True, False):
        reset_launches()
        with attention_forward_pinned(
                outputs[kernel], None if kernel else outputs[True]):
            loss, _, grads = GradAccumulator(1).run(
                lambda p, b: lm.lm_loss(p, b, cfg, attention_kernel=kernel),
                params0, batch)
        runs[kernel] = (loss, leaves(grads),
                        {k: n for k, n in read_launches().items() if n})
    with torch.no_grad():
        loss_p, _ = lm.lm_loss(params0, batch, cfg, attention_kernel=False)
    (loss_k, g_k, n_k), (_, g_p, n_p) = runs[True], runs[False]
    want = train_launches(cfg)
    if n_k != want or n_p:
        raise AssertionError(f"phase {phase}: launches {n_k} on the kernel "
                             f"route (want {want}), {n_p} on the plain route")
    if not all(torch.isfinite(x).all() for x in g_k + [loss_k]):
        raise AssertionError(f"phase {phase}: non-finite loss or gradients")
    loss_err = abs(loss_k.item() - loss_p.item()) / abs(loss_p.item())
    if not loss_err <= loss_tol:
        raise AssertionError(f"phase {phase}: {arch} {backend} {dtype} loss "
                             f"{loss_k.item()} against plain "
                             f"{loss_p.item()}: {loss_err:.3e} > {loss_tol}")
    g_err = [normwise(a, b, leaf_tol, f"phase {phase} {arch} {backend} "
                      f"{dtype} gradient leaf {i}")
             / b.float().abs().max().item()
             for i, (a, b) in enumerate(zip(g_k, g_p))]
    print(f"phase {phase}: {arch} {backend} training slice, {cfg.n_layers} "
          f"layers full width, {dtype}, batch 2 x 256: loss "
          f"{loss_k.item():.6f} against plain {loss_p.item():.6f} "
          f"(relative {loss_err:.3e}, limit {loss_tol}); {len(g_k)} "
          f"gradient leaves, the plain route on the kernel route's "
          f"{len(outputs[True])} attention outputs: max|Δg| over max|g| "
          f"largest {max(g_err):.3e}, median "
          f"{sorted(g_err)[len(g_err) // 2]:.3e} (limit {leaf_tol}); "
          f"launches {n_k}")
    del runs, outputs, params0
    torch.cuda.empty_cache()
    return {"loss": loss_err, "leaf": max(g_err)}


def profile_train_step(loop, batch, kernel) -> dict:
    """Device time by kernel over one training step (torch.profiler) and
    the device busy share: device time over the step's wall time; the
    rows of the attention kernels (whose names hold ``kernel``, or one of
    a tuple of names) all printed. Returns the busy share, the device
    time, the rows and the device ms and launches by kind."""
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
        return {"busy": None, "sweep_ms": None, "rows": [], "kinds": {}}
    print(f"  profile: {total / 1e3:.3f} ms device time per step; device "
          f"busy {100 * total / 1e3 / wall_ms:.1f}% of the step")
    names = (kernel,) if isinstance(kernel, str) else kernel
    for i, (t, key, count) in enumerate(rows):
        if i < 16 or any(name in key for name in names):
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
            "rows": rows, "kinds": kinds}


# kernel names by kind, first match wins
TRAIN_KINDS = (("B2/B3", ("sweep_kernel", "linear_sweep")),
               ("B8/B9", ("decay_sweep", "exclusive_dq_tc",
                          "exclusive_dkv_tc")),
               ("B10", ("flash_fwd",)),
               ("matmul", ("gemm", "nvjet", "cutlass", "xmma", "cublas")),
               ("cumsum", ("scan",)),
               ("reduction", ("reduce_kernel",)),
               ("copy or cast", ("copy", "Memcpy", "Memset")),
               ("elementwise", ("elementwise",)))


def time_flash_backward(b, cfg, t, gen, dev, calls=5) -> float:
    """Device ms of one call of the softmax training's plain backward
    (``xla_attention._flash_bwd``) at (B, H, T, D) q over Hkv kv heads,
    bf16, the model's block: CUDA events around ``calls`` calls after a
    warm-up (the calls are large enough that the host keeps ahead)."""
    import torch
    from repro_torch.kernels.flash_attention import ops as FA
    from repro_torch.models import xla_attention as XA
    h, hkv, d = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, do = (torch.randn((b, h, t, d), generator=gen, device=dev).bfloat16()
             for _ in range(2))
    k, v = (torch.randn((b, hkv, t, d), generator=gen, device=dev)
            .bfloat16() for _ in range(2))
    o, lse = FA.flash_attention(q, k, v, t_off=0, want_lse=True)

    def call():
        return XA._flash_bwd(q, k, v, o, lse, do, scale=d ** -0.5,
                             block=cfg.attn_block_q, off=0)
    call()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(calls):
        call()
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / calls
    del q, do, k, v, o, lse
    torch.cuda.empty_cache()
    return ms


def release_train_loop() -> None:
    """``launch/train.py``'s ``build`` points SIGTERM at its loop (a
    preemption request), and the handler keeps the loop, its parameters
    and its optimizer state alive after the phase that built it: the
    default handler again, so that the later phases find the card free
    (phase 22's loop held 20 GB through phase 26)."""
    import signal
    signal.signal(signal.SIGTERM, signal.SIG_DFL)


def training_main_path(backend, dev, gen, phase) -> list:
    """Phases 10, 12 and 18: ``launch/train.py``'s ``build`` and
    ``TrainLoop`` on the full qwen3-0.6b under ``backend``, batch 8 x seq
    1,024, 8 steps (2 warm-up, 6 timed), lr 3e-4 with warmup 20; every
    kernel's launch count set to 0 just before and read just after.
    Returns the backend's attention kernels' records for the kernels
    line (without ``max_abs_err``). Softmax (phase 18) returns B10's
    launches instead (its record is phase 14's) and times the plain
    flash backward alone at the step's shape."""
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
    want_params = {"linear": 596_049_920, "gated_linear": 654_942_208,
                   "softmax": 596_049_920}[backend]
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
          f"(forward + remat recompute)" + "".join(
              f", {i} {got[n] // steps}" for i, n in zip(ids[1:], names[1:])))
    batch = loop.put_batch(loop.dataset.batch_at(steps))
    prof = profile_train_step(loop, batch, kernel)
    if prof["busy"] is not None:
        print(f"  device busy {100 * prof['busy']:.1f}% of a profiled step; "
              f"{prof['device_ms']:.3f} ms device time against "
              f"{ms:.3f} ms per step unprofiled")
    if backend == "softmax":
        release_train_loop()
        del loop, out, batch
        torch.cuda.empty_cache()
        bwd_ms = time_flash_backward(args.batch, cfg, args.seq_len, gen, dev)
        per_step = cfg.n_layers * bwd_ms
        share = (f"{100 * per_step / prof['device_ms']:.1f}% of the "
                 f"profiled step's {prof['device_ms']:.3f} ms device time"
                 if prof["busy"] is not None else "not measured")
        print(f"  the plain flash backward (JAX's _flash_bwd in PyTorch: "
              f"blocks of {cfg.attn_block_q}, 3 causal pairs) alone at "
              f"B={args.batch} H={cfg.n_heads} Hkv={cfg.n_kv_heads} "
              f"T={args.seq_len} D={cfg.head_dim} bf16: {bwd_ms:.3f} ms a "
              f"layer (CUDA events, 5 calls), {per_step:.3f} ms a step for "
              f"{cfg.n_layers} layers: {share}")
        return launches[names[0]]
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
    release_train_loop()
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
              f"bf16 causal: {r['ms'] * 1e3:.2f} us/launch, with the lse "
              f"{r['lse_ms'] * 1e3:.2f} us (bound {r['lse_bound_ms'] * 1e3:.2f}"
              f" us with its bytes) (plain version "
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
            "bound_by": t["bound_by"], "library_ms": t["library_ms"],
            "lse_ms": t["lse_ms"], "lse_bound_ms": t["lse_bound_ms"]}


# phase 15's workloads: (ingest chunk, max_len, prompt lengths, generation
# budgets). Chunks of 8: one prompt of a single token, two beyond the
# chunk, one budget of a single token. Chunks of 64, the stream path's:
# prompts beyond it, so that continuation chunks run B1/B7 64 tokens wide
# with rows of 64, of fewer (the prompts' tails) and of 0.
ENGINE_SLICE_WORKLOADS = (
    (8, 64, (6, 8, 21, 1, 40, 8, 5), (5, 12, 1, 9, 7, 6, 8)),
    (64, 256, (130, 200, 1, 64, 192, 70, 9), (5, 4, 6, 1, 7, 3, 8)),
)


def engine_slice(backend, dev, phase, chunk, max_len, prompt_lens, gens
                 ) -> None:
    """Phase 15: ``DecodeEngine`` on 2 layers at qwen3-0.6b's full widths
    in fp32, 4 slots, segments of 4, ingest chunks of ``chunk`` (batched
    admission, recurrent ingest). Linear family: through B1/B7 against
    the same engine under ``decode_kernel="reference"``, B1/B7 launched
    layers x (segment_len x segments + ingest chunks) times. Softmax:
    admission waves through B10 against the same engine under
    ``decode_kernel="reference"``, B10's plain version in every prefill,
    B10 launched layers x (waves + 1-token prefills) times. Both: completions and
    stats identical, each request run alone gives the same tokens, and
    no other kernel launched."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine
    name = serve.STREAM_KERNELS[backend][0]
    softmax = backend == "softmax"
    cfg = dataclasses.replace(
        get_config("qwen3-0.6b").with_backend(backend), n_layers=2,
        dtype="float32")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in prompt_lens]
    ones = sum(n == 1 for n in prompt_lens)
    runs = {}
    for kernel in ("auto", "reference"):
        c = dataclasses.replace(cfg, decode_kernel=kernel)
        eng = DecodeEngine(params, c, n_slots=4, segment_len=4,
                           max_len=max_len, prefill_chunk=chunk)
        for prompt, g in zip(prompts, gens):
            eng.submit(prompt, g)
        reset_launches()
        comps = eng.run()
        torch.cuda.synchronize()
        launches = read_launches()
        st = eng.stats.to_dict()
        want = (serve.stream_launches(c, st, eng.ingest, eng.admission, ones)
                if kernel == "auto" else 0)
        if launches[name] != want:
            raise AssertionError(f"phase {phase}: {name} launched "
                                 f"{launches[name]} times on the {kernel} "
                                 f"route, want {want}")
        others = {k: n for k, n in launches.items() if k != name and n}
        if others:
            raise AssertionError(f"phase {phase}: other kernels launched: "
                                 f"{others}")
        runs[kernel] = (comps, st, launches[name])
        runs["widths"] = eng._seen_shapes        # admission program shapes
    (comps, st, n_launch), (ref_comps, ref_st, _) = (runs["auto"],
                                                     runs["reference"])
    if st != ref_st:
        raise AssertionError(f"phase {phase}: stats differ: {st} vs "
                             f"{ref_st}")
    for a, b in zip(comps, ref_comps):
        if (a.uid, a.tokens.tolist(), a.finish_reason, a.admitted_step,
                a.finished_step) != (b.uid, b.tokens.tolist(),
                                     b.finish_reason, b.admitted_step,
                                     b.finished_step):
            raise AssertionError(f"phase {phase}: completion {a.uid} "
                                 f"differs: {a} vs {b}")
    if st["ingest_chunks"] < 2 or not st["segments"]:
        raise AssertionError(f"phase {phase}: the workload ran no chunked "
                             f"ingest or no segment: {st}")
    widths = sorted(w for kind, w in runs["widths"] if kind == "window_varlen")
    if max(widths) != chunk:
        raise AssertionError(f"phase {phase}: no continuation chunk "
                             f"{chunk} tokens wide (widths {widths})")
    for c, prompt, g in zip(comps, prompts, gens):
        logits, state = lm.prefill(
            params, torch.from_numpy(prompt).long()[None].to(dev), cfg)
        state = lm.pad_decode_state(state, cfg, len(prompt) + g)
        tok0 = lm.sample_token(logits, 0.0)
        more, _ = lm.generate(params, state, tok0, len(prompt), g - 1, cfg)
        alone = [int(tok0[0])] + more[0].tolist()
        if c.tokens.tolist() != alone:
            raise AssertionError(f"phase {phase}: request {c.uid} "
                                 f"({len(prompt)} prompt tokens) gives "
                                 f"{c.tokens.tolist()} in the engine, "
                                 f"{alone} alone")
    formula = (f"{cfg.n_layers} x ({st['prefill_dispatches']} waves + "
               f"{ones} 1-token prefills)" if softmax else
               f"{cfg.n_layers} x ({st['segment_len']} x {st['segments']} + "
               f"{st['ingest_chunks']})")
    ref = ("B10 engine = reference (plain-prefill) engine" if softmax
           else "B1/B7 engine = reference engine")
    print(f"phase {phase}: {backend} engine slice, 2 layers full width fp32,"
          f" 4 slots, ingest chunks of {chunk}, {len(prompts)} requests "
          f"(prompts {list(prompt_lens)}): {ref} (completions and stats) = "
          f"each request alone; {name} launched {n_launch} = {formula}, "
          f"continuation chunks {widths} wide; stats {json.dumps(st)}")


def profile_segments(engine, n=2, steps=2) -> dict:
    """Wall time of ``n`` segments of the engine's model with every slot
    active, then device time by kernel over ``steps`` decode steps of
    such a segment (torch.profiler, device activity only; stopping it
    over a whole segment's ~20,000 kernels took 12-16 s): device ms and
    wall ms per segment, the device time as ``segment_len`` steps."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    dev, s = engine.device, engine.n_slots
    tok = torch.zeros((s,), dtype=torch.long, device=dev)
    pos = torch.full((s,), engine.max_len, dtype=torch.int32, device=dev)
    active = torch.ones((s,), dtype=torch.bool, device=dev)
    remaining = torch.full((s,), 1 << 20, dtype=torch.int32, device=dev)

    def segments(n, n_steps=engine.segment_len):
        t, p = tok, pos
        for _ in range(n):
            toks, carry = engine.backend.generate_segment(
                engine.params, engine.state, t, p, active, remaining,
                n_steps)
            toks.cpu()                        # the engine's one host sync
            t, p = carry["tok"], carry["pos"]

    segments(1)                               # warm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    segments(n)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / n * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        segments(1, steps)
        torch.cuda.synchronize()
    rows, _ = profile_rows(prof)
    print(f"  profiled {steps} steps of a segment; the profiler took "
          f"{time.perf_counter() - t0:.1f} s with its sort")
    total = sum(t for t, _, _ in rows)
    print(f"  segments alone: {wall_ms:.3f} ms wall per segment of "
          f"{engine.segment_len} steps x {s} slots")
    if not total:
        print("  profile: the profiler reported no device time "
              "(not measured)")
        return {"wall_ms": wall_ms, "device_ms": None, "busy": None}
    step_ms = total / steps / 1e3
    device_ms = step_ms * engine.segment_len
    print(f"  profile: {step_ms:.3f} ms device time per step, "
          f"{device_ms:.3f} ms per segment of {engine.segment_len}; device "
          f"busy {100 * device_ms / wall_ms:.1f}% of a segment")
    for i, (t, key, count) in enumerate(rows):
        if i < 8 or "decode_" in key:
            print(f"    {100 * t / total:5.1f}%  {t / steps / 1e3:8.4f} "
                  f"ms/step  x{count // steps:<5d} {key[:90]}")
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy": device_ms / wall_ms}


def stream_main_path(backend, dev, phase, arch="qwen3-0.6b",
                     n_layers=None) -> int:
    """Phases 16, 27 and 32: ``serve --mode stream --backend <backend>``
    on ``arch`` (qwen3-0.6b, cut to ``SERVE_TIME_LAYERS`` of its 28
    layers in phase 16; phase 27 musicgen-large; phase 32 rwkv6-1.6b,
    ``backend`` None: no attention
    layer) in bf16, 8 slots, segments of 8, 32 requests of 512 prompt
    tokens and 8 or 64 generated tokens at 0.25 arrivals per decode
    step, with every kernel's launch count set to 0 just before and read
    just after; then a profile of two steps of a segment. Softmax admits
    each prompt whole (``--prefill-chunk 512``: B10 in every wave; its
    per-step ingest, 64 eager decode steps a chunk, is held on the card
    by phase 15) and prints its KV cache's MiB beside the linear
    state's. RWKV-6 admits each request alone (per-request admission:
    B8's exclusive route once per layer and prefill, no ingest chunk)
    and decodes in plain PyTorch. Returns the backend kernel's launches
    in the run."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    rwkv = backend is None
    name = serve.STREAM_KERNELS["rwkv6" if rwkv else backend][0]
    softmax = backend == "softmax"
    args = serve.parse_args([
        "--mode", "stream", "--arch", arch,
        "--slots", "8", "--segment-len", "8", "--n-requests", "32",
        "--prompt-len", "512", "--gen-len", "64", "--arrival-rate", "0.25",
        "--seed", "0"] + (["--prefill-chunk", "512"] if softmax else [])
        + ([] if rwkv else ["--backend", backend])
        + (["--n-layers", str(n_layers)] if n_layers else []))
    full = get_config(args.arch)
    full = full if rwkv else full.with_backend(backend)
    if n_layers:
        from repro_torch.configs.base import with_depth
        full = with_depth(full, n_layers)
    t0 = time.perf_counter()
    reset_launches()
    result = serve.stream(args)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  serve --mode stream returned in {time.perf_counter() - t0:.1f}"
          f" s (weights, warm-up and the timed run)")
    st = result["stats"]
    want, want_warm = result["want_launches"], result["warmup_launches"]
    if result["decode_launches"] != want:
        raise AssertionError(f"phase {phase}: {name} launched "
                             f"{result['decode_launches']} times in the "
                             f"timed run, want {want}")
    if launches[name] != want + want_warm:
        raise AssertionError(f"phase {phase}: {name} launched "
                             f"{launches[name]} times in the run, want "
                             f"{want + want_warm}")
    others = {k: n for k, n in launches.items() if k != name and n}
    if others:
        raise AssertionError(f"phase {phase}: other kernels launched: "
                             f"{others}")
    mix = serve.make_request_mix(np.random.default_rng(args.seed),
                                 args.n_requests, args.prompt_len,
                                 args.gen_len, full.vocab_size,
                                 args.arrival_rate)
    comps = result["completions"]
    if [len(c.tokens) for c in comps] != [g for _, g, _ in mix] or not all(
            ((c.tokens >= 0) & (c.tokens < full.vocab_size)).all()
            for c in comps):
        raise AssertionError(f"phase {phase}: incomplete or bad "
                             f"completions")
    chunks_per_request = -(-args.prompt_len // args.prefill_chunk) - 1
    if rwkv:
        if result["engine"].admission != "per_request" or \
                st["ingest_chunks"] or st["prefills"] != args.n_requests \
                or not st["segments"]:
            raise AssertionError(f"phase {phase}: per-request admission of "
                                 f"every prompt whole, no ingest: {st}")
    elif st["ingest_chunks"] < chunks_per_request or not st["segments"]:
        raise AssertionError(f"phase {phase}: no chunked ingest: {st}")
    if softmax:
        cache_mib = (full.n_layers * 2 * args.slots * result["engine"].max_len
                     * full.n_kv_heads * full.head_dim * 2) / 2**20
        if result["state_mib"] != cache_mib or st["ingest_chunks"]:
            raise AssertionError(f"phase {phase}: KV cache "
                                 f"{result['state_mib']} MiB (want "
                                 f"{cache_mib}), {st['ingest_chunks']} "
                                 f"ingest chunks (want 0)")
    formula = (f"{full.n_layers} x {st['prefill_dispatches']} waves"
               if softmax else
               f"{full.n_layers} x {st['prefills']} prefills" if rwkv else
               f"{full.n_layers} x ({st['segment_len']} x {st['segments']} "
               f"+ {st['ingest_chunks']})")
    print(f"phase {phase}: {arch} {backend or 'rwkv6'} stream main path "
          f"tok_s={result['tokens_per_s']:.1f} "
          f"ms_per_segment={result['ms_per_segment']:.3f} "
          f"slot_utilization={result['slot_utilization']:.4f} "
          f"mean_latency_steps={result['mean_latency_steps']:.2f} "
          f"seconds={result['seconds']:.3f} tokens={result['tokens']} "
          f"{name}.launches={launches[name]} (timed run {want} = "
          f"{formula}, warm-up {want_warm}); decode state "
          f"{result['state_mib']:.1f} MiB"
          + ("" if rwkv else f" against {result['linear_state_mib']:.1f} "
                             f"MiB of linear state")
          + "; all "
          f"{len(comps)} requests complete")
    print(f"  stats {json.dumps(st)}")
    prof = profile_segments(result["engine"])
    engine = result.pop("engine")
    state_ok = all(bool(torch.isfinite(t).all())
                   for group in engine.state.values() for layer in group
                   for t in layer if t is not None)
    if not state_ok:
        raise AssertionError(f"phase {phase}: non-finite engine state")
    if prof["busy"] is not None:
        print(f"  device busy {100 * prof['busy']:.1f}% of a segment "
              f"({prof['device_ms']:.3f} ms device time over "
              f"{prof['wall_ms']:.3f} ms wall per segment)")
    del engine, result
    torch.cuda.empty_cache()
    return launches[name]


def retrieve_main_path(dev, phase) -> None:
    """Phase 19: ``serve --mode retrieve --batch 4096`` at the paper's
    width (k = 100, n = 750), every kernel's launch count set to 0 just
    before and read just after (the path is gather + ``einsum``, as
    JAX's is jnp: none may launch); 256 sampled answers of the last wave
    against Hᵀ(Hq) computed in fp64 from the hidden states, within 1e-4
    of each answer's largest magnitude; the store's and the raw hidden
    states' MiB."""
    import torch
    from repro_torch.launch import serve
    args = serve.parse_args(["--mode", "retrieve", "--batch", "4096",
                             "--seed", "0"])
    reset_launches()
    r = serve.retrieve(args)
    torch.cuda.synchronize()
    launched = {k: n for k, n in read_launches().items() if n}
    if launched:
        raise AssertionError(f"phase {phase}: kernels launched {launched}")
    docs, k_dim, n = args.batch, 100, 750
    if r["store_mib"] != docs * k_dim * k_dim * 4 / 2**20 or \
            r["raw_mib"] != docs * n * k_dim * 4 / 2**20:
        raise AssertionError(f"phase {phase}: store {r['store_mib']} MiB, "
                             f"raw {r['raw_mib']} MiB")
    idx = torch.randperm(docs, generator=torch.Generator().manual_seed(7)
                         )[:256].to(dev)
    h, q = r["h"][idx].double(), r["queries"][idx].double()
    want = torch.einsum("bnk,bn->bk", h, torch.einsum("bnk,bk->bn", h, q))
    got = r["answers"][idx].double()
    err = ((got - want).abs().amax(-1) / want.abs().amax(-1)).max().item()
    if not err <= 1e-4 or not torch.isfinite(r["answers"]).all():
        raise AssertionError(f"phase {phase}: answers {err:.3e} from "
                             f"Hᵀ(Hq), limit 1e-4")
    print(f"phase {phase}: retrieve main path queries_per_s="
          f"{r['queries_per_s']:.1f} ({docs} documents, one query each, "
          f"mean of {r['iters']} batched_lookup waves) store_mib="
          f"{r['store_mib']:.2f} raw_mib={r['raw_mib']:.2f} "
          f"({r['raw_mib'] / r['store_mib']:.1f}x); 256 sampled answers "
          f"within {err:.3e} of Hᵀ(Hq) in fp64 (relative to each answer's "
          f"largest, limit 1e-4); no kernel launched (gather + einsum)")
    del r
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# phases 20-24: the MoE configs and the vision config's cross blocks
# ---------------------------------------------------------------------------

def full_width(arch, backend, n_layers, dtype="float32"):
    """``arch`` at its full widths, cut to ``n_layers`` layers, under
    ``backend``, computing in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import with_depth
    return dataclasses.replace(
        with_depth(get_config(arch), n_layers).with_backend(backend),
        dtype=dtype)


def attn_layers(cfg) -> int:
    """Self-attention layers: attn and shared_attn sites."""
    from repro_torch.launch import serve
    return serve.layer_counts(cfg)["attn"]


def set_xgate(params, cfg, value) -> None:
    """Every cross block's tanh gate to ``value``, in place (0 at init,
    where a cross block adds nothing and a comparison proves nothing)."""
    pattern, _, _ = cfg.pattern_and_repeats
    for kind, group in zip(pattern, params["stack"]):
        if kind == "cross":
            group["xgate"].fill_(value)


def generate_kernel_vs_reference(cfg, dev, phase, batch=4, prompt_len=64,
                                 steps=16, memory=None, xgate=None) -> None:
    """Phases 3, 7, 20, 23, 25 and 33: prefill + ``steps`` greedy steps
    through the kernels (B1 or B7 in every decode step of each attention
    layer, B10 in the softmax prefill, B8 in each Mamba-2 layer's
    prefill) against the reference route (``decode_kernel="reference"``,
    and the prefills through B10's and B8's plain versions): greedy
    tokens identical, logits within 1e-4, each
    kernel launched exactly as many times as the path has layers and
    steps, none on the reference route. The MoE runs the same
    deterministic ops on both routes (its scatter writes each kept slot
    once and its k-sum is a reduction, no ``index_add_``), so the routes
    differ only by the kernels' fp32 sums, far inside 1e-4; a top-k
    flip in the router would show as a token or logit beyond it."""
    import torch
    from repro_torch.models import lm
    backend = cfg.attention_backend
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    if xgate is not None:
        set_xgate(params, cfg, xgate)
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    from repro_torch.launch import serve
    n_attn = attn_layers(cfg)
    n_ssd = serve.layer_counts(cfg)["mamba"]
    runs = {}
    for kernel in (True, False):
        c = cfg if kernel else dataclasses.replace(cfg,
                                                   decode_kernel="reference")
        reset_launches()
        logits, st = lm.prefill(params, prompt, c, memory=memory,
                                attention_kernel=kernel)
        st = lm.pad_decode_state(st, c, prompt_len + steps)
        tok = lm.sample_token(logits, 0.0)
        all_logits, toks = [logits], [tok]
        for i in range(steps):
            logits, st = lm.decode_step(params, st, tok, prompt_len + i, c)
            tok = lm.sample_token(logits, 0.0)
            all_logits.append(logits)
            toks.append(tok)
        torch.cuda.synchronize()
        got = {k: n for k, n in read_launches().items() if n}
        want = ({} if not kernel else
                {"flash_attention_fwd": n_attn} if backend == "softmax" else
                {DECODE_KERNEL[backend]: n_attn * steps})
        if kernel and n_ssd:
            want["gated_linear_attention_fwd"] = n_ssd
        if got != want:
            raise AssertionError(f"phase {phase}: {cfg.name} {backend} "
                                 f"launched {got} (kernels={kernel}), want "
                                 f"{want}")
        runs[kernel] = (torch.stack(all_logits), torch.stack(toks), got)
    (lg_k, tok_k, n_k), (lg_p, tok_p, _) = runs[True], runs[False]
    if not torch.isfinite(lg_k).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    if not torch.equal(tok_k, tok_p):
        raise AssertionError(f"phase {phase}: {cfg.name} {backend}: greedy "
                             f"tokens differ")
    torch.testing.assert_close(lg_k, lg_p, rtol=1e-4, atol=1e-4)
    print(f"phase {phase}: {cfg.name} {backend}, {cfg.n_layers} layers at "
          f"full width in fp32, batch {batch}, prefill {prompt_len} + "
          f"{steps} greedy steps: tokens identical, max|Δlogit|="
          f"{(lg_k - lg_p).abs().max().item():.3e}; launches {n_k}")
    del params
    torch.cuda.empty_cache()


def moe_layer_checks(arch, dev, phase, batch=8, seq=512) -> None:
    """Phase 20: one MoE layer of ``arch`` at full width in fp32.
    ``moe_apply`` against ``moe_dense_oracle`` on 2 x 512 tokens at a
    capacity where nothing drops (factor E / k: capacity N), normwise
    1e-5. Then the routing of ``batch`` x ``seq`` tokens (phase 21's
    prefill) on the card against the same on the CPU (the expert ids
    from the same inputs and weights: fp32 logits summed in other
    orders, so a choice whose probability ties another's to ~1e-7 may
    differ; more than 1 in 10,000 is a fault), and the dispatch's kept
    set on the card, at the prefill's capacity and at factor 0.5 (where
    pairs drop), equal to the CPU's on the same expert ids."""
    import torch
    from repro_torch.models import lm
    from repro_torch.models import moe as MOE
    from repro_torch.tree import tree_map
    cfg = full_width(arch, "linear", 1)
    m = cfg.moe
    p = tree_map(lambda x: x[0], lm.init_params(
        torch.Generator(device=dev).manual_seed(4), cfg)["stack"][0]["moe"])
    gen = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn((2, 512, cfg.d_model), generator=gen, device=dev)
    no_drop = dataclasses.replace(cfg, moe=dataclasses.replace(
        m, capacity_factor=m.n_experts / m.top_k))
    out, aux = MOE.moe_apply(p, x, no_drop)
    ref = MOE.moe_dense_oracle(p, x, cfg)
    err = normwise(out, ref, 1e-5, f"phase {phase} {arch} moe_apply")
    n = batch * seq
    xf = torch.randn((n, cfg.d_model), generator=gen, device=dev)
    _, experts, _ = MOE.route(p["router"], xf, m.top_k)
    _, experts_cpu, _ = MOE.route(p["router"].cpu(), xf.cpu(), m.top_k)
    differ = int((experts.cpu() != experts_cpu).sum())
    if differ > experts.numel() // 10000:
        raise AssertionError(f"phase {phase}: {differ} of "
                             f"{experts.numel()} routed experts differ "
                             f"from the CPU's")
    kept = {}
    for factor in (m.capacity_factor, 0.5):
        cap = MOE.capacity(n, m.top_k, m.n_experts, factor)
        slot, keep = MOE.dispatch_slots(experts, m.n_experts, cap)
        slot_c, keep_c = MOE.dispatch_slots(experts.cpu(), m.n_experts, cap)
        if not (torch.equal(keep.cpu(), keep_c)
                and torch.equal(slot.cpu(), slot_c)):
            raise AssertionError(f"phase {phase}: {arch} kept set at "
                                 f"capacity {cap} differs from the CPU's")
        kept[factor] = (cap, int((~keep).sum()))
    if not kept[0.5][1]:
        raise AssertionError(f"phase {phase}: no pair dropped at factor 0.5")
    loads = torch.bincount(experts.flatten(), minlength=m.n_experts)
    print(f"phase {phase}: {arch} MoE layer at full width fp32 "
          f"(E={m.n_experts}, top-{m.top_k}, F={m.d_ff_expert}, "
          f"{m.n_shared} shared): "
          f"moe_apply vs moe_dense_oracle normwise {err:.3e} (limit 1e-5, "
          f"1,024 tokens, nothing dropped), aux {aux.item():.6f}; routing of"
          f" {n} tokens: {differ} of {experts.numel()} choices differ from "
          f"the CPU's; kept set equal to the CPU's at capacity "
          f"{kept[m.capacity_factor][0]} (factor {m.capacity_factor}: "
          f"{kept[m.capacity_factor][1]} pairs dropped, expert loads "
          f"{int(loads.min())}-{int(loads.max())}) and at capacity "
          f"{kept[0.5][0]} (factor 0.5: {kept[0.5][1]} dropped)")
    del p
    torch.cuda.empty_cache()


def decode_bound_ms(params, states, cfg, batch, state_passes=2) -> tuple:
    """The least time of one decode step by bytes: every parameter read
    once (the embedding only at the batch's rows) and the decode state
    read and written once (``state_passes`` = 2; a KV cache is read once,
    1, its one new row left out), over the card's memory rate. Returns
    (ms, bytes)."""
    from repro_torch.tree import leaves
    embed = params["embed"]
    n_bytes = (sum(t.nbytes for t in leaves(params)) - embed.nbytes
               + batch * embed.shape[1] * embed.element_size()
               + state_passes * sum(t.nbytes for group in states.values()
                                    for st in group for t in st
                                    if t is not None))
    return n_bytes / PEAK_BYTES_PER_S * 1e3, n_bytes


def moe_generate_main_path(dev, phase) -> int:
    """Phase 21: ``serve --mode generate --arch deepseek-moe-16b`` at full
    width and depth (28 layers, parameters built in bf16), linear,
    batch 8, prompt 512, 64 generated tokens, every kernel's launch
    count set to 0 just before and read just after: B1 exactly 28 x 63
    times in the timed generation and 28 x 2 in the warm-up, no other
    kernel. Then ms/token against the step's bound by bytes, a profile
    of 4 decode steps (device busy share, the largest device
    operations). Returns B1's launches."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    args = serve.parse_args(["--arch", "deepseek-moe-16b", "--batch", "8",
                             "--prompt-len", "512", "--gen-len", "64",
                             "--seed", "0"])
    cfg = serve.serving_config(args)
    name = DECODE_KERNEL[cfg.attention_backend]
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = serve.generate(args)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (args.gen_len - 1)
    got = {k: n for k, n in launches.items() if n}
    if result["decode_launches"] != want or \
            got != {name: want + 2 * cfg.n_layers}:
        raise AssertionError(f"phase {phase}: {name} launched "
                             f"{result['decode_launches']} times in the "
                             f"timed generation (want {want}), {got} in the "
                             f"run (want {want + 2 * cfg.n_layers})")
    toks = result["tokens"]
    if toks.shape != (args.batch, args.gen_len) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"phase {phase}: bad generated tokens")
    state_bytes = (cfg.n_layers * args.batch * cfg.n_heads * cfg.head_dim
                   * (cfg.head_dim + 1) * 4)
    if result["state_mib"] != state_bytes / 2**20:
        raise AssertionError(f"phase {phase}: decode state "
                             f"{result['state_mib']} MiB, want "
                             f"{state_bytes / 2**20}")

    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = lm.param_count(params)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, 64), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    logits, st = lm.prefill(params, prompt, cfg)
    bound_ms, n_bytes = decode_bound_ms(params, st, cfg, args.batch)
    ms = result["decode_ms_per_token"]
    print(f"phase {phase}: deepseek-moe-16b main path ({cfg.n_layers} "
          f"layers, {n_params} parameters in bf16, linear) batch "
          f"{args.batch}, prompt {args.prompt_len}, {args.gen_len} tokens: "
          f"prefill_ms={result['prefill_ms']:.3f} "
          f"decode_ms_per_token={ms:.4f} tok_s={result['tokens_per_s']:.1f}"
          f" (bound {bound_ms:.3f} ms a step by bytes: "
          f"{n_bytes / 1e9:.3f} GB of weights and state at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s; {100 * bound_ms / ms:.1f}% "
          f"of it) state_mib={result['state_mib']:.2f} peak "
          f"{peak / 1e9:.3f} GB; {name}.launches={launches[name]} (timed "
          f"{result['decode_launches']} = {cfg.n_layers} x "
          f"{args.gen_len - 1}, warm-up {cfg.n_layers} x 2)")
    device_ms = profile_decode(params, cfg, st, torch.argmax(logits, -1),
                               64, kernel=f"{name}_kernel")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    if device_ms is not None:
        print(f"  device busy {100 * device_ms / ms:.1f}% of a decode step "
              f"({device_ms:.3f} ms device time per step over {ms:.3f} ms "
              f"per token; the bound is {100 * bound_ms / device_ms:.1f}% "
              f"of the device time)")
    del params, st, logits
    torch.cuda.empty_cache()
    return launches[name]


def moe_training_main_path(dev, phase) -> dict:
    """Phase 22, second part: ``launch/train.py --arch deepseek-moe-16b
    --n-layers 2`` (2 layers at full width: the 28-layer model's fp32
    master and AdamW moments do not fit one card), batch 8 x seq 1,024,
    4 steps, every kernel's launch count set to 0 just before and read
    just after: B2 twice per layer and step (forward, remat recompute),
    B3's two launches once each. Prints ms/step (steps 2-4), peak
    memory, the losses and the router's aux. Returns B2/B3's launches."""
    import math
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    names = TRAIN_KERNELS["linear"][0]
    args = train.parse_args(["--arch", "deepseek-moe-16b", "--n-layers", "2",
                             "--backend", "linear", "--batch", "8",
                             "--seq-len", "1024", "--steps", "4", "--lr",
                             "3e-4", "--warmup", "20", "--seed", "0",
                             "--log-every", "1"])
    cfg = train.config(args)
    torch.cuda.reset_peak_memory_stats()
    loop = train.build(args)
    n_params = lm.param_count(loop.params)
    reset_launches()
    out = loop.run()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps, n_layers = out["step"], cfg.n_layers
    want = dict(zip(names, (2 * n_layers * steps, n_layers * steps,
                            n_layers * steps)))
    got = {k: n for k, n in launches.items() if n}
    if steps != 4 or got != want:
        raise AssertionError(f"phase {phase}: {steps} steps, launches {got} "
                             f"(want {want})")
    losses = [m["loss"] for m in out["metrics"]]
    auxes = [m["aux"] for m in out["metrics"]]
    if not all(math.isfinite(x) for x in losses + auxes):
        raise AssertionError(f"phase {phase}: non-finite losses {losses}")
    times = [m["step_time"] for m in out["metrics"]]
    ms = sum(times[1:]) / len(times[1:]) * 1e3
    print(f"phase {phase}: training main path deepseek-moe-16b, "
          f"{n_layers} layers at full width ({n_params} params, fp32 master,"
          f" bf16 compute), batch {args.batch} x seq {args.seq_len}: "
          f"ms_per_step={ms:.3f} tokens_per_s="
          f"{args.batch * args.seq_len / ms * 1e3:.1f} (mean of steps 2-4; "
          f"step times ms {[round(t * 1e3, 3) for t in times]}), peak memory"
          f" {peak / 1e9:.3f} GB; losses {[round(x, 4) for x in losses]}, "
          f"aux {[round(x, 4) for x in auxes]}; launches {got}")
    release_train_loop()
    del loop, out
    torch.cuda.empty_cache()
    return {n: launches[n] for n in names}


def paper_identity_check(params, cfg, memory, dev, phase) -> float:
    """Phase 23: one cross layer's linear output against the paper's
    identity in fp64 over the raw keys and values,
    o = Σₙ (φ(q)·φ(kₙ)) vₙ / Σₙ φ(q)·φ(kₙ), through wo; normwise 1e-4
    (the layer sums 6,404 rows in fp32)."""
    import torch
    from repro_torch.models import attention as A
    from repro_torch.tree import tree_map
    pattern, _, _ = cfg.pattern_and_repeats
    p = tree_map(lambda x: x[0],
                 params["stack"][pattern.index("cross")]["cross"])
    b, n, _ = memory.shape
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    x = torch.randn((b, 16, cfg.d_model), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(7))
    got = A.cross_attention_apply(p, x, A.encode_cross_memory(p, memory, cfg),
                                  cfg)
    p64 = {k: v.double() for k, v in p.items()}
    m64 = memory.double()
    k = elu1((m64 @ p64["wk"]).reshape(b, n, hkv, dh))
    v = (m64 @ p64["wv"]).reshape(b, n, hkv, dh)
    q = elu1((x.double() @ p64["wq"]).reshape(b, 16, h // hkv, hkv, dh))
    scores = torch.einsum("btghd,bnhd->btghn", q, k)
    o = (torch.einsum("btghn,bnhd->btghd", scores, v)
         / scores.sum(-1)[..., None])
    want = o.reshape(b, 16, h * dh) @ p64["wo"]
    return normwise(got, want, 1e-4, f"phase {phase} cross layer")


def cross_slice(dev, phase) -> None:
    """Phase 23: llama-3.2-vision-90b at full width, one unit of its
    pattern (4 attn + 1 cross: 5 layers; 100 layers do not fit one card),
    fp32, batch 2, a memory of 6,404 image tokens, every xgate 0.5:
    ``generate_kernel_vs_reference`` under linear and softmax, then one
    cross layer against the paper's identity in fp64."""
    import torch
    from repro_torch.models import lm
    for backend in ("linear", "softmax"):
        cfg = full_width("llama-3.2-vision-90b", backend, 5)
        memory = torch.randn(
            (2, cfg.n_img_tokens, cfg.d_model), device=dev,
            generator=torch.Generator(device=dev).manual_seed(6))
        generate_kernel_vs_reference(cfg, dev, phase, batch=2,
                                     memory=memory, xgate=0.5)
    cfg = full_width("llama-3.2-vision-90b", "linear", 5)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    err = paper_identity_check(params, cfg, memory, dev, phase)
    print(f"phase {phase}: a cross layer's linear lookup (C = φ(K)ᵀV, z = "
          f"Σφ(K) over {cfg.n_img_tokens} image tokens, fp32) against the "
          f"paper's identity Σₙ φ(q)·φ(kₙ) vₙ / Σₙ φ(q)·φ(kₙ) in fp64: "
          f"normwise {err:.3e} (limit 1e-4)")
    del params, memory
    torch.cuda.empty_cache()


def vision_generate_main_path(dev, phase) -> dict:
    """Phase 24: ``serve --arch llama-3.2-vision-90b --n-layers 10`` (two
    units of its pattern: 8 attn + 2 cross layers at full width,
    parameters built in bf16; 100 layers do not fit one card), batch 4,
    prompt 512, 64 tokens, a memory of 6,404 image tokens, linear then
    softmax, every kernel's launch count set to 0 just before each and
    read just after: linear, B1 once per attn layer and decode step
    (cross layers look their memory up in plain PyTorch); softmax, B10
    once per attn layer and prefill. Prints prefill ms (the memory's
    encode included), ms/token and the cross memory per layer and
    sequence, C and z against K and V. Returns {kernel: launches}."""
    import torch
    from repro_torch.launch import serve
    runs, out = {}, {}
    for backend in ("linear", "softmax"):
        args = serve.parse_args(
            ["--arch", "llama-3.2-vision-90b", "--n-layers", "10",
             "--backend", backend, "--batch", "4", "--prompt-len", "512",
             "--gen-len", "64", "--seed", "0"])
        cfg = serve.serving_config(args)
        n_attn = attn_layers(cfg)
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        result = serve.generate(args)
        launches = read_launches()
        peak = torch.cuda.max_memory_allocated()
        got = {k: n for k, n in launches.items() if n}
        if backend == "softmax":
            name, want = "flash_attention_fwd", 2 * n_attn
            timed = result["prefill_launches"] == n_attn
        else:
            name = DECODE_KERNEL[backend]
            want = n_attn * (args.gen_len - 1 + 2)
            timed = result["decode_launches"] == n_attn * (args.gen_len - 1)
        if got != {name: want} or not timed:
            raise AssertionError(f"phase {phase}: {backend} launched {got} "
                                 f"(want {name} {want}), timed prefill "
                                 f"{result['prefill_launches']}, decode "
                                 f"{result['decode_launches']}")
        toks = result["tokens"]
        if toks.shape != (args.batch, args.gen_len) or not (
                (toks >= 0) & (toks < cfg.vocab_size)).all():
            raise AssertionError(f"phase {phase}: bad generated tokens")
        runs[backend] = result
        out[name] = launches[name]
        print(f"phase {phase}: llama-3.2-vision-90b {backend} main path "
              f"({cfg.n_layers} layers: {n_attn} attn + "
              f"{cfg.n_layers - n_attn} cross, bf16) batch {args.batch}, "
              f"prompt {args.prompt_len}, {cfg.n_img_tokens} image tokens, "
              f"{args.gen_len} tokens: prefill_ms={result['prefill_ms']:.3f}"
              f" (the memory's encode included) decode_ms_per_token="
              f"{result['decode_ms_per_token']:.4f} tok_s="
              f"{result['tokens_per_s']:.1f} state_mib="
              f"{result['state_mib']:.2f} peak {peak / 1e9:.3f} GB; "
              f"{name}.launches={launches[name]}")
        torch.cuda.empty_cache()
    cfg = serve.serving_config(args)
    hkv, dh, n = cfg.n_kv_heads, cfg.head_dim, cfg.n_img_tokens
    lin, soft = (runs[b]["cross_memory_bytes"] for b in ("linear",
                                                          "softmax"))
    if (lin, soft) != (hkv * (dh * dh + dh) * 4, 2 * hkv * n * dh * 2):
        raise AssertionError(f"phase {phase}: cross memory {lin} and {soft}"
                             f" bytes per layer and sequence")
    print(f"phase {phase}: cross memory per layer and sequence: linear C "
          f"and z {lin / 2**10:.1f} KiB (fp32, whatever the image's "
          f"length) against softmax K and V {soft / 2**20:.2f} MiB (bf16, "
          f"{n} rows): {soft / lin:.1f}x")
    return out



# ---------------------------------------------------------------------------
# phases 25-27: the dense family
# ---------------------------------------------------------------------------

DENSE_ARCHS = ("yi-34b", "internlm2-20b", "phi3-mini-3.8b", "musicgen-large")
# phase 26: each config and the backends it serves at full width and depth
DENSE_RUNS = (("phi3-mini-3.8b", ("linear", "gated_linear", "softmax")),
              ("musicgen-large", ("linear", "gated_linear", "softmax")),
              ("yi-34b", ("linear", "softmax")))
# what the card keeps free beside yi-34b's weights and state: the prefill's
# activations, the head's logits and the caching allocator's slack
DENSE_HEADROOM = 8 * 2**30
# depth cuts of phase 26 that keep the whole run inside its time (PERF.md
# §4): yi-34b at 4 of its 60 layers (phase 26 once served it whole, PRs
# 32-34 at 10), phi3-mini-3.8b at 8 of 32 and musicgen-large at 12 of 48
# (whole until PR 35, which added phases 41-43)
DENSE_CUTS = {"yi-34b": 4, "phi3-mini-3.8b": 8, "musicgen-large": 12}
# phase 27's depth: musicgen-large's stream at 12 of its 48 layers
DENSE_STREAM_LAYERS = 12
# qwen3-0.6b's stream, spec, lifecycle and prefix-cache paths (phases 16,
# 42, 43, 44) cut to 8 of its 28 layers for the run's time (phases 45-46
# run it whole)
SERVE_TIME_LAYERS = 8


def dense_kernel_checks(gen, dev) -> None:
    """Phase 2's checks at the dense family's shapes: B1 and B7 against
    their plain versions with the state bit for bit, B10 against its
    plain version and JAX's oracle."""
    import torch
    # the dense family: phi3-mini-3.8b's D = 96 (288 threads) and
    # musicgen-large's 64 at their serving rows (batch 8 x 32 heads) and
    # at the smoke rows, yi-34b's rows (batch 8 x 56 heads) at D = 128,
    # and musicgen-large's stream ingest (64-token chunks, rows of 0-64):
    # S and z bit for bit
    for n, d in ((256, 96), (256, 64), (448, 128)):
        for dtype in (torch.float32, torch.bfloat16):
            for normalize in (False, True):
                for w, varlen in ((1, False), (8, True)):
                    check_decode_linear(n, d, w, normalize, varlen, gen, dev,
                                        dtype=dtype, bitwise=True)
    for d in (96, 64):
        for normalize in (False, True):
            check_decode_linear(12, d, 8, normalize, True, gen, dev,
                                bitwise=True)
            check_decode_linear(256, d, 64, normalize, True, gen, dev,
                                bitwise=True)
    print("phase 2: decode_linear at D = 64 and 96 and yi-34b's rows: S "
          "and z bit for bit, o within 1e-5 fp32 and 1 bf16 ulp")
    # the dense family's head dims at their serving rows and the smoke
    # rows: S bit for bit
    for n, d in ((256, 96), (256, 64)):
        for dtype in (torch.bfloat16, torch.float32):
            for w, varlen in ((1, False), (8, True)):
                for decay in ("mild", "strong", "scalar"):
                    check_decode_gated(n, d, w, dtype, varlen, decay, gen,
                                       dev, bitwise=True)
    for d in (96, 64):
        check_decode_gated(12, d, 8, torch.bfloat16, True, "mild", gen, dev,
                           bitwise=True)
    print("phase 2: decode_gated at D = 64 and 96: S bit for bit, o "
          "within 1e-5 fp32 and 1 bf16 ulp")
    # the dense family at batch 8, T = S = 512, bf16: phi3-mini-3.8b (32
    # over 32 heads, D = 96) and musicgen-large (32 over 32, D = 64),
    # internlm2-20b (48 over 8) and yi-34b (56 over 8) at D = 128; then
    # D = 96 on both routes, one to one and in groups of 6 and 7, with
    # ragged T and S, t_off and s_real, and through the wrapper
    check_flash_attention(256, 512, 512, 96, torch.bfloat16, gen, dev,
                          kv_heads=32, heads=32)
    check_flash_attention(256, 512, 512, 64, torch.bfloat16, gen, dev,
                          kv_heads=32, heads=32)
    for h in (48, 56):
        check_flash_attention(8 * h, 512, 512, 128, torch.bfloat16, gen, dev,
                              kv_heads=8, heads=h)
    check_flash_attention(256, 512, 512, 96, torch.float32, gen, dev,
                          kv_heads=32, heads=32)
    for dtype in (torch.bfloat16, torch.float32):
        check_flash_attention(14, 77, 300, 96, dtype, gen, dev, t_off=5,
                              s_real=290, kv_heads=1, heads=7)
        check_flash_attention(12, 200, 200, 96, dtype, gen, dev,
                              s_real=150, kv_heads=1, heads=6)
        check_flash_attention(8, 130, 130, 96, dtype, gen, dev)
        check_flash_wrapper(2, 14, 2, 72, 200, dtype, gen, dev, d=96)
    print("phase 2: flash_attention_fwd at the dense family's shapes "
          "agrees with its plain version and JAX's oracle")


def dense_param_bytes(cfg) -> int:
    """Bytes of a dense config's parameters in ``cfg.param_dtype``: the
    embedding, the head unless tied, and per layer the projections, the
    MLP and the two norms (layernorm: scale and bias), then the final
    norm (the gated backend's decay projection left out)."""
    import torch
    from repro_torch.models.lm import dtype_of
    d, h, hkv, dh, f = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                        cfg.head_dim, cfg.d_ff)
    norm = (2 if cfg.norm == "layernorm" else 1) * d
    layer = (2 * d * h * dh + 2 * d * hkv * dh
             + (3 if cfg.act == "swiglu" else 2) * d * f + 2 * norm)
    n = (cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
         + cfg.n_layers * layer + norm)
    return n * torch.tensor([], dtype=dtype_of(cfg.param_dtype)).element_size()


def dense_state_sizes(cfg, batch, rows) -> dict:
    """MiB of the decode state at ``batch``: the linear backend's s and z
    per layer and head (fp32), the gated backend's s, and the softmax
    backend's K and V caches of ``rows`` rows per kv head (bf16); and the
    rows at which the KV cache reaches the linear state."""
    per_head = cfg.n_layers * batch * cfg.n_heads * cfg.head_dim * 4
    per_row = cfg.n_layers * batch * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    linear = per_head * (cfg.head_dim + 1)
    return {"linear": linear / 2**20,
            "gated_linear": per_head * cfg.head_dim / 2**20,
            "softmax": rows * per_row / 2**20,
            "crossover_rows": linear / per_row,
            "crossover_rows_s_only": per_head * cfg.head_dim / per_row}


def dense_generate_main_path(arch, backend, dev, phase) -> dict:
    """Phase 26: ``serve --mode generate --arch <arch> --backend
    <backend>`` at full width and depth (yi-34b cut to ``DENSE_CUTS``;
    parameters built in bf16), batch 8, prompt 512, 64 tokens, every
    kernel's launch count set to 0
    just before and read just after: B1 or B7 exactly layers x 63 times
    in the timed generation and layers x 2 in the warm-up, or B10 layers
    times in each of the two prefills, no other kernel. The memory the
    earlier phases still hold is printed first, and the depth is cut to
    the whole layers that fit beside it (printed; yi-34b's 68.8 GB of
    bf16 weights are the largest). Then the decode state's MiB against
    the other backend's, peak memory, ms/token against the step's bound
    by bytes, and a profile of 4 decode steps at the run's cache length
    (device busy share). Returns the launches and the numbers."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import lm
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    free, total = torch.cuda.mem_get_info()
    argv = ["--arch", arch, "--backend", backend, "--batch", "8",
            "--prompt-len", "512", "--gen-len", "64", "--seed", "0"]
    cfg = serve.serving_config(serve.parse_args(argv))
    whole = dense_param_bytes(cfg)
    fixed = dense_param_bytes(dataclasses.replace(cfg, n_layers=0))
    cut = ""
    if arch in DENSE_CUTS:
        argv += ["--n-layers", str(DENSE_CUTS[arch])]
        cut = (f" (cut from {cfg.n_layers}: DENSE_CUTS, the run's time; "
               f"{whole / 1e9:.3f} GB of weights whole)")
    elif whole + DENSE_HEADROOM > free:
        n_layers = int((free - DENSE_HEADROOM - fixed)
                       // ((whole - fixed) / cfg.n_layers))
        argv += ["--n-layers", str(n_layers)]
        cut = (f" (cut from {cfg.n_layers}: {whole / 1e9:.3f} GB of "
               f"weights and {DENSE_HEADROOM / 2**30:.0f} GiB of headroom, "
               f"{free / 1e9:.3f} GB free)")
    args = serve.parse_args(argv)
    cfg = serve.serving_config(args)
    n_layers = cfg.n_layers
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = serve.generate(args)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    got = {k: n for k, n in launches.items() if n}
    softmax = backend == "softmax"
    if softmax:
        name, want = "flash_attention_fwd", 2 * n_layers
        timed = (result["prefill_launches"] == n_layers
                 and not result["decode_launches"])
    else:
        name = DECODE_KERNEL[backend]
        want = n_layers * (args.gen_len - 1 + 2)
        timed = (result["decode_launches"] == n_layers * (args.gen_len - 1)
                 and not result["prefill_launches"])
    if got != {name: want} or not timed:
        raise AssertionError(f"phase {phase}: {arch} {backend} launched "
                             f"{got} (want {name} {want}), timed prefill "
                             f"{result['prefill_launches']}, decode "
                             f"{result['decode_launches']}")
    toks = result["tokens"]
    if toks.shape != (args.batch, args.gen_len) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"phase {phase}: bad generated tokens")
    max_len = args.prompt_len + args.gen_len
    sizes = dense_state_sizes(cfg, args.batch, max_len)
    if result["state_mib"] != sizes[backend]:
        raise AssertionError(f"phase {phase}: decode state "
                             f"{result['state_mib']} MiB, want "
                             f"{sizes[backend]}")
    other = "linear" if softmax else "softmax"
    ms = result["decode_ms_per_token"]
    print(f"phase {phase}: {arch} {backend} main path ({n_layers} layers"
          f"{cut}, {cfg.n_heads} heads over {cfg.n_kv_heads}, head dim "
          f"{cfg.head_dim}, {cfg.norm}, {cfg.act}; bf16) batch "
          f"{args.batch}, prompt {args.prompt_len}, {args.gen_len} tokens: "
          f"prefill_ms={result['prefill_ms']:.3f} "
          f"decode_ms_per_token={ms:.4f} tok_s={result['tokens_per_s']:.1f}"
          f" state_mib={result['state_mib']:.2f} (the {other} backend's"
          f" at these rows: {sizes[other]:.2f} MiB); "
          f"{name}.launches={launches[name]} ("
          + (f"timed prefill {result['prefill_launches']} = {n_layers} "
             f"layers, warm-up {n_layers}" if softmax else
             f"timed {result['decode_launches']} = {n_layers} x "
             f"{args.gen_len - 1}, warm-up {n_layers} x 2")
          + f"); held before {held / 1e9:.3f} GB, peak {peak / 1e9:.3f} GB")

    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    logits, st = lm.prefill(params, prompt, cfg)
    st = lm.pad_decode_state(st, cfg, max_len)
    bound_ms, n_bytes = decode_bound_ms(params, st, cfg, args.batch,
                                        state_passes=1 if softmax else 2)
    print(f"  bound {bound_ms:.3f} ms a decode step by bytes ("
          f"{n_bytes / 1e9:.3f} GB of weights and "
          f"{'the KV cache read' if softmax else 'state read and written'}"
          f" at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s): {100 * bound_ms / ms:.1f}"
          f"% of the measured ms/token")
    device_ms = profile_decode(params, cfg, st, torch.argmax(logits, -1),
                               args.prompt_len,
                               kernel=None if softmax else f"{name}_kernel")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    busy = None
    if device_ms is not None:
        busy = device_ms / ms
        print(f"  device busy {100 * busy:.1f}% of a decode step "
              f"({device_ms:.3f} ms device time per step over {ms:.3f} ms "
              f"per token; the bound is {100 * bound_ms / device_ms:.1f}% "
              f"of the device time)")
    del params, st, logits, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return {"name": name, "launches": launches[name], "layers": n_layers,
            "full_layers": get_config(arch).n_layers,
            "prefill_ms": result["prefill_ms"], "ms_per_token": ms,
            "bound_ms": bound_ms, "busy": busy, "peak": peak,
            "state_mib": result["state_mib"], "sizes": sizes}


def dense_kernel_times(arch, backends, gen, dev) -> dict:
    """B1, B7 and B10 at ``arch``'s serving shapes (batch 8): B1/B7 one
    step over 8·H rows at D, B10 over T = S = 512 with K/V of its kv
    heads, each beside its bound, its plain version and, for B10,
    ``scaled_dot_product_attention``. Returns {kernel: record}."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    b, n, d = 8, 8 * cfg.n_heads, cfg.head_dim
    out = {}
    for backend, name, timer in (("linear", "decode_linear",
                                  time_decode_linear),
                                 ("gated_linear", "decode_gated",
                                  time_decode_gated)):
        if backend in backends:
            t = timer(n, d, gen, dev)
            print(f"{name} {arch} N={n} D={d} W=1 bf16: "
                  f"{t['ms'] * 1e3:.2f} us/launch (plain version "
                  f"{t['plain_ms'] * 1e3:.2f} us; bound "
                  f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']}, "
                  f"{t['bytes'] / 1e6:.2f} MB moved)")
            out[name] = {"shape": f"{arch}: N={n} D={d} W=1 bf16",
                         "ms": t["ms"], "plain_ms": t["plain_ms"],
                         "bound_ms": t["bound_ms"],
                         "bound_by": t["bound_by"], "library_ms": None}
    if "softmax" in backends:
        r = time_flash_attention(b, cfg.n_heads, cfg.n_kv_heads, 512, d,
                                 gen, dev)
        print(f"flash_attention_fwd {arch} rows={n} kv_rows="
              f"{b * cfg.n_kv_heads} T=S=512 D={d} bf16 causal: "
              f"{r['ms'] * 1e3:.2f} us/launch, with the lse "
              f"{r['lse_ms'] * 1e3:.2f} us (plain version "
              f"{r['plain_ms'] * 1e3:.2f} us; scaled_dot_product_attention("
              f"is_causal=True, enable_gqa=True) {r['library_ms'] * 1e3:.2f}"
              f" us, max|Δ| against the kernel "
              f"{r['library_max_abs_diff']:.3e}; bound "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']}, "
              f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.2f} MB)")
        out["flash_attention_fwd"] = {
            "shape": f"{arch}: rows={n} kv_rows={b * cfg.n_kv_heads} "
                     f"T=S=512 D={d} bf16",
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"]}
    return out


# ---------------------------------------------------------------------------
# phases 28-32: the dense family's training through B2/B3 and B8/B9 at head
# dims 96 and 64, and rwkv6-1.6b served with its prefill through B8's
# exclusive route
# ---------------------------------------------------------------------------

# phase 29: the configs the card trains, at full width
DENSE_TRAIN_ARCHS = ("phi3-mini-3.8b", "musicgen-large")
# training bytes per parameter: the fp32 master and its gradient, AdamW's
# two fp32 moments, and the bf16 copy the step computes with
TRAIN_BYTES_PER_PARAM = 4 + 4 + 8 + 2
# what the card keeps free beside them: the remat units' saved inputs, one
# layer's recomputed activations and their gradients, the head's logits
# in fp32 with their softmax temporaries, and the caching allocator's slack
TRAIN_HEADROOM = 16 * 2**30
# phases 29 and 37: the most layers trained, for the run's time (PERF.md
# §4; until PR 35 the depth was cut only to what fits)
TRAIN_TIME_LAYERS = {"phi3-mini-3.8b": 8, "musicgen-large": 12,
                     "zamba2-7b": 12}


def training_kernel_checks(gen, dev) -> None:
    """Phase 2's checks of B2/B3 and B8/B9 at the head dims 64 and 96
    (musicgen-large and RWKV-6; phi3-mini-3.8b): each against its plain
    version in fp32 and bf16 at T a multiple of the chunk but not of the
    kernels' tiles (32 tokens on FMAs, 64 on the tensor cores) and at a
    ragged T, at the training main path's rows (batch 8 x 32 heads, T =
    1,024) in bf16, B3's and B9's launches each on its own, the final
    states far from symmetric, through the wrappers (padding, per-head
    decay); B8/B9 at the decay clamp and at each route's limit against
    ``gla_scan``; then B8's exclusive route with RWKV-6's per-head bonus
    at rwkv6-1.6b's prefill shape (batch 8 x 32 heads, T = 512, D = 64)
    and at the clamp."""
    import torch
    for d in (96, 64):
        training_kernel_checks_at(d, gen, dev)
    print(f"phase 2: linear_attention_fwd, _bwd_dq, _bwd_dkv and "
          f"gated_linear_attention_fwd (inclusive, exclusive + u), _bwd_dq, "
          f"_bwd_dkv at D = 96 and 64 agree with their plain versions "
          f"(normwise {LA_TOL}; the fp32 states within "
          f"{LA_TOL['float32']}) and, at the clamp and at each route's "
          f"limit, with gla_scan")
    check_rwkv6_prefill(8, 32, 512, 64, torch.bfloat16, gen, dev)
    check_rwkv6_prefill(2, 3, 200, 64, torch.float32, gen, dev)
    check_rwkv6_prefill(2, 3, 75, 96, torch.bfloat16, gen, dev)
    for dtype in (torch.bfloat16, torch.float32):
        check_rwkv6_clamp(dtype, gen, dev)


def training_kernel_checks_at(d, gen, dev) -> None:
    """``training_kernel_checks`` at one head dim ``d``: B2/B3 and B8/B9
    at the training rows (batch 8 x 32 heads, T = 1,024) in bf16, at T a
    multiple of the chunk but not of the tiles and at a ragged T in fp32
    and bf16, through the wrappers, and B8/B9 at the clamp and at each
    route's limit."""
    import torch
    check_linear_attention_rows(256, 1024, d, torch.bfloat16, 128, gen,
                                dev)
    for bh, t, chunk in ((6, 272, 16), (4, 75, 75)):
        check_linear_attention_rows(bh, t, d, torch.float32, chunk, gen,
                                    dev)
    for bh, t, chunk in ((6, 272, 16), (4, 75, 75), (6, 48, 16),
                         (6, 200, 40)):
        check_linear_attention_rows(bh, t, d, torch.bfloat16, chunk,
                                    gen, dev)
    for dtype in (torch.float32, torch.bfloat16):
        check_linear_attention_wrapper(200, d, dtype, 128, gen, dev)
    check_gla_rows(256, 1024, d, torch.bfloat16, 128, "model", gen, dev)
    for bh, t, chunk in ((6, 272, 16), (4, 75, 75)):
        check_gla_rows(bh, t, d, torch.float32, chunk, "mild", gen, dev)
    for bh, t, chunk in ((6, 272, 16), (4, 75, 75), (6, 48, 16),
                         (6, 200, 40)):
        for decay in ("model", "mild"):
            check_gla_rows(bh, t, d, torch.bfloat16, chunk, decay, gen,
                           dev)
    for dtype in (torch.float32, torch.bfloat16):
        check_gla_wrapper(200, d, dtype, 128, dtype == torch.bfloat16,
                          gen, dev)
        check_gla_clamp(dtype, gen, dev, d=d)
    check_decay_limit(gen, dev, d=d)


def rwkv_rows(b, h, t, d, dtype, gen, dev):
    """(B, H, T, D) q, k, v in ``dtype`` and an fp32 log-decay of RWKV-6's
    range (its init's -exp(w̃), -0.3 to -0.9 a token: a 64-token tile
    reaches b = -57.6), and a bonus u of one row per head, (H, D)."""
    import torch
    r = lambda *s: torch.randn(s, generator=gen, device=dev)  # noqa: E731
    q, k, v = (r(b, h, t, d).to(dtype) for _ in range(3))
    g = -(0.3 + 0.6 * torch.rand((b, h, t, d), generator=gen, device=dev))
    return q, k, v, g, r(h, d)


def check_rwkv6_prefill(b, h, t, d, dtype, gen, dev) -> float:
    """B8's exclusive route through ``rwkv6_attention`` (one launch for
    every head, each row reading its head's u) against its plain version
    in 64-token chunks (``models.rwkv6.PREFILL_CHUNK``): o normwise
    1e-5 / 8e-3, the fp32 state within 1e-5 and far from symmetric; and
    a u shared by every head is further off than the tolerance, so a
    kernel that read one u for all rows would fail. Returns max|Δo|."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    q, k, v, g, u = rwkv_rows(b, h, t, d, dtype, gen, dev)
    n0 = GL.fwd.launches
    o, s = GL.rwkv6_attention(q, k, v, g, u, chunk=64)
    torch.cuda.synchronize()
    if GL.fwd.launches != n0 + 1:
        raise AssertionError("rwkv6_attention: not one launch")
    o_r, s_r = GL.rwkv6_attention(q, k, v, g, u, chunk=64, kernel=False)
    o_1, _ = GL.rwkv6_attention(q, k, v, g, u[0], chunk=64, kernel=False)
    name = str(dtype).split(".")[-1]
    tag = f"B={b} H={h} T={t} D={d} {name}"
    err = normwise(o, o_r, LA_TOL[name], f"rwkv6_attention o {tag}")
    s_err = normwise(s, s_r, LA_TOL["float32"], f"rwkv6_attention S {tag}")
    asym = ((s_r - s_r.mT).abs().max() / s_r.abs().max()).item()
    shared = ((o_1.float() - o_r.float()).abs().max()
              / o_r.float().abs().max()).item()
    if not (asym > 100 * LA_TOL["float32"] and shared > 2 * LA_TOL[name]):
        raise AssertionError(f"rwkv6_attention {tag}: state asymmetry "
                             f"{asym:.3e}, shared-u distance {shared:.3e}")
    print(f"  rwkv6_attention (B8 exclusive, u per head) {tag}: max|Δo|="
          f"{err:.3e} ({err / o_r.float().abs().max().item():.2e} of "
          f"max|o|), max|ΔS|={s_err:.3e} (|S - Sᵀ| {asym:.2f} max|S|); one "
          f"u for every head moves o by {shared:.2e} of max|o|")
    return err


def check_rwkv6_clamp(dtype, gen, dev) -> None:
    """RWKV-6's prefill at the clamp (g ≡ -1, T = 512, D = 64, u per
    head): B8's exclusive route, finite, against ``gla_scan(exclusive,
    u)`` evaluated in fp32 on the same values, normwise 1e-5 / 8e-3."""
    import torch
    from repro_torch.core.gated import gla_scan
    from repro_torch.kernels.gated_linear_attention import ops as GL
    q, k, v, _, u = rwkv_rows(1, 2, 512, 64, dtype, gen, dev)
    g = torch.full(q.shape, -1.0, device=dev)
    o, s = GL.rwkv6_attention(q, k, v, g, u, chunk=64)
    o_r, s_r = gla_scan(q.float(), k.float(), v.float(), g, exclusive=True,
                        u=u)
    torch.cuda.synchronize()
    name = str(dtype).split(".")[-1]
    if not (torch.isfinite(o).all() and torch.isfinite(s).all()):
        raise AssertionError(f"rwkv6_attention at the clamp {name}: "
                             f"non-finite")
    err = normwise(o, o_r, LA_TOL[name], f"rwkv6 clamp {name} o")
    s_err = normwise(s, s_r, LA_TOL["float32"], f"rwkv6 clamp {name} S")
    print(f"  rwkv6_attention at the clamp (g = -1, T=512, D=64, {name}): "
          f"max|Δo| {err:.3e}, max|ΔS| {s_err:.3e} against gla_scan "
          f"(exclusive, u per head) in fp32")


def train_param_split(cfg, dev) -> tuple:
    """(parameters outside the repeats, parameters a repeat of the
    pattern) of ``cfg``: one repeat drawn on the card in bf16 and
    counted. The shared attention's one parameter set counts outside."""
    import torch
    from repro_torch.configs.base import with_depth
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    unit = dataclasses.replace(with_depth(cfg, len(cfg.layer_pattern)),
                               param_dtype="bfloat16")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), unit)
    per_unit = sum(x.numel() for x in leaves(params["stack"]))
    fixed = lm.param_count(params) - per_unit
    del params
    torch.cuda.empty_cache()
    return fixed, per_unit


def cut_training_main_path(arch, backend, dev, phase) -> dict:
    """Phases 29, 37 and 38: ``launch/train.py --arch <arch> [--backend
    <backend>]`` (rwkv6-1.6b has no attention layer), fp32 master, bf16
    compute, remat per unit, batch 8 x 1,024, 6 steps (2 warm-up, 4
    timed), every kernel's launch count set to 0 just before and read
    just after: exactly ``train_launches`` a step. The depth is cut, in
    whole repeats of the layer pattern (the tail dropped), to what fits
    beside the memory the earlier phases hold (``TRAIN_BYTES_PER_PARAM``
    a parameter and ``TRAIN_HEADROOM``), and printed. Prints ms/step,
    tokens/s, peak memory against the parameters, gradients and moments,
    the launches per kernel and step, and a profile of one step with the
    kernels' share of device time. Returns the launches and the
    measurements."""
    import gc
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.configs.base import depth_cut
    from repro_torch.launch import train
    from repro_torch.models import lm
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    free, _ = torch.cuda.mem_get_info()
    full = get_config(arch)
    full = full.with_backend(backend) if backend else full
    pattern, reps, tail = full.pattern_and_repeats
    fixed, unit = train_param_split(full, dev)
    fit = int((free - TRAIN_HEADROOM) / TRAIN_BYTES_PER_PARAM - fixed) \
        // unit
    units = min(reps, fit, TRAIN_TIME_LAYERS.get(arch, full.n_layers)
                // len(pattern))
    cut = units < reps or bool(tail)
    argv = ["--arch", arch, "--batch", "8", "--seq-len", "1024", "--steps",
            "6", "--lr", "3e-4", "--warmup", "20", "--seed", "0",
            "--log-every", "1"]
    argv += ["--backend", backend] if backend else []
    argv += ["--n-layers", str(units * len(pattern))] if cut else []
    args = train.parse_args(argv)
    cfg = train.config(args)
    what = (f"{depth_cut(full, cfg)}: {fixed / 1e9:.3f} B parameters "
            f"outside the repeats and {unit / 1e9:.4f} B a repeat x "
            f"{TRAIN_BYTES_PER_PARAM} bytes and "
            f"{TRAIN_HEADROOM / 2**30:.0f} GiB of headroom against "
            f"{free / 1e9:.3f} GB free fit {fit} repeats, and "
            f"TRAIN_TIME_LAYERS (the run's time) allows "
            f"{TRAIN_TIME_LAYERS.get(arch, full.n_layers)} layers" if cut
            else f"whole, {full.n_layers} layers")
    torch.cuda.reset_peak_memory_stats()
    loop = train.build(args)
    n_params = lm.param_count(loop.params)
    if n_params != fixed + units * unit:
        raise AssertionError(f"phase {phase}: {n_params} parameters, "
                             f"reckoned {fixed + units * unit}")
    reset_launches()
    out = loop.run()
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    steps = out["step"]
    per_step = train_launches(cfg)
    want = {k: n * steps for k, n in per_step.items()}
    got = {k: n for k, n in launches.items() if n}
    if steps != 6 or got != want:
        raise AssertionError(f"phase {phase}: {steps} steps, launches {got} "
                             f"(want {want})")
    losses = [m["loss"] for m in out["metrics"]]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"phase {phase}: non-finite losses {losses}")
    times = [m["step_time"] for m in out["metrics"]]
    ms = sum(times[2:]) / len(times[2:]) * 1e3
    tok_s = args.batch * args.seq_len / ms * 1e3
    reckoned = n_params * TRAIN_BYTES_PER_PARAM
    print(f"phase {phase}: training main path {arch} "
          f"{backend or '(time-mix: B8 exclusive)'} ({what}; {n_params} "
          f"params, head dim {cfg.head_dim}, fp32 master, bf16 compute, "
          f"remat={cfg.remat}), batch "
          f"{args.batch} x seq {args.seq_len}: ms_per_step={ms:.3f} "
          f"tokens_per_s={tok_s:.1f} (mean of steps 3-6; step times ms "
          f"{[round(t * 1e3, 3) for t in times]}); peak memory "
          f"{peak / 1e9:.3f} GB against {reckoned / 1e9:.3f} GB of "
          f"parameters, gradients, moments and bf16 copy (the rest "
          f"{(peak - reckoned) / 1e9:.3f} GB: activations and temporaries); "
          f"held before {held / 1e9:.3f} GB")
    print(f"  losses {[round(x, 4) for x in losses]}; launches per step "
          f"(exactly {cfg.n_layers} layers' kinds, the forward kernel twice "
          f"a repeat: forward, remat recompute): {per_step}")
    batch = loop.put_batch(loop.dataset.batch_at(steps))
    prof = profile_train_step(loop, batch, ("sweep", "flash_fwd",
                                            "exclusive_d"))
    share = None
    if prof["busy"] is not None:
        kernel_ms = sum(prof["kinds"].get(k, (0.0, 0))[0]
                        for k in ("B2/B3", "B8/B9", "B10"))
        share = kernel_ms / prof["device_ms"]
        print(f"  device busy {100 * prof['busy']:.1f}% of a profiled step; "
              f"{prof['device_ms']:.3f} ms device time against {ms:.3f} ms "
              f"per step unprofiled; the hand-written kernels "
              f"{kernel_ms:.3f} ms, {100 * share:.1f}% of the device time")
    release_train_loop()
    del loop, out, batch
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": {k: launches[k] for k in want}, "ms": ms,
            "tok_s": tok_s, "layers": cfg.n_layers, "peak": peak,
            "busy": prof["busy"], "kernel_share": share}


def dense_training_main_path(arch, backend, dev, gen, phase) -> dict:
    """Phase 29: ``cut_training_main_path`` for a dense config under
    ``backend`` (B2/B3 or B8/B9 at its head dim), then the kernels timed
    at the config's shape (rows 8 x 32 heads, T = 1,024, D) beside their
    bounds and plain versions. Returns the launches and the kernels'
    records at the shape."""
    import torch
    from repro_torch.configs import get_config
    names, ids, _, _, _, bf16_kernels = TRAIN_KERNELS[backend]
    run = cut_training_main_path(arch, backend, dev, phase)
    cfg = get_config(arch)
    t = {"linear": time_linear_attention,
         "gated_linear": time_gated_linear_attention}[backend](
        8 * cfg.n_heads, 1024, cfg.head_dim, cfg.linear_chunk, gen, dev)
    shapes = {}
    for name, cuda_kernel in zip(names, bf16_kernels):
        r = t[name]
        shape = (f"{arch}: rows={8 * cfg.n_heads} T=1024 D={cfg.head_dim} "
                 f"bf16")
        print(f"{name} [{cuda_kernel}] {shape}: {r['ms'] * 1e3:.2f} "
              f"us/launch (plain version {r['plain_ms'] * 1e3:.2f} us; "
              f"library call: none; bound {r['bound_ms'] * 1e3:.2f} us by "
              f"{r['bound_by']} on bf16 tensor cores, "
              f"{r['fp32_bound_ms'] * 1e3:.2f} us at the fp32 rate; "
              f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.2f} MB)")
        shapes[name] = {"shape": shape, "ms": r["ms"],
                        "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                        "bound_by": r["bound_by"], "library_ms": None}
    r = t["bwd"]
    print(f"{ids[1][:2]} as a whole (ops.bwd, both launches) {arch}: "
          f"{r['ms'] * 1e3:.2f} us against {r['bound_ms'] * 1e3:.2f} us by "
          f"{r['bound_by']}; plain version {r['plain_ms'] * 1e3:.2f} us")
    torch.cuda.empty_cache()
    return {"launches": run["launches"], "shapes": shapes,
            "layers": run["layers"]}


RWKV_ARCH = "rwkv6-1.6b"


def rwkv6_slice(dev, phase, batch=4, prompt_len=200, steps=16) -> None:
    """Phase 30: rwkv6-1.6b at full width, 2 layers, fp32: prefill of
    ``prompt_len`` tokens through B8's exclusive route (one launch per
    layer) + ``steps`` greedy decode steps (plain PyTorch on both
    routes), against the same with the prefill's plain version
    (``attention_kernel=False``): tokens identical, logits within 1e-4,
    B8 launched 2 times on the kernel route and no kernel on the other.
    (Its training, through B8's exclusive route and the exclusive
    backward, is phase 36's.)"""
    import torch
    from repro_torch.models import lm
    cfg = full_width(RWKV_ARCH, "gated_linear", 2)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    for group in params["stack"]:       # the bonus off its zero init
        group["u_bonus"].normal_(
            0.0, 0.5, generator=torch.Generator(device=dev).manual_seed(3))
    prompt = torch.randint(0, cfg.vocab_size, (batch, prompt_len),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(2))
    runs = {}
    for kernel in (True, False):
        reset_launches()
        logits, st = lm.prefill(params, prompt, cfg, attention_kernel=kernel)
        tok = lm.sample_token(logits, 0.0)
        all_logits, toks = [logits], [tok]
        for i in range(steps):
            logits, st = lm.decode_step(params, st, tok, prompt_len + i, cfg)
            tok = lm.sample_token(logits, 0.0)
            all_logits.append(logits)
            toks.append(tok)
        torch.cuda.synchronize()
        got = {k: n for k, n in read_launches().items() if n}
        want = {"gated_linear_attention_fwd": cfg.n_layers} if kernel else {}
        if got != want:
            raise AssertionError(f"phase {phase}: {cfg.name} launched {got} "
                                 f"(kernels={kernel}), want {want}")
        runs[kernel] = (torch.stack(all_logits), torch.stack(toks), st)
    (lg_k, tok_k, st_k), (lg_p, tok_p, st_p) = runs[True], runs[False]
    if not torch.isfinite(lg_k).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    if not torch.equal(tok_k, tok_p):
        raise AssertionError(f"phase {phase}: {cfg.name}: greedy tokens "
                             f"differ")
    torch.testing.assert_close(lg_k, lg_p, rtol=1e-4, atol=1e-4)
    wkv_err = max((a.wkv - b.wkv).abs().max().item()
                  for a, b in zip(st_k["stack"], st_p["stack"]))
    print(f"phase {phase}: {cfg.name}, 2 layers at full width in fp32 "
          f"(d_model {cfg.d_model}, {cfg.d_model // cfg.rwkv.head_dim} "
          f"heads of {cfg.rwkv.head_dim}, u drawn), batch {batch}, prefill "
          f"{prompt_len} through B8's exclusive route + {steps} greedy "
          f"steps: tokens identical, max|Δlogit|="
          f"{(lg_k - lg_p).abs().max().item():.3e}, the final wkv states "
          f"within {wkv_err:.3e}")
    del params, runs
    torch.cuda.empty_cache()


def time_rwkv6_prefill(b, h, t, d, gen, dev) -> dict:
    """B8's exclusive route at RWKV-6's prefill shape (bf16 q, k, v; fp32
    g and u of one row per head), with its plain version in 64-token
    chunks, from CUDA-graph replays. Bounds as
    ``time_gated_linear_attention``'s: q, k, v read and o written in
    bf16, g read and the state written in fp32 (u's H·D floats beside),
    over 3.35 TB/s; or the scan form's two products (the state update,
    q against the state) plus the bonus and one exp per decay element,
    over the bf16 tensor-core rate."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    q, k, v, g, u = rwkv_rows(b, h, t, d, torch.bfloat16, gen, dev)
    ops, n_bytes = GL.fwd_work(*(x.reshape(b * h, t, d) for x in (q, k, v)),
                               g.expand(q.shape).reshape(b * h, t, d),
                               u=u, exclusive=True)
    return dict(ms=graph_ms(lambda i: GL.rwkv6_attention(q, k, v, g, u,
                                                         chunk=64), 4,
                            replays=5),
                plain_ms=graph_ms(lambda i: GL.rwkv6_attention(
                    q, k, v, g, u, chunk=64, kernel=False), 2, replays=3),
                library_ms=None, fp32_bound_ms=bound(n_bytes, ops)[
                    "bound_ms"],
                **bound(n_bytes, ops, PEAK_BF16_TC_FLOPS))


def rwkv6_generate_main_path(dev, gen, phase) -> dict:
    """Phase 31: ``serve --mode generate --arch rwkv6-1.6b`` at full width
    and depth (24 layers, d_model 2,048, 32 heads of 64, vocab 65,536;
    parameters built in bf16), batch 8, prompt 512, 64 tokens, every
    kernel's launch count set to 0 just before and read just after: B8's
    exclusive route exactly 24 times in each of the two prefills (the
    warm-up's and the timed one), no other kernel (decode is plain
    PyTorch). Prints prefill ms, ms/token beside the step's bound by
    bytes, the decode state's MiB, peak memory, a profile of 4 decode
    steps (device busy share), and B8's exclusive route timed at the
    prefill's shape beside its bounds and plain version. Returns the
    launches, the numbers and the kernel's record at the shape."""
    import gc
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    gc.collect()
    torch.cuda.empty_cache()
    args = serve.parse_args(["--arch", RWKV_ARCH, "--batch", "8",
                             "--prompt-len", "512", "--gen-len", "64",
                             "--seed", "0"])
    cfg = serve.serving_config(args)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = serve.generate(args)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    got = {k: n for k, n in launches.items() if n}
    name = "gated_linear_attention_fwd"
    if got != {name: 2 * cfg.n_layers} or \
            result["prefill_launches"] != cfg.n_layers or \
            result["decode_launches"]:
        raise AssertionError(f"phase {phase}: launched {got}, timed prefill "
                             f"{result['prefill_launches']} (want "
                             f"{cfg.n_layers} of {name} per prefill)")
    toks = result["tokens"]
    if toks.shape != (args.batch, args.gen_len) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"phase {phase}: bad generated tokens")
    h, n = cfg.d_model // cfg.rwkv.head_dim, cfg.rwkv.head_dim
    state_mib = cfg.n_layers * args.batch * (2 * cfg.d_model * 2
                                             + h * n * n * 4) / 2**20
    if result["state_mib"] != state_mib:
        raise AssertionError(f"phase {phase}: decode state "
                             f"{result['state_mib']} MiB, want {state_mib}")
    ms = result["decode_ms_per_token"]
    print(f"phase {phase}: {RWKV_ARCH} main path ({cfg.n_layers} layers, "
          f"d_model {cfg.d_model}, {h} heads of {n}, vocab "
          f"{cfg.vocab_size}; bf16) batch {args.batch}, prompt "
          f"{args.prompt_len}, {args.gen_len} tokens: prefill_ms="
          f"{result['prefill_ms']:.3f} decode_ms_per_token={ms:.4f} "
          f"tok_s={result['tokens_per_s']:.1f} state_mib="
          f"{result['state_mib']:.2f} (two shift rows bf16 and the wkv "
          f"matrices fp32 a layer); {name}.launches={launches[name]} "
          f"(timed prefill {result['prefill_launches']} = {cfg.n_layers} "
          f"layers, warm-up {cfg.n_layers}); peak {peak / 1e9:.3f} GB")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    logits, st = lm.prefill(params, prompt, cfg)
    bound_ms, n_bytes = decode_bound_ms(params, st, cfg, args.batch)
    print(f"  bound {bound_ms:.3f} ms a decode step by bytes "
          f"({n_bytes / 1e9:.3f} GB of weights and state read and written "
          f"at {PEAK_BYTES_PER_S / 1e12:.2f} TB/s): "
          f"{100 * bound_ms / ms:.1f}% of the measured ms/token")
    device_ms = profile_decode(params, cfg, st, torch.argmax(logits, -1),
                               args.prompt_len)
    if not torch.isfinite(logits).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    busy = None
    if device_ms is not None:
        busy = device_ms / ms
        print(f"  device busy {100 * busy:.1f}% of a decode step "
              f"({device_ms:.3f} ms device time per step over {ms:.3f} ms "
              f"per token)")
    del params, st, logits, prompt
    gc.collect()
    torch.cuda.empty_cache()
    t = time_rwkv6_prefill(args.batch, h, args.prompt_len, n, gen, dev)
    shape = (f"{RWKV_ARCH} prefill: exclusive + u per head, rows="
             f"{args.batch * h} T={args.prompt_len} D={n} bf16")
    print(f"{name} [decay_sweep_fwd_tc<64, true>] {shape}: "
          f"{t['ms'] * 1e3:.2f} us/launch (plain version "
          f"{t['plain_ms'] * 1e3:.2f} us; library call: none; bound "
          f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} on bf16 tensor "
          f"cores, {t['fp32_bound_ms'] * 1e3:.2f} us at the fp32 rate; "
          f"{t['flops'] / 1e9:.2f} GFLOP, {t['bytes'] / 1e6:.2f} MB)")
    return {"launches": launches[name], "prefill_ms": result["prefill_ms"],
            "ms_per_token": ms, "busy": busy, "bound_ms": bound_ms,
            "shape": {"shape": shape, "ms": t["ms"],
                      "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
                      "bound_by": t["bound_by"], "library_ms": None}}


# ---------------------------------------------------------------------------
# phases 33-35: zamba2-7b (68 Mamba-2 blocks prefilled through B8's
# inclusive route, one shared attention block at 13 sites, head dim 112
# through B1/B7/B10) and the paper's feature gate
# ---------------------------------------------------------------------------

ZAMBA_ARCH = "zamba2-7b"
# phases 34 and 35's depth: 2 of zamba2-7b's 13 units (PERF.md §4; PRs
# 32-34 served 7 units in phase 34 and the whole model in phase 35)
ZAMBA_SERVE_LAYERS = 12


def zamba2_unit(backend, dtype="float32"):
    """zamba2-7b at full width cut to one pattern unit (5 mamba + 1
    shared_attn, no tail: ``with_depth``), under ``backend``, computing
    in ``dtype``."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import with_depth
    cfg = get_config(ZAMBA_ARCH).with_backend(backend)
    return dataclasses.replace(with_depth(cfg, len(cfg.layer_pattern)),
                               dtype=dtype)


def ssd_rows(b, h, t, n, dtype, gen, dev):
    """The Mamba-2 prefill's B8 rows at zamba2-7b's widths: C and B one
    (T, N) row a sequence broadcast over the H heads (materialised as
    the wrapper materialises them), v = Δ·x, and the per-head log-decay
    g = −softplus(Δ)·linspace(1, 16, H) of its init broadcast to (T, N):
    most heads past the clamp at −1. Flat (B·H, T, N) rows."""
    import torch
    import torch.nn.functional as F
    r = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    cq, bk = (r(b, 1, t, n).expand(b, h, t, n).to(dtype) for _ in range(2))
    dt = F.softplus(r(b, h, t, 1))
    v = (r(b, h, t, n) * dt).to(dtype)
    g = (-dt * torch.linspace(1.0, 16.0, h, device=dev)[:, None, None]
         ).expand(b, h, t, n)
    return [x.reshape(b * h, t, n).contiguous() for x in (cq, bk, v, g)]


def check_ssd(b, h, t, dtype, gen, dev, n=64) -> float:
    """B8's inclusive route with its final state at the SSD prefill's
    shape, through ``ssd_attention`` (one launch for every head, q and k
    broadcast views) against the plain version at chunk 64: o normwise
    1e-5 (fp32) or 8e-3 (bf16), the fp32 state 1e-5. Prints o's error as
    a share of its limit. Returns max|Δo|."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    q, k, v, g = (x.reshape(b, h, t, n) for x in ssd_rows(b, h, t, n, dtype,
                                                          gen, dev))
    q, k = q[:, :1].expand(b, h, t, n), k[:, :1].expand(b, h, t, n)
    g = g[..., :1]
    before = GL.fwd.launches
    o, s = GL.ssd_attention(q, k, v, g, chunk=64)
    torch.cuda.synchronize()
    if GL.fwd.launches != before + 1:
        raise AssertionError("ssd_attention: not one B8 launch")
    o_r, s_r = GL.ssd_attention(q, k, v, g, chunk=64, kernel=False)
    name = str(dtype).split(".")[-1]
    tag = f"SSD rows={b * h} T={t} N={n} {name}"
    if not (torch.isfinite(o).all() and torch.isfinite(s).all()):
        raise AssertionError(f"{tag}: non-finite output")
    clamped = (g < -1.0).float().mean().item()
    err = normwise(o, o_r, LA_TOL[name], f"o {tag}")
    s_err = normwise(s, s_r, LA_TOL["float32"], f"state {tag}")
    share = err / (LA_TOL[name] * o_r.float().abs().max().item())
    print(f"  ssd_attention {tag} ({100 * clamped:.1f}% of the decays past "
          f"the clamp): max|Δo|={err:.3e}, {100 * share:.1f}% of the "
          f"{LA_TOL[name]} limit; max|ΔS|={s_err:.3e}")
    return err


def zamba2_kernel_checks(gen, dev) -> None:
    """Phase 2's checks at zamba2-7b's shapes: B1 and B7 at D = 112
    (448 threads) at the serving rows (batch 8 x 32 heads) and the smoke
    rows with the state bit for bit; B10 at D = 112 on both routes (32
    over 32 heads at T = S = 512, ragged T and S, groups of 6 and 7,
    through the wrapper); B8's inclusive route at the SSD prefill's shape
    (batch 8 x 112 heads, T = 512, N = 64) in fp32 and bf16."""
    import torch
    for dtype in (torch.float32, torch.bfloat16):
        for normalize in (False, True):
            for w, varlen in ((1, False), (8, True)):
                check_decode_linear(256, 112, w, normalize, varlen, gen, dev,
                                    dtype=dtype, bitwise=True)
        for w, varlen in ((1, False), (8, True)):
            for decay in ("mild", "strong", "scalar"):
                check_decode_gated(256, 112, w, dtype, varlen, decay, gen,
                                   dev, bitwise=True)
    for normalize in (False, True):
        check_decode_linear(12, 112, 8, normalize, True, gen, dev,
                            bitwise=True)
    check_decode_gated(12, 112, 8, torch.bfloat16, True, "mild", gen, dev,
                       bitwise=True)
    print("phase 2: decode_linear and decode_gated at D = 112: S and z bit "
          "for bit, o within 1e-5 fp32 and 1 bf16 ulp")
    for dtype in (torch.bfloat16, torch.float32):
        check_flash_attention(256, 512, 512, 112, dtype, gen, dev,
                              kv_heads=32, heads=32)
        check_flash_attention(14, 77, 300, 112, dtype, gen, dev, t_off=5,
                              s_real=290, kv_heads=1, heads=7)
        check_flash_attention(12, 200, 200, 112, dtype, gen, dev,
                              s_real=150, kv_heads=1, heads=6)
        check_flash_wrapper(2, 14, 2, 72, 200, dtype, gen, dev, d=112)
    print("phase 2: flash_attention_fwd at D = 112 agrees with its plain "
          "version and JAX's oracle")
    for dtype in (torch.float32, torch.bfloat16):
        check_ssd(8, 112, 512, dtype, gen, dev)
    check_ssd(2, 7, 200, torch.bfloat16, gen, dev)
    print("phase 2: gated_linear_attention_fwd (inclusive, with its state) "
          "at the SSD prefill's shape agrees with its plain version")


def time_ssd_prefill(b, h, t, n, gen, dev) -> dict:
    """B8's inclusive route at the SSD prefill's shape on its flat rows
    (bf16 q, k, v; fp32 g at zamba2-7b's decays), with its plain version
    at chunk 64, from CUDA-graph replays. Bounds as
    ``time_gated_linear_attention``'s: q, k, v read and o written in
    bf16, g read and the state written in fp32, over 3.35 TB/s; or the
    scan form's two products and one exp per decay element over the bf16
    tensor-core rate (``fp32_bound_ms``: over 67 TFLOP/s)."""
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.gated_linear_attention import ref as GR
    import torch
    q, k, v, g = ssd_rows(b, h, t, n, torch.bfloat16, gen, dev)
    ops, n_bytes = GL.fwd_work(q, k, v, g)
    return dict(ms=graph_ms(lambda i: GL.fwd(q, k, v, g, chunk=64), 4,
                            replays=5),
                plain_ms=graph_ms(lambda i: GR.chunked_fwd_ref(
                    q, k, v, g, chunk=64), 2, replays=3),
                library_ms=None,
                fp32_bound_ms=bound(n_bytes, ops)["bound_ms"],
                **bound(n_bytes, ops, PEAK_BF16_TC_FLOPS))


def zamba2_state_sizes(cfg, batch, rows) -> dict:
    """Bytes of zamba2-7b's decode state at ``batch``: each Mamba-2
    layer's conv window (K−1 rows of x | B | C in bf16) and SSD matrices
    (fp32), and each shared-attention site's linear s and z (fp32), its
    gated s, or its softmax K and V caches of ``rows`` rows (bf16)."""
    from repro_torch.launch import serve
    s = cfg.ssm
    counts = serve.layer_counts(cfg)
    d_inner = s.expand * cfg.d_model
    mamba = counts["mamba"] * batch * (
        (s.conv_kernel - 1) * (d_inner + 2 * s.d_state) * 2
        + d_inner // s.head_dim * s.d_state * s.head_dim * 4)
    head = counts["attn"] * batch * cfg.n_heads * cfg.head_dim * 4
    kv = counts["attn"] * batch * rows * 2 * cfg.n_kv_heads * cfg.head_dim * 2
    return {"mamba": mamba, "linear": head * (cfg.head_dim + 1),
            "gated_linear": head * cfg.head_dim, "softmax": kv}


def zamba2_generate_main_path(backend, dev, phase) -> dict:
    """Phase 34: ``serve --mode generate --arch zamba2-7b --backend
    <backend> --n-layers 12`` at full width (``ZAMBA_SERVE_LAYERS``: 2 of
    its 13 units, 10 Mamba-2 blocks and 2 sites of the shared attention,
    the tail dropped, to keep the whole run short, where the phase once
    ran all 81 layers and then 42; parameters built in bf16), batch 8,
    prompt 512, 64 tokens,
    every kernel's launch count set to 0 just before and read just after:
    B8 exactly once a Mamba-2 block and prefill (two prefills: the
    warm-up's and the timed one), and B1 or B7 exactly sites x (2 + 63)
    times or B10 sites times a prefill, no other kernel. Prints prefill ms,
    ms/token beside the step's bound by bytes, the decode state's MiB
    (the Mamba-2 states and the attention's, against the KV cache of the
    other route), peak memory and a profile of 4 decode steps (device
    busy share). Returns the launches and the numbers."""
    import gc
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.tree import leaves
    gc.collect()
    torch.cuda.empty_cache()
    held = torch.cuda.memory_allocated()
    args = serve.parse_args(["--arch", ZAMBA_ARCH, "--backend", backend,
                             "--n-layers", str(ZAMBA_SERVE_LAYERS),
                             "--batch", "8", "--prompt-len", "512",
                             "--gen-len", "64", "--seed", "0"])
    cfg = serve.serving_config(args)
    counts = serve.layer_counts(cfg)
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    result = serve.generate(args)
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated()
    got = {k: n for k, n in launches.items() if n}
    softmax = backend == "softmax"
    ssd = "gated_linear_attention_fwd"
    want = {ssd: 2 * counts["mamba"]}
    if softmax:
        want["flash_attention_fwd"] = 2 * counts["attn"]
        timed = (result["prefill_launches_by"] ==
                 {ssd: counts["mamba"], "flash_attention_fwd": counts["attn"]}
                 and not result["decode_launches"])
        name = "flash_attention_fwd"
    else:
        name = DECODE_KERNEL[backend]
        want[name] = counts["attn"] * (args.gen_len - 1 + 2)
        timed = (result["prefill_launches_by"] == {ssd: counts["mamba"]} and
                 result["decode_launches"] ==
                 counts["attn"] * (args.gen_len - 1))
    if got != want or not timed:
        raise AssertionError(f"phase {phase}: {ZAMBA_ARCH} {backend} "
                             f"launched {got} (want {want}), timed prefill "
                             f"{result['prefill_launches_by']}, decode "
                             f"{result['decode_launches']}")
    toks = result["tokens"]
    if toks.shape != (args.batch, args.gen_len) or not (
            (toks >= 0) & (toks < cfg.vocab_size)).all():
        raise AssertionError(f"phase {phase}: bad generated tokens")
    max_len = args.prompt_len + args.gen_len
    sizes = zamba2_state_sizes(cfg, args.batch, max_len)
    want_mib = (sizes["mamba"] + sizes[backend]) / 2**20
    if result["state_mib"] != want_mib:
        raise AssertionError(f"phase {phase}: decode state "
                             f"{result['state_mib']} MiB, want {want_mib}")
    ms = result["decode_ms_per_token"]
    print(f"phase {phase}: {ZAMBA_ARCH} {backend} main path ({cfg.n_layers} "
          f"layers: {counts['mamba']} Mamba-2, {counts['attn']} shared "
          f"attention sites of {cfg.n_heads} heads of {cfg.head_dim}; "
          f"bf16) batch {args.batch}, prompt {args.prompt_len}, "
          f"{args.gen_len} tokens: prefill_ms={result['prefill_ms']:.3f} "
          f"decode_ms_per_token={ms:.4f} tok_s={result['tokens_per_s']:.1f}"
          f" state_mib={result['state_mib']:.2f} (Mamba-2 "
          f"{sizes['mamba'] / 2**20:.2f}, attention "
          f"{sizes[backend] / 2**20:.2f}; the linear attention state "
          f"{sizes['linear'] / 2**20:.2f} MiB against a KV cache of "
          f"{max_len} rows {sizes['softmax'] / 2**20:.2f} MiB, "
          f"{sizes['softmax'] / args.batch / 2**20:.2f} a sequence); "
          f"launches {got} (timed prefill {result['prefill_launches_by']}"
          + ("" if softmax else f", timed decode "
             f"{result['decode_launches']} = {counts['attn']} x "
             f"{args.gen_len - 1}") + f"); held before {held / 1e9:.3f} GB, "
          f"peak {peak / 1e9:.3f} GB")
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_params = sum(t.numel() for t in leaves(params))
    prompt = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                           device=dev,
                           generator=torch.Generator(device=dev).manual_seed(3))
    logits, st = lm.prefill(params, prompt, cfg)
    st = lm.pad_decode_state(st, cfg, max_len)
    # weights (the embedding at the batch's rows), the fixed-size states
    # read and written, a KV cache read once
    embed = params["embed"]
    n_bytes = (sum(t.nbytes for t in leaves(params)) - embed.nbytes
               + args.batch * embed.shape[1] * embed.element_size()
               + 2 * sizes["mamba"] + (sizes["softmax"] if softmax else
                                       2 * sizes[backend]))
    bound_ms = n_bytes / PEAK_BYTES_PER_S * 1e3
    print(f"  {n_params / 1e9:.3f} B parameters, "
          f"{sum(t.nbytes for t in leaves(params)) / 1e9:.3f} GB in bf16; "
          f"bound {bound_ms:.3f} ms a decode step by bytes ("
          f"{n_bytes / 1e9:.3f} GB of weights and state at "
          f"{PEAK_BYTES_PER_S / 1e12:.2f} TB/s): {100 * bound_ms / ms:.1f}% "
          f"of the measured ms/token")
    device_ms = profile_decode(params, cfg, st, torch.argmax(logits, -1),
                               args.prompt_len,
                               kernel=None if softmax else f"{name}_kernel")
    if not torch.isfinite(logits).all():
        raise AssertionError(f"phase {phase}: non-finite logits")
    busy = None
    if device_ms is not None:
        busy = device_ms / ms
        print(f"  device busy {100 * busy:.1f}% of a decode step "
              f"({device_ms:.3f} ms device time per step over {ms:.3f} ms "
              f"per token)")
    del params, st, logits, prompt
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": got, "prefill_ms": result["prefill_ms"],
            "ms_per_token": ms, "bound_ms": bound_ms, "busy": busy,
            "peak": peak, "state_mib": result["state_mib"]}


def zamba2_kernel_times(gen, dev) -> dict:
    """B1, B7 and B10 at zamba2-7b's shared attention (batch 8 x 32 heads,
    D = 112; B10 over T = S = 512 beside
    ``scaled_dot_product_attention``), and B8's inclusive route at its
    SSD prefill (batch 8 x 112 heads, T = 512, N = 64), each beside its
    bound and plain version. Returns {kernel: record}."""
    out = dense_kernel_times(ZAMBA_ARCH, ("linear", "gated_linear",
                                          "softmax"), gen, dev)
    t = time_ssd_prefill(8, 112, 512, 64, gen, dev)
    shape = f"{ZAMBA_ARCH} SSD prefill: rows=896 T=512 N=64 bf16, chunk 64"
    print(f"gated_linear_attention_fwd [decay_sweep_fwd_tc<64, false>] "
          f"{shape}: {t['ms'] * 1e3:.2f} us/launch (plain version "
          f"{t['plain_ms'] * 1e3:.2f} us; library call: none; bound "
          f"{t['bound_ms'] * 1e3:.2f} us by {t['bound_by']} on bf16 tensor "
          f"cores, {t['fp32_bound_ms'] * 1e3:.2f} us at the fp32 rate; "
          f"{t['flops'] / 1e9:.2f} GFLOP, {t['bytes'] / 1e6:.2f} MB)")
    out["gated_linear_attention_fwd"] = {
        "shape": shape, "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
        "library_ms": None}
    return out


def zamba2_stream_main_path(dev, phase) -> dict:
    """Phase 35: ``serve --mode stream --arch zamba2-7b --backend linear``
    at phase 16's traffic (8 slots, segments of 8, 32 requests of 512
    prompt tokens and 8 or 64 generated tokens, 0.25 arrivals a step),
    every kernel's launch count set to 0 just before and read just after:
    per-request admission (each prompt whole: B8 once per Mamba-2 layer
    and prefill, no ingest chunk), B1 once per attention site and decode
    step of every segment, no other kernel; every request its budget;
    then a profile of two steps of a segment. Returns the launches."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    args = serve.parse_args([
        "--mode", "stream", "--arch", ZAMBA_ARCH, "--backend", "linear",
        "--n-layers", str(ZAMBA_SERVE_LAYERS),
        "--slots", "8", "--segment-len", "8", "--n-requests", "32",
        "--prompt-len", "512", "--gen-len", "64", "--arrival-rate", "0.25",
        "--seed", "0"])
    t0 = time.perf_counter()
    reset_launches()
    result = serve.stream(args)
    torch.cuda.synchronize()
    launches = read_launches()
    print(f"  serve --mode stream returned in {time.perf_counter() - t0:.1f}"
          f" s (weights, warm-up and the timed run)")
    st = result["stats"]
    ssd = "gated_linear_attention_fwd"
    want = {"decode_linear": result["want_launches"]
            + result["warmup_launches"],
            ssd: result["want_ssd_launches"] + result["warmup_ssd_launches"]}
    got = {k: n for k, n in launches.items() if n}
    if got != want or result["decode_launches"] != result["want_launches"] \
            or result["ssd_launches"] != result["want_ssd_launches"]:
        raise AssertionError(f"phase {phase}: launched {got} (want {want}), "
                             f"timed B1 {result['decode_launches']} / "
                             f"{result['want_launches']}, B8 "
                             f"{result['ssd_launches']} / "
                             f"{result['want_ssd_launches']}")
    if result["engine"].admission != "per_request" or st["ingest_chunks"] \
            or st["prefills"] != args.n_requests or not st["segments"]:
        raise AssertionError(f"phase {phase}: per-request admission of every "
                             f"prompt whole, no ingest: {st}")
    cfg = serve.serving_config(args)
    mix = serve.make_request_mix(np.random.default_rng(args.seed),
                                 args.n_requests, args.prompt_len,
                                 args.gen_len, cfg.vocab_size,
                                 args.arrival_rate)
    comps = result["completions"]
    if [len(c.tokens) for c in comps] != [g for _, g, _ in mix] or not all(
            ((c.tokens >= 0) & (c.tokens < cfg.vocab_size)).all()
            for c in comps):
        raise AssertionError(f"phase {phase}: incomplete or bad completions")
    counts = serve.layer_counts(cfg)
    print(f"phase {phase}: {ZAMBA_ARCH} linear stream main path "
          f"tok_s={result['tokens_per_s']:.1f} "
          f"ms_per_segment={result['ms_per_segment']:.3f} "
          f"slot_utilization={result['slot_utilization']:.4f} "
          f"mean_latency_steps={result['mean_latency_steps']:.2f} "
          f"seconds={result['seconds']:.3f} tokens={result['tokens']} "
          f"launches {got} (timed decode_linear {result['decode_launches']} "
          f"= {counts['attn']} x {st['segment_len']} x {st['segments']}, "
          f"{ssd} {result['ssd_launches']} = {counts['mamba']} x "
          f"{st['prefills']} prefills); decode state "
          f"{result['state_mib']:.1f} MiB; all {len(comps)} requests "
          f"complete")
    print(f"  stats {json.dumps(st)}")
    prof = profile_segments(result["engine"])
    engine = result.pop("engine")
    if not all(bool(torch.isfinite(t).all()) for group in engine.state.values()
               for layer in group for t in layer if t is not None):
        raise AssertionError(f"phase {phase}: non-finite engine state")
    if prof["busy"] is not None:
        print(f"  device busy {100 * prof['busy']:.1f}% of a segment "
              f"({prof['device_ms']:.3f} ms device time over "
              f"{prof['wall_ms']:.3f} ms wall per segment)")
    del engine, result
    torch.cuda.empty_cache()
    return got


# ---------------------------------------------------------------------------
# phases 36-38: zamba2-7b (its shared attention through B2/B3, B8/B9 at
# head dim 112 or B10, its Mamba-2 blocks through B8/B9) and rwkv6-1.6b
# (B8's exclusive route and the exclusive backward) trained on the card
# ---------------------------------------------------------------------------

def check_exclusive_backward(b, h, t, d, dtype, gen, dev, chunk=64,
                             autograd=False, shared_u=False) -> dict:
    """The exclusive form's backward (RWKV-6's training; no Pallas
    original) on flat rows, u drawn at random one row per head and the
    log-decay in RWKV-6's range: ``ops.bwd_exclusive`` (its two launches)
    against ``ref.chunked_bwd_exclusive_ref`` (dq, dk, dv, dg, du), each
    launch alone against ``ref.bwd_exclusive_dq_ref`` (dq, q⊙dq, du per
    row) and ``ref.bwd_exclusive_dkv_ref`` given the same q⊙dq (dk, dv;
    dg in fp32 only: in bf16 that q⊙dq carries the rounding of Q̂ which
    only the same launch pair's k⊙dk cancels, as ``check_gla_rows``
    says), normwise 1e-5 (fp32) or 8e-3 (bf16). With ``autograd``, also
    ``rwkv6_attention`` under autograd (B8's exclusive route, then the
    backward) against torch autograd of the plain exclusive forward on
    (B, H, T, D), du included. ``shared_u``: one u, (D,), for every row.
    Returns max|Δ| per launch."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.gated_linear_attention import ref as GR
    q, k, v, g, u = rwkv_rows(b, h, t, d, dtype, gen, dev)
    if shared_u:
        u = u[0].contiguous()
    do = torch.randn(q.shape, generator=gen, device=dev).to(dtype)
    rows = [x.reshape(b * h, t, d).contiguous() for x in (q, k, v, g, do)]
    n0 = (GL.bwd_exclusive_dq.launches, GL.bwd_exclusive_dkv.launches)
    got = GL.bwd_exclusive(*rows, u, chunk=chunk)
    dq1, qdq1, du1 = GL.bwd_exclusive_dq(*rows, u, chunk=chunk)
    dkv1 = GL.bwd_exclusive_dkv(*rows, u, qdq1, chunk=chunk)
    torch.cuda.synchronize()
    n1 = (GL.bwd_exclusive_dq.launches, GL.bwd_exclusive_dkv.launches)
    if (n1[0] - n0[0], n1[1] - n0[1]) != (2, 2):
        raise AssertionError(f"bwd_exclusive: launches {n0} -> {n1}")
    want = GR.chunked_bwd_exclusive_ref(*rows, u, chunk=chunk)
    want1 = GR.bwd_exclusive_dq_ref(*rows, u, chunk=chunk)
    want2 = GR.bwd_exclusive_dkv_ref(*rows, u, qdq1, chunk=chunk)
    name = str(dtype).split(".")[-1]
    tol = LA_TOL[name]
    tag = (f"B={b} H={h} T={t} D={d} {name} chunk={chunk}"
           + (" u shared" if shared_u else ""))
    names = ("dq", "dk", "dv", "dg", "du")
    for n, x, x_r in zip(names, got, want):
        if x.dtype != x_r.dtype or x.shape != x_r.shape or \
                not torch.isfinite(x).all():
            raise AssertionError(f"exclusive bwd {n} {tag}: {x.dtype} "
                                 f"{tuple(x.shape)}, want {x_r.dtype} "
                                 f"{tuple(x_r.shape)}, finite")
    e = {n: normwise(x, x_r, tol, f"exclusive bwd {n} {tag}")
         for n, x, x_r in zip(names, got, want)}
    e1 = {n: normwise(x, x_r, tol, f"exclusive dq launch {n} {tag}")
          for n, x, x_r in zip(("dq", "q⊙dq", "du_rows"), (dq1, qdq1, du1),
                               want1)}
    n2 = ("dk", "dv", "dg") if dtype == torch.float32 else ("dk", "dv")
    e2 = {n: normwise(x, x_r, tol, f"exclusive dk/dv launch {n} {tag}")
          for n, x, x_r in zip(n2, dkv1, want2)}
    line = (f"  exclusive backward {tag}: max|Δ| " + ", ".join(
        f"{n} {x:.3e}" for n, x in e.items()) + "; dq launch " + ", ".join(
        f"{n} {x:.3e}" for n, x in e1.items()) + "; dk/dv launch "
        + ", ".join(f"{n} {x:.3e}" for n, x in e2.items())
        + f" (normwise {tol})")
    if autograd:
        grads = {}
        for kernel in (True, False):
            leaves = [x.clone().requires_grad_() for x in (q, k, v, g, u)]
            if kernel:
                o, _ = GL.rwkv6_attention(*leaves, chunk=chunk)
            else:
                c, rws = GL._flat_inputs(*leaves[:4], chunk)
                o, _ = GR.chunked_fwd_ref(*rws, u=leaves[4], chunk=c,
                                          exclusive=True)
                o = o[:, :t].reshape(q.shape)
            o.backward(do)
            grads[kernel] = [x.grad for x in leaves]
        torch.cuda.synchronize()
        ea = [normwise(a, b_, tol, f"exclusive autograd {n} {tag}")
              for n, a, b_ in zip(names, grads[True], grads[False])]
        line += ("; rwkv6_attention under autograd against autograd of the "
                 "plain exclusive forward: " + ", ".join(
                     f"{n} {x:.3e}" for n, x in zip(names, ea)))
    print(line)
    return {"gated_linear_attention_bwd_exclusive_dq": max(
                e["dq"], e["du"], *e1.values()),
            "gated_linear_attention_bwd_exclusive_dkv": max(
                e["dk"], e["dv"], e["dg"], *e2.values())}


def check_exclusive_margin(gen, dev) -> None:
    """B8's exclusive bf16 o (ROADMAP §C item 12's margin) at rwkv6-1.6b's
    training length, batch 8 x 32 heads, T = 1,024, D = 64, u per head,
    with every decay at the clamp (g = −1) and near it (−0.9 to −1.1,
    half past the clamp), against its plain version at chunk 64: o's
    error printed as a share of the 8e-3 normwise limit, which fails the
    phase if crossed."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    for kind in ("clamp", "near"):
        q, k, v, g, u = rwkv_rows(8, 32, 1024, 64, torch.bfloat16, gen, dev)
        g = (torch.full_like(g, -1.0) if kind == "clamp" else
             -(0.9 + 0.2 * torch.rand(g.shape, generator=gen, device=dev)))
        o, _ = GL.rwkv6_attention(q, k, v, g, u, chunk=64)
        o_r, _ = GL.rwkv6_attention(q, k, v, g, u, chunk=64, kernel=False)
        torch.cuda.synchronize()
        tol = LA_TOL["bfloat16"]
        err = normwise(o, o_r, tol, f"exclusive o margin {kind}")
        share = err / (tol * o_r.float().abs().max().item())
        print(f"  B8 exclusive bf16 o at T=1024 (8 x 32 heads, D=64, u per "
              f"head), decays {'at the clamp' if kind == 'clamp' else 'near the clamp (-0.9 to -1.1)'}: "
              f"max|Δo| {err:.3e}, {100 * share:.1f}% of the {tol} limit")


def training_kernel_checks_112_and_exclusive(gen, dev) -> dict:
    """Phase 2's checks of this slice's training kernels: B2/B3 and B8/B9
    at zamba2-7b's head dim 112 (``training_kernel_checks_at``: the
    training rows, ragged T, the wrappers, the clamp and each route's
    limit); the exclusive backward at rwkv6-1.6b's training shape (batch
    8 x 32 heads, T = 1,024, D = 64) in fp32 and bf16 with the autograd
    function against autograd of the plain forward, and at ragged T and
    every head dim it takes; B8's exclusive o near the clamp at
    T = 1,024. Returns the exclusive backward's max|Δ| at the training
    shape in bf16 (the main path's)."""
    import torch
    training_kernel_checks_at(112, gen, dev)
    print(f"phase 2: linear_attention_fwd, _bwd_dq, _bwd_dkv and "
          f"gated_linear_attention_fwd (inclusive, exclusive + u), _bwd_dq, "
          f"_bwd_dkv at D = 112 agree with their plain versions (normwise "
          f"{LA_TOL}) and, at the clamp and at each route's limit, with "
          f"gla_scan")
    errs = check_exclusive_backward(8, 32, 1024, 64, torch.bfloat16, gen,
                                    dev, autograd=True)
    check_exclusive_backward(8, 32, 1024, 64, torch.float32, gen, dev,
                             autograd=True)
    for b, h, t, d, chunk in ((2, 3, 200, 64, 40), (2, 3, 48, 16, 16),
                              (2, 3, 75, 96, 75), (2, 2, 130, 112, 65),
                              (1, 4, 128, 128, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            check_exclusive_backward(b, h, t, d, dtype, gen, dev,
                                     chunk=chunk)
    # at D <= 64 a block takes two rows: 1, 3 and 255 rows leave the last
    # block one; u per head and one u for every row
    for b, h, shared_u in ((1, 1, False), (1, 3, False), (15, 17, False),
                           (1, 3, True), (15, 17, True)):
        check_exclusive_backward(b, h, 1024, 64, torch.bfloat16, gen, dev,
                                 shared_u=shared_u)
    for b, h, t, d, chunk in ((1, 3, 200, 64, 40), (3, 1, 75, 16, 75)):
        check_exclusive_backward(b, h, t, d, torch.bfloat16, gen, dev,
                                 chunk=chunk)
    check_exclusive_margin(gen, dev)
    print("phase 2: the exclusive backward (gated_linear_attention_bwd_"
          "exclusive_dq, _dkv) agrees with its plain version, each launch "
          "alone and under autograd with autograd of the plain exclusive "
          "forward, du included")
    return errs


def time_exclusive_backward(b, h, t, d, gen, dev) -> dict:
    """The exclusive backward at RWKV-6's training shape (bf16 q, k, v,
    do; fp32 g and u of one row per head), chunk 64: each launch, the
    whole (``ops.bwd_exclusive``: both launches and the sum of du over
    each head's rows), and their plain versions, from CUDA-graph replays.
    Bounds as ``time_gated_linear_attention``'s B9: each input read once
    and each output written once (q, k, v, do read and dq, dk, dv written
    in bf16; g read and dg written in fp32; u and du beside), over 3.35
    TB/s; or the scan form's five products (2·T·D² per row each) and one
    exp per decay element over the bf16 tensor-core rate."""
    import torch
    from repro_torch.kernels.gated_linear_attention import ops as GL
    from repro_torch.kernels.gated_linear_attention import ref as GR
    q, k, v, g, u = rwkv_rows(b, h, t, d, torch.bfloat16, gen, dev)
    do = torch.randn(q.shape, generator=gen, device=dev).bfloat16()
    q, k, v, g, do = (x.reshape(b * h, t, d).contiguous()
                      for x in (q, k, v, g, do))
    _, qdq, _ = GL.bwd_exclusive_dq(q, k, v, g, do, u, chunk=64)
    out = {}
    for name, kern, plain, (ops, n_bytes) in (
            ("gated_linear_attention_bwd_exclusive_dq",
             lambda i: GL.bwd_exclusive_dq(q, k, v, g, do, u, chunk=64),
             lambda i: GR.bwd_exclusive_dq_ref(q, k, v, g, do, u, chunk=64),
             GL.bwd_exclusive_dq_work(q, k, v, g, do, u)),
            ("gated_linear_attention_bwd_exclusive_dkv",
             lambda i: GL.bwd_exclusive_dkv(q, k, v, g, do, u, qdq,
                                            chunk=64),
             lambda i: GR.bwd_exclusive_dkv_ref(q, k, v, g, do, u, qdq,
                                                chunk=64),
             GL.bwd_exclusive_dkv_work(q, k, v, g, do, u)),
            ("bwd_exclusive",
             lambda i: GL.bwd_exclusive(q, k, v, g, do, u, chunk=64),
             lambda i: GR.chunked_bwd_exclusive_ref(q, k, v, g, do, u,
                                                    chunk=64),
             GL.bwd_exclusive_work(q, k, v, g, do, u))):
        out[name] = dict(ms=graph_ms(kern, 4, replays=5),
                         plain_ms=graph_ms(plain, 2, replays=3),
                         library_ms=None,
                         fp32_bound_ms=bound(n_bytes, ops)["bound_ms"],
                         **bound(n_bytes, ops, PEAK_BF16_TC_FLOPS))
    return out


def zamba2_rwkv6_training_kernel_times(gen, dev) -> tuple:
    """Phases 37 and 38's kernels at the training shapes, each beside its
    bound and plain version: B2, B3 and B8, B9 at zamba2-7b's shared
    attention (batch 8 x 32 heads, T = 1,024, D = 112, chunk 128), the
    exclusive backward and B8's exclusive route at rwkv6-1.6b's (batch 8
    x 32 heads, T = 1,024, D = 64, chunk 64). Returns ({kernel: shape
    record} for the earlier kernels, {kernel: timing} for the exclusive
    backward's two launches)."""
    shapes = {}
    for timer, names in ((time_linear_attention, TRAIN_KERNELS["linear"][0]),
                         (time_gated_linear_attention,
                          TRAIN_KERNELS["gated_linear"][0])):
        t = timer(256, 1024, 112, 128, gen, dev)
        for name in names:
            r = t[name]
            shape = f"{ZAMBA_ARCH} training: rows=256 T=1024 D=112 bf16"
            print(f"{name} {shape}: {r['ms'] * 1e3:.2f} us/launch (plain "
                  f"version {r['plain_ms'] * 1e3:.2f} us; library call: "
                  f"none; bound {r['bound_ms'] * 1e3:.2f} us by "
                  f"{r['bound_by']} on bf16 tensor cores, "
                  f"{r['fp32_bound_ms'] * 1e3:.2f} us at the fp32 rate; "
                  f"{r['flops'] / 1e9:.2f} GFLOP, {r['bytes'] / 1e6:.2f} MB; "
                  f"{r['ms'] / r['bound_ms']:.2f}x its bound)")
            shapes[name] = {"shape": shape, "ms": r["ms"],
                            "plain_ms": r["plain_ms"],
                            "bound_ms": r["bound_ms"],
                            "bound_by": r["bound_by"], "library_ms": None}
        r = t["bwd"]
        print(f"  {'B3' if names[0].startswith('linear') else 'B9'} as a "
              f"whole (ops.bwd) at D=112: {r['ms'] * 1e3:.2f} us against "
              f"{r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} "
              f"({r['bytes'] / 1e6:.2f} MB); plain version "
              f"{r['plain_ms'] * 1e3:.2f} us")
    t = time_rwkv6_prefill(8, 32, 1024, 64, gen, dev)
    shape = f"{RWKV_ARCH} training: exclusive + u per head, rows=256 T=1024 D=64 bf16"
    print(f"gated_linear_attention_fwd [decay_sweep_fwd_tc<64, true>] "
          f"{shape}: {t['ms'] * 1e3:.2f} us/launch (plain version "
          f"{t['plain_ms'] * 1e3:.2f} us; bound {t['bound_ms'] * 1e3:.2f} "
          f"us by {t['bound_by']}; {t['bytes'] / 1e6:.2f} MB)")
    fwd_shape = {"shape": shape, "ms": t["ms"], "plain_ms": t["plain_ms"],
                 "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                 "library_ms": None}
    # B8 and B9 (inclusive) at the same rows, T and D: musicgen-large's
    # training shape (chunk 128), and the exclusive backward's yardstick
    b9 = time_gated_linear_attention(256, 1024, 64, 128, gen, dev)
    for name in ("gated_linear_attention_fwd", "gated_linear_attention_bwd_dq",
                 "gated_linear_attention_bwd_dkv", "bwd"):
        r = b9[name]
        print(f"{name} musicgen-large training: rows=256 T=1024 D=64 bf16: "
              f"{r['ms'] * 1e3:.2f} us (bound {r['bound_ms'] * 1e3:.2f} us "
              f"by {r['bound_by']}; plain version {r['plain_ms'] * 1e3:.2f} "
              f"us)")
    t = time_exclusive_backward(8, 32, 1024, 64, gen, dev)
    same = dict(zip(t, ("gated_linear_attention_bwd_dq",
                        "gated_linear_attention_bwd_dkv", "bwd")))
    for name, r in t.items():
        print(f"{name} {RWKV_ARCH} training: rows=256 T=1024 D=64 bf16, "
              f"chunk 64: {r['ms'] * 1e3:.2f} us (B9's {same[name]} at the "
              f"same shape {b9[same[name]]['ms'] * 1e3:.2f} us; plain "
              f"version {r['plain_ms'] * 1e3:.2f} us; library call: none; "
              f"bound {r['bound_ms'] * 1e3:.2f} us by {r['bound_by']} on "
              f"bf16 tensor cores, {r['fp32_bound_ms'] * 1e3:.2f} us at the "
              f"fp32 rate; {r['flops'] / 1e9:.2f} GFLOP, "
              f"{r['bytes'] / 1e6:.2f} MB; {r['ms'] / r['bound_ms']:.2f}x "
              f"its bound)")
    return shapes, fwd_shape, t


# -- phases 39 and 40: the paper's QA, checkpointed training --------------

QA_VARIANTS = ("none", "linear", "gated_linear", "softmax", "second_order")
# Figure 1's sweep cut from 400 steps for the run's time (the four
# variants and second_order take 0.57 s a step together on an H100; the
# curves are the same bits run after run, and at step 80 every variant's
# validation loss is below its first: PR 34's run at 120 steps)
QA_STEPS = 80
# the paper's document length (§5: n ≈ 750): 187 facts of 4 tokens
QA_PAPER_FACTS = 187
QA_LOSS_RTOL = 1e-5
QA_LEAF_TOL = 1e-4


def leaf_err(x, want) -> float:
    """max|x − want| / max|want| of two tensors (``normwise``'s measure),
    on the CPU."""
    x, want = x.detach().cpu().float(), want.detach().cpu().float()
    return ((x - want).abs().max() / want.abs().max().clamp_min(1e-30)
            ).item()


def event_ms(fn, reps=50) -> float:
    """Device ms of one call of ``fn`` (CUDA events around ``reps`` calls
    after a warm-up)."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def qa_parity(dev, phase) -> None:
    """Phase 39 (a): one Adam step of each variant at the paper's widths
    (k = 100, embeddings 100, batch 64, 120-token documents, fp32) on the
    card and on the CPU from the same parameters (drawn on the CPU from
    seed 0, copied to the card) and batch: the loss within rtol 1e-5,
    every gradient leaf and every parameter after the step within
    normwise 1e-4 (max|Δ| ≤ 1e-4 · max|CPU's|), the parameters where the
    gradient is above 1e-4 of its leaf's largest: Adam's first step
    moves an element by ±lr whatever its gradient's size, except near
    eps, where a rounding difference moves it anywhere between."""
    import torch
    from repro_torch.configs.paper_qa import QAConfig
    from repro_torch.data import ClozeTask
    from repro_torch.optim import adam
    from repro_torch.qa import QAModel
    from repro_torch.qa.train import make_step, put_batch
    from repro_torch.tree import leaves, tree_map
    cpu = torch.device("cpu")
    batch = ClozeTask(seed=1).batch(QAConfig().batch_size, step=0)
    for att in QA_VARIANTS:
        cfg = QAConfig(attention=att)
        model = QAModel(cfg)
        p_cpu = model.init(torch.Generator().manual_seed(0))
        p_dev = tree_map(lambda x: x.to(dev, copy=True), p_cpu)
        out = {}
        for name, params, where in (("cpu", p_cpu, cpu), ("card", p_dev,
                                                           dev)):
            opt = adam(cfg.lr)
            t0 = time.perf_counter()
            out[name] = make_step(model, opt)(params, opt.init(params),
                                              put_batch(batch, where))
            out[name][2].item()
            out[name + "_s"] = time.perf_counter() - t0
        loss, want = out["card"][2].item(), out["cpu"][2].item()
        loss_err = abs(loss - want) / abs(want)
        errs, n_small, n_moved = {"grad": 0.0, "param": 0.0}, 0, 0
        for p_k, p_c, g_k, g_c in zip(*(leaves(out[w][i]) for i in (0, 3)
                                        for w in ("card", "cpu"))):
            errs["grad"] = max(errs["grad"], leaf_err(g_k, g_c))
            # Adam's first step is lr·g/(|g| + eps): ±lr wherever |g| is
            # well above eps, anywhere between where it is not, so the
            # parameters are held where |g| > 1e-4·max|g| (phase 9's rule)
            g_c, p_k, p_c = (x.detach().cpu() for x in (g_c, p_k, p_c))
            big = g_c.abs() > 1e-4 * g_c.abs().max()
            if big.any():
                errs["param"] = max(errs["param"], leaf_err(p_k[big],
                                                            p_c[big]))
            n_small += int((~big).sum())
            n_moved += int(((p_k - p_c).abs()[~big] > 1e-6).sum())
        print(f"phase {phase}: QA {att} (k={cfg.hidden}, embed "
              f"{cfg.embed_dim}, batch {cfg.batch_size} x 120 tokens, fp32) "
              f"one Adam step card vs CPU: loss {loss:.6f} vs {want:.6f} "
              f"(rel {loss_err:.2e}, limit {QA_LOSS_RTOL:g}); worst leaf "
              f"normwise: gradients {errs['grad']:.2e}, parameters after "
              f"the step {errs['param']:.2e} where |g| > 1e-4 max|g| (limit "
              f"{QA_LEAF_TOL:g}; {len(leaves(p_cpu))} leaves; {n_moved} of "
              f"{n_small} elements below it moved apart by more than 1e-6)"
              f"; first step {out['card_s']:.3f} s on the card, "
              f"{out['cpu_s']:.3f} s on the CPU")
        if not loss_err <= QA_LOSS_RTOL or not max(errs.values()) <= \
                QA_LEAF_TOL:
            raise AssertionError(f"phase {phase}: QA {att} card vs CPU: loss "
                                 f"{loss_err:.2e}, leaves {errs}")
    torch.cuda.empty_cache()


def qa_figure1(dev, phase) -> dict:
    """Phase 39 (b): ``run_figure1`` and ``train_qa("second_order")`` at
    their defaults (``ClozeTask(seed=1)``, 120-token documents, seed 0)
    cut to ``QA_STEPS`` steps: each variant's validation curve, best
    accuracy and ms a step (the host clock around ``train_qa`` over its
    steps, its evaluations on the 256 held-out documents included).
    Fails on a non-finite validation loss, or a last one not below the
    first."""
    import math
    import torch
    from repro_torch.qa import train as QT
    print(f"phase {phase}: Figure 1 sweep cut from 400 to {QA_STEPS} steps "
          f"(the run's time), evaluations every 40 steps and after the "
          f"first")
    seconds, train_qa = {}, QT.train_qa

    def timed(att, **kw):         # run_figure1 calls the module's train_qa
        t0 = time.perf_counter()
        r = train_qa(att, **kw)   # ends in .item(): the card has finished
        seconds[att] = time.perf_counter() - t0
        return r

    QT.train_qa = timed
    try:
        res = QT.run_figure1(steps=QA_STEPS, device=dev)
        res["second_order"] = QT.train_qa("second_order", steps=QA_STEPS,
                                          device=dev)
    finally:
        QT.train_qa = train_qa
    out = {}
    for att, r in res.items():
        ms = seconds[att] / QA_STEPS * 1e3
        out[att] = {"steps": r.steps, "val_acc": r.val_acc,
                    "val_loss": r.val_loss, "best_acc": r.best_acc,
                    "ms_per_step": ms}
        print(f"  {att}: val_acc {[round(a, 4) for a in r.val_acc]} "
              f"val_loss {[round(x, 4) for x in r.val_loss]} at steps "
              f"{r.steps}; best {r.best_acc:.4f}; {ms:.2f} ms/step "
              f"({seconds[att]:.1f} s, the {len(r.steps)} evaluations "
              f"included)")
    bad = {att: r.val_loss for att, r in res.items()
           if not all(math.isfinite(x) for x in r.val_loss)
           or not r.val_loss[-1] < r.val_loss[0]}
    if bad:
        raise AssertionError(f"phase {phase}: validation losses not finite "
                             f"or the last not below the first: {bad}")
    torch.cuda.empty_cache()
    return out


def qa_paper_length(dev, phase) -> dict:
    """Phase 39 (c): the paper's document length, n = 748 (187 facts), k =
    100, batch 64, fp32, linear and softmax: ms a training step (host
    clock, synchronised, mean of 3 after a warm-up), encode ms for the
    batch's 64 documents (``encode_doc`` without gradients), lookup ms
    for a wave of 64 documents x 4 queries (CUDA events over 50 calls:
    ``lookup`` C q against ``softmax_lookup`` Hᵀ softmax(Hq)), and the
    bytes a document's representation holds: k²·4 against n·k·4."""
    import torch
    from repro_torch.configs.paper_qa import PAPER_M, QAConfig
    from repro_torch.core.linear_attention import lookup
    from repro_torch.core.softmax_attention import softmax_lookup
    from repro_torch.data import ClozeTask
    from repro_torch.optim import adam
    from repro_torch.qa import QAModel
    from repro_torch.qa.train import make_step, put_batch
    task = ClozeTask(n_facts=QA_PAPER_FACTS, seed=1)
    n = task.doc_len
    out = {}
    for att in ("linear", "softmax"):
        cfg = QAConfig(attention=att)
        b, k = cfg.batch_size, cfg.hidden
        model = QAModel(cfg)
        params = model.init(torch.Generator(device=dev).manual_seed(0))
        opt = adam(cfg.lr)
        state, step = opt.init(params), make_step(model, opt)
        times = []
        for i in range(4):
            batch = put_batch(task.batch(b, step=i), dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            params, state, loss, _ = step(params, state, batch)
            loss.item()
            times.append(time.perf_counter() - t0)
        step_ms = sum(times[1:]) / 3 * 1e3
        with torch.no_grad():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rep, _ = model.encode_doc(params, batch.doc)
            torch.cuda.synchronize()
            encode_ms = (time.perf_counter() - t0) * 1e3
            q = torch.randn((b, PAPER_M, k), device=dev,
                            generator=torch.Generator(device=dev)
                            .manual_seed(2))
            fn = (lambda: lookup(rep, q)) if att == "linear" else (
                lambda: softmax_lookup(rep, q))
            lookup_ms = event_ms(fn)
        per_doc = rep[0].numel() * rep.element_size()
        want = k * k * 4 if att == "linear" else n * k * 4
        if per_doc != want or not torch.isfinite(loss):
            raise AssertionError(f"phase {phase}: {att} at n={n}: "
                                 f"{per_doc} bytes a document (want {want})"
                                 f", loss {loss.item()}")
        out[att] = {"step_ms": step_ms, "encode_ms": encode_ms,
                    "lookup_ms": lookup_ms, "bytes": per_doc}
        print(f"phase {phase}: QA {att} at the paper's n={n} (k={k}, batch "
              f"{b}, fp32): {step_ms:.2f} ms a training step (step times "
              f"ms {[round(t * 1e3, 2) for t in times]}); encode "
              f"{encode_ms:.2f} ms for {b} documents; lookup "
              f"{lookup_ms * 1e3:.2f} us for a wave of {b} x {PAPER_M} "
              f"queries (CUDA events, 50 calls); {per_doc:,} bytes a "
              f"document ({'C: k*k*4' if att == 'linear' else 'H: n*k*4'})"
              f"; loss {loss.item():.4f}")
        del params, state, rep
        torch.cuda.empty_cache()
    return out


# phase 40: qwen3-0.6b under linear at full width, cut in depth
CKPT_LAYERS = 4
CKPT_STEPS, CKPT_EVERY, CKPT_FAIL, CKPT_PREEMPT = 12, 4, 8, 3


def ckpt_args(directory, *extra):
    from repro_torch.launch import train
    return train.parse_args([
        "--arch", "qwen3-0.6b", "--backend", "linear", "--n-layers",
        str(CKPT_LAYERS), "--batch", "8", "--seq-len", "1024", "--steps",
        str(CKPT_STEPS), "--lr", "3e-4", "--warmup", "20", "--seed", "0",
        "--log-every", "100", "--ckpt-every", str(CKPT_EVERY),
        "--ckpt-dir", str(directory), *extra])


def host_state(loop) -> list:
    """(path, owned host copy) of each of the loop's parameter and
    AdamState leaves."""
    from repro_torch.tree import leaves_with_paths
    return [(path, x.detach().to("cpu", copy=True)) for path, x in
            leaves_with_paths({"params": loop.params,
                               "opt": loop.opt_state})]


def dir_bytes(path) -> int:
    return sum(f.stat().st_size for f in Path(path).rglob("*")
               if f.is_file())


class CkptClock:
    """Phase 40's instruments, put on a loop's manager and step: the host
    seconds inside ``save`` (joining the previous writer, then the host
    copy, or the whole write when blocking), the writer's seconds and
    bytes (``manager.save_pytree``), ``restore``'s seconds, and the host
    clock at each step's start."""

    def __init__(self):
        from repro_torch.checkpoint import manager as M
        self.M, self.saves, self.writes, self.restores = M, [], [], []
        self.starts = []
        self._save_pytree, self._restore = M.save_pytree, \
            M.CheckpointManager.restore
        clock = self

        def save_pytree(path, tree, extra=None):
            t0 = time.perf_counter()
            clock._save_pytree(path, tree, extra)
            clock.writes.append((time.perf_counter() - t0,
                                 Path(path, "arrays.npz").stat().st_size))

        def restore(mgr, like, step=None):
            t0 = time.perf_counter()
            out = clock._restore(mgr, like, step)
            clock.restores.append(time.perf_counter() - t0)
            return out

        M.save_pytree, M.CheckpointManager.restore = save_pytree, restore

    def attach(self, loop) -> None:
        mgr, save, step_fn, clock = loop.ckpt, loop.ckpt.save, \
            loop.step_fn, self

        def timed_save(step, tree, extra=None, blocking=True):
            t0 = time.perf_counter()
            mgr.wait()
            t1 = time.perf_counter()
            save(step, tree, extra, blocking)
            clock.saves.append({"step": step, "blocking": blocking,
                                "join_ms": (t1 - t0) * 1e3,
                                "ms": (time.perf_counter() - t0) * 1e3})

        def timed_step(params, opt_state, batch):
            clock.starts.append(time.perf_counter())
            return step_fn(params, opt_state, batch)

        loop.ckpt.save, loop.step_fn = timed_save, timed_step

    def close(self) -> None:
        self.M.save_pytree = self._save_pytree
        self.M.CheckpointManager.restore = self._restore


def checkpoint_main_path(dev, phase) -> dict:
    """Phase 40: checkpointed training of qwen3-0.6b under linear (B2/B3)
    at full width, cut to ``CKPT_LAYERS`` layers, through
    ``launch/train.py``'s ``build`` and ``TrainLoop``: batch 8 x 1,024,
    fp32 master, bf16 compute, async saves every 4 steps into a directory
    under ``build/`` (removed at the end). Run A: 12 steps uninterrupted.
    Run B: ``--fail-at-step 8`` (its step-8 writer joined, as a process
    that finished its save before dying), then a fresh loop in the same
    directory, which must resume at step 8 and finish: its parameters
    and AdamState bit for bit run A's, and the losses of steps 9-12 run
    A's. Then a preemption request at step 3: a blocking save, the loop
    stopped, and a new loop resumed at 3 with the preempted loop's state
    bit for bit. Every kernel's launch count set to 0 before run A and
    read after the preemption's resume: B2/B3 exactly 27 steps' worth.
    Prints the bytes on disk, the host ms inside ``save``, the writer's
    seconds and GB/s, the restores' seconds and ms a step with a save and
    without."""
    import gc
    import math
    import shutil
    import torch
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.runtime import InjectedFailure
    base = ROOT / "build" / "chip_smoke_ckpt"
    shutil.rmtree(base, ignore_errors=True)
    base.mkdir(parents=True)
    disk = shutil.disk_usage(base)
    print(f"phase {phase}: checkpoint directory {base.relative_to(ROOT)}: "
          f"{disk.free / 1e9:.1f} GB free of {disk.total / 1e9:.1f} GB")
    clock = CkptClock()
    names = TRAIN_KERNELS["linear"][0]
    try:
        # run A
        gc.collect()
        torch.cuda.empty_cache()
        loop = train.build(ckpt_args(base / "a"))
        cfg = train.config(ckpt_args(base / "a"))
        n_params = lm.param_count(loop.params)
        clock.attach(loop)
        reset_launches()
        t0 = time.perf_counter()
        out_a = loop.run()
        t_end = time.perf_counter()
        ref = host_state(loop)
        losses_a = [m["loss"] for m in out_a["metrics"]]
        a_saves, a_starts = list(clock.saves), clock.starts + [t_end]
        on_disk = dir_bytes(base / "a" / f"step_{CKPT_STEPS}")
        kept = sorted(p.name for p in (base / "a").iterdir())
        release_train_loop()
        del loop, out_a
        shutil.rmtree(base / "a")
        if kept != [f"step_{s}" for s in (12, 4, 8)] or not all(
                math.isfinite(x) for x in losses_a):
            raise AssertionError(f"phase {phase}: run A kept {kept}, losses "
                                 f"{losses_a}")
        # run B: the crash, then the resume
        gc.collect()
        torch.cuda.empty_cache()
        crashing = train.build(ckpt_args(base / "b", "--fail-at-step",
                                         str(CKPT_FAIL)))
        try:
            crashing.run()
            raise AssertionError(f"phase {phase}: no injected failure")
        except InjectedFailure:
            pass
        crashing.ckpt.wait()
        losses_b0 = [m["loss"] for m in crashing.metrics_history]
        release_train_loop()
        del crashing
        gc.collect()
        torch.cuda.empty_cache()
        t_r = time.perf_counter()
        resumed = train.build(ckpt_args(base / "b"))
        build_s = time.perf_counter() - t_r
        if resumed.step != CKPT_FAIL:
            raise AssertionError(f"phase {phase}: resumed at step "
                                 f"{resumed.step}, want {CKPT_FAIL}")
        out_b = resumed.run()
        got = host_state(resumed)
        losses_b = [m["loss"] for m in out_b["metrics"]]
        release_train_loop()
        del resumed, out_b
        shutil.rmtree(base / "b")
        diff = [(path, (a.float() - b.float()).abs().max().item())
                for (path, a), (_, b) in zip(ref, got)
                if not torch.equal(a, b)]
        print(f"phase {phase}: run B crashed at step {CKPT_FAIL} (losses "
              f"{[round(x, 6) for x in losses_b0]}), resumed at step "
              f"{CKPT_FAIL} (build with restore {build_s:.3f} s), finished "
              f"at {CKPT_STEPS}: {len(ref) - len(diff)} of {len(ref)} "
              f"parameter and AdamState leaves bit for bit run A's; losses "
              f"of steps {CKPT_FAIL + 1}-{CKPT_STEPS} {losses_b} against "
              f"run A's (steps 1-{CKPT_STEPS}) {losses_a}")
        if diff or losses_b != losses_a[CKPT_FAIL:] or \
                losses_b0 != losses_a[:CKPT_FAIL]:
            raise AssertionError(f"phase {phase}: run B is not run A: "
                                 f"leaves (path, max |diff|) {diff[:8]}")
        del ref, got
        # the preemption
        gc.collect()
        torch.cuda.empty_cache()
        loop = train.build(ckpt_args(base / "p"))
        clock.attach(loop)
        orig = loop.step_fn

        def spy(params, opt_state, batch):
            if loop.step == CKPT_PREEMPT - 1:
                loop.request_preemption()
            return orig(params, opt_state, batch)

        loop.step_fn = spy
        out_p = loop.run()
        kept = loop.ckpt.steps()
        pre = host_state(loop)
        release_train_loop()
        del loop, out_p
        gc.collect()
        torch.cuda.empty_cache()
        again = train.build(ckpt_args(base / "p"))
        post = host_state(again)
        launches = read_launches()
        step_p = again.step
        release_train_loop()
        del again
        same = all(torch.equal(a, b) for (_, a), (_, b) in zip(pre, post))
        print(f"phase {phase}: preemption requested during step "
              f"{CKPT_PREEMPT}: stopped at step {CKPT_PREEMPT} with a "
              f"blocking save ({clock.saves[-1]['ms']:.1f} ms), steps kept "
              f"{kept}; a new loop resumed at step {step_p}, its state bit "
              f"for bit the preempted loop's: {same}")
        if kept != [CKPT_PREEMPT] or step_p != CKPT_PREEMPT or not same:
            raise AssertionError(f"phase {phase}: preemption kept {kept}, "
                                 f"resumed at {step_p}, state equal {same}")
        del pre, post
    finally:
        clock.close()
        shutil.rmtree(base, ignore_errors=True)
    steps = CKPT_STEPS + CKPT_FAIL + (CKPT_STEPS - CKPT_FAIL) + CKPT_PREEMPT
    want = dict(zip(names, (2 * cfg.n_layers * steps, cfg.n_layers * steps,
                            cfg.n_layers * steps)))
    got_l = {k: n for k, n in launches.items() if n}
    if got_l != want:
        raise AssertionError(f"phase {phase}: launches {got_l} (want {want} "
                             f"over {steps} steps)")
    # run A's numbers
    iters = [b - a for a, b in zip(a_starts, a_starts[1:])]
    with_save = [t for i, t in enumerate(iters, 1) if i % CKPT_EVERY == 0]
    without = [t for i, t in enumerate(iters, 1)
               if i % CKPT_EVERY and i > 1]
    writes = [(s, n) for s, n in clock.writes]
    gbs = [n / s / 1e9 for s, n in writes]
    rec = {
        "params": n_params, "bytes_on_disk": on_disk,
        "stall_ms": [round(s["ms"], 3) for s in a_saves],
        "join_ms": [round(s["join_ms"], 3) for s in a_saves],
        "write_s": [round(s, 3) for s, _ in writes],
        "write_gb_s": [round(g, 3) for g in gbs],
        "restore_s": [round(s, 3) for s in clock.restores],
        "ms_step_with_save": [round(t * 1e3, 3) for t in with_save],
        "ms_step_without": [round(t * 1e3, 3) for t in without],
        "launches": {k: launches[k] for k in names}}
    print(f"phase {phase}: checkpointed training qwen3-0.6b linear cut to "
          f"{cfg.n_layers} of 28 layers ({n_params} params; fp32 master and "
          f"two fp32 moments), batch 8 x 1,024, async saves every "
          f"{CKPT_EVERY} steps, blocking at step {CKPT_STEPS}: "
          f"{on_disk:,} bytes on disk a checkpoint; host ms inside save "
          f"(run A, steps 4, 8, 12) {rec['stall_ms']} of which joining the "
          f"previous writer {rec['join_ms']}; the writer's seconds "
          f"{rec['write_s']} ({rec['write_gb_s']} GB/s; every save of the "
          f"phase); restores {rec['restore_s']} s; run A ms a step with a "
          f"save {rec['ms_step_with_save']}, without "
          f"{rec['ms_step_without']} (host clock from a step's start to the "
          f"next's; the first step left out); launches {rec['launches']} "
          f"over {steps} steps")
    gc.collect()
    torch.cuda.empty_cache()
    return rec


# ---------------------------------------------------------------------------
# phases 41-43: speculative decoding and the engine's request lifecycle
# ---------------------------------------------------------------------------

SPEC_K = 6
# phase 41's workload: prompt lengths (one of a single token, one past the
# ingest chunk), budgets, and each request's speculate_k (0: plain, riding
# along masked in the verify; 3 < K: always rewinds)
SPEC_SLICE_PROMPTS = (5, 40, 17, 1, 90, 23)
SPEC_SLICE_GENS = (30, 24, 30, 12, 26, 30)
SPEC_SLICE_K = (SPEC_K, 0, SPEC_K, 3, SPEC_K, 0)
# phase 42's drafts: (backend, draft)
SPEC_RUNS = (("linear", "ngram"), ("gated_linear", "ngram"),
             ("softmax", "ngram"), ("linear", "replay"), ("linear", "model"))


def state_leaves(state) -> list:
    return [t for group in state.values() for st in group for t in st
            if t is not None]


def clone_state(state):
    return {part: tuple(type(st)(*(None if t is None else t.clone()
                                   for t in st)) for st in group)
            for part, group in state.items()}


def slots_unchanged(new, old, slots) -> bool:
    """Every leaf of ``new`` bit for bit ``old``'s at ``slots`` (slot axis
    1 in the stacked groups, 0 in the tail)."""
    import torch
    for part, axis in (("stack", 1), ("tail", 0)):
        for st_n, st_o in zip(new[part], old[part]):
            for n, o in zip(st_n, st_o):
                if n is None:
                    continue
                for s in slots:
                    if not torch.equal(n.select(axis, s), o.select(axis, s)):
                        return False
    return True


def noisy_replay(prompts, comps, vocab, every=9):
    """A ReplayDraft of the plain run's tokens with every ``every``-th one
    changed: windows of K = 6 are then accepted whole or cut at varying
    points (the cursor stays in step: it advances by the emitted
    tokens)."""
    import numpy as np
    from repro_torch.serving import ReplayDraft
    conts = {}
    for p, c in zip(prompts, comps):
        t = c.tokens.astype(np.int64).copy()
        t[every - 1::every] = (t[every - 1::every] + 1) % vocab
        conts[ReplayDraft.key(p)] = t
    return ReplayDraft(conts)


def spec_slice(backend, dev, phase) -> None:
    """Phase 41: speculative rounds on 2 layers at qwen3-0.6b's full
    widths in fp32 (4 slots, segments of 4, K = 6; requests plain,
    speculative and at K = 3, a draft of the plain run's tokens with
    every ninth changed, so windows are accepted whole or cut at every
    point; one speculative request preempted and resumed: under softmax
    a row-ranged snapshot and restore). The engine through B1/B7 (the
    K+1-token verify window under per-slot positions and masks, the
    batched varlen rewind, decode, ingest) or B10 (admission) in lock
    step with the same engine under ``decode_kernel="reference"``: the
    whole engine state within 1e-5 after every step, completions and
    stats identical, every token the plain greedy run's; in every round
    the slots not speculating (plain, empty or finished) and in every
    segment the speculative slots bit for bit; launches exactly
    ``stream_launches`` (layers x (segment steps + ingest chunks +
    verify rounds + rewind passes); softmax B10 layers x (waves +
    1-token prefills)) and no other kernel."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine
    name = serve.STREAM_KERNELS[backend][0]
    cfg = full_width("qwen3-0.6b", backend, 2)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(1), cfg)
    rng = np.random.default_rng(41)
    prompts = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
               for n in SPEC_SLICE_PROMPTS]
    kw = dict(n_slots=4, segment_len=4, max_len=160, prefill_chunk=64)
    plain_eng = DecodeEngine(params, cfg, **kw)
    for p, g in zip(prompts, SPEC_SLICE_GENS):
        plain_eng.submit(p, g)
    plain = plain_eng.run()
    engines, checked = {}, {"rounds": 0, "segments": 0}
    for kernel in ("auto", "reference"):
        eng = DecodeEngine(params, dataclasses.replace(cfg,
                                                       decode_kernel=kernel),
                           draft=noisy_replay(prompts, plain, cfg.vocab_size),
                           **kw)
        for p, g, k in zip(prompts, SPEC_SLICE_GENS, SPEC_SLICE_K):
            eng.submit(p, g, speculate_k=k)
        engines[kernel] = eng
    a, b = engines["auto"], engines["reference"]

    def guarded(method, key, moving):
        def run():
            keep = [s for s in range(a.n_slots) if not moving()[s]]
            before = clone_state(a.state)
            method()
            if not slots_unchanged(a.state, before, keep):
                raise AssertionError(f"phase {phase}: a {key[:-1]} changed "
                                     f"the state of slots {keep}")
            checked[key] += 1
        return run
    a.step_spec_round = guarded(a.step_spec_round, "rounds",
                                lambda: a._active & (a._spec_k > 0))
    a.step_segment = guarded(a.step_segment, "segments",
                             lambda: a._active & (a._spec_k == 0))
    reset_launches()
    worst, steps, preempted = 0.0, 0, False
    while True:
        more = a.step()
        more_b = b.step()
        steps += 1
        if (more, a._clock, a._pos.tolist()) != (more_b, b._clock,
                                                 b._pos.tolist()):
            raise AssertionError(f"phase {phase}: the engines part at step "
                                 f"{steps}")
        for x, y in zip(state_leaves(a.state), state_leaves(b.state)):
            err = (x - y).abs().max().item() / max(1.0,
                                                   y.abs().max().item())
            worst = max(worst, err)
        if worst > 1e-5:
            raise AssertionError(f"phase {phase}: engine state {worst:.3e} "
                                 f"from the reference engine at step "
                                 f"{steps}")
        spec_slots = np.nonzero(a._active & (a._spec_k > 0))[0]
        if not preempted and steps >= 3 and len(spec_slots):
            for eng in (a, b):
                eng.preempt(int(spec_slots[0]))
            preempted = True
        if not more:
            break
    torch.cuda.synchronize()
    launches = read_launches()
    st, ref_st = a.stats.to_dict(), b.stats.to_dict()
    if st != ref_st:
        raise AssertionError(f"phase {phase}: stats differ: {st} vs "
                             f"{ref_st}")
    for x, y, p in zip(a.completions(), b.completions(), plain):
        if (x.tokens.tolist(), x.status, x.admitted_step, x.finished_step
            ) != (y.tokens.tolist(), y.status, y.admitted_step,
                  y.finished_step) or x.tokens.tolist() != p.tokens.tolist():
            raise AssertionError(f"phase {phase}: request {x.uid}: "
                                 f"{x.tokens.tolist()} through the kernels, "
                                 f"{y.tokens.tolist()} reference, "
                                 f"{p.tokens.tolist()} plain greedy")
    ones = sum(n == 1 for n in SPEC_SLICE_PROMPTS)
    want = serve.stream_launches(cfg, st, a.ingest, a.admission, ones)
    others = {k: n for k, n in launches.items() if k != name and n}
    if launches[name] != want or others:
        raise AssertionError(f"phase {phase}: {name} launched "
                             f"{launches[name]} times, want {want}; others "
                             f"{others}")
    if not (0 < st["acceptance_rate"] < 1 and st["spec_rewinds"]
            and st["spec_rewind_dispatches"] == st["spec_rewind_rounds"]
            and st["preemptions"] == st["resumes"] == 1
            and checked["rounds"] and checked["segments"]):
        raise AssertionError(f"phase {phase}: the workload missed a path: "
                             f"{st}, {checked}")
    print(f"phase {phase}: {backend} spec slice, 2 layers full width fp32, "
          f"K={SPEC_K}: kernel engine = reference engine in lock step "
          f"(state within {worst:.2e} after each of {steps} steps; "
          f"completions and stats identical) = plain greedy; "
          f"{checked['rounds']} rounds and {checked['segments']} segments "
          f"left the other slots bit for bit; acceptance "
          f"{st['acceptance_rate']:.3f}, {st['spec_rounds']} rounds, "
          f"{st['spec_rewinds']} rewinds in {st['spec_rewind_dispatches']} "
          f"passes, a preempt/resume; {name} launched {launches[name]} = "
          f"{want}")


def spec_main_path(backend, draft, dev, phase) -> dict:
    """Phase 42: ``serve --mode spec`` on qwen3-0.6b cut to
    ``SERVE_TIME_LAYERS`` layers in fp32 (random weights from seed 0; a
    model draft: a second qwen3-0.6b from generator seed 1), 8 slots, 16
    requests of 128 random prompt tokens (JAX's draw, seed 0), 64 tokens
    each, K = 6 (softmax admits each prompt whole, ``--prefill-chunk
    128``), every kernel's launch count set to 0 just before and read just
    after. The mode itself asserts the speculative tokens equal plain
    greedy's for every request; here the launches in each timed run equal
    ``stream_launches`` (plus ``draft_launches``) and the whole run's
    theirs and the two short warm-ups', no other kernel launched, one
    rewind pass a rewinding round. Returns the backend kernel's launches
    and the numbers."""
    import torch
    from repro_torch.launch import serve
    name = serve.STREAM_KERNELS[backend][0]
    args = serve.parse_args(
        ["--mode", "spec", "--arch", "qwen3-0.6b", "--backend", backend,
         "--slots", "8", "--segment-len", "8", "--n-requests", "16",
         "--prompt-len", "128", "--gen-len", "64", "--speculate-k",
         str(SPEC_K), "--draft", draft, "--seed", "0", "--n-layers",
         str(SERVE_TIME_LAYERS)]
        + (["--prefill-chunk", "128"] if backend == "softmax" else []))
    t0 = time.perf_counter()
    reset_launches()
    res = serve.spec(args)
    torch.cuda.synchronize()
    launches = read_launches()
    wall = time.perf_counter() - t0
    st = res["stats"]
    want = (res["want_spec_launches"] + res["want_plain_launches"]
            + res["want_warmup_launches"])
    if res["spec_launches"] != res["want_spec_launches"] or \
            res["plain_launches"] != res["want_plain_launches"] or \
            launches[name] != want:
        raise AssertionError(
            f"phase {phase}: {name} launched {res['spec_launches']} / "
            f"{res['plain_launches']} in the timed spec / plain runs (want "
            f"{res['want_spec_launches']} / {res['want_plain_launches']}), "
            f"{launches[name]} in all (want {want})")
    others = {k: n for k, n in launches.items() if k != name and n}
    if others:
        raise AssertionError(f"phase {phase}: other kernels launched: "
                             f"{others}")
    if st["spec_rewind_dispatches"] != st["spec_rewind_rounds"] or \
            not st["spec_rounds"] or st["segments"]:
        raise AssertionError(f"phase {phase}: rounds or rewinds off: {st}")
    if draft == "replay" and st["acceptance_rate"] < 0.9:
        raise AssertionError(f"phase {phase}: the replay draft's acceptance "
                             f"{st['acceptance_rate']}")
    rec = {"backend": backend, "draft": draft,
           "spec_tok_s": res["spec_tokens_per_s"],
           "plain_tok_s": res["plain_tokens_per_s"],
           "speedup": res["spec_tokens_per_s"] / res["plain_tokens_per_s"],
           "acceptance": st["acceptance_rate"],
           "rounds": st["spec_rounds"], "rewinds": st["spec_rewinds"],
           "rewind_passes": st["spec_rewind_dispatches"],
           "tokens_per_round": st["tokens_per_round"],
           "launches": launches[name], "draft_launches":
               res["draft_launches"]}
    print(f"phase {phase}: qwen3-0.6b {backend} spec main path, draft "
          f"{draft}: {json.dumps(rec)}; spec tokens = plain greedy for all "
          f"{len(res['completions'])} requests; {name} {launches[name]} = "
          f"{res['want_spec_launches']} + {res['want_plain_launches']} + "
          f"{res['want_warmup_launches']} (warm-ups); {wall:.1f} s with "
          f"weights and warm-ups")
    del res
    torch.cuda.empty_cache()
    return {"name": name, "launches": launches[name], "rec": rec}


def lifecycle_main_path(backend, dev, phase) -> dict:
    """Phase 43: the engine's lifecycle on qwen3-0.6b cut to
    ``SERVE_TIME_LAYERS`` layers in fp32 (random weights from seed 0), 8
    slots, segments of 8, 32 requests of 128 prompt tokens and 32 or 4
    generated (JAX's ``make_request_mix``, seed 0, all at step 0; softmax
    admits each prompt whole). Runs: clean; an explicit preempt and resume;
    a NaN poisoned into slot 0 after the second segment, mid-request (the
    probe finds it, the slot is quarantined, the request retried from its
    activation checkpoint on another slot); speculation (an n-gram draft, K
    = 6, every other request) with the second round sabotaged (every
    continuing slot rewinds); a queue of 12 shedding the rest
    (``reject_new``) with a cancel of a queued and of an active request, a
    deadline inside a request's run and degradation at 0.5 waiting requests
    a slot; a queue of 4 under ``evict_lowest``. Every request's tokens
    equal the clean run's (cut short where cancelled or past its deadline),
    the counters exact, and each run's launches ``stream_launches``; every
    kernel's count set to 0 before each run and read after. Returns the
    backend kernel's launches over the runs and the counters."""
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine, FaultInjector, NgramDraft
    name = serve.STREAM_KERNELS[backend][0]
    cfg = full_width("qwen3-0.6b", backend, SERVE_TIME_LAYERS)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    mix = serve.make_request_mix(np.random.default_rng(0), 32, 128, 32,
                                 cfg.vocab_size, 0.0)
    eng = DecodeEngine(params, cfg, n_slots=8, segment_len=8,
                       max_len=128 + 32 + SPEC_K + 8,
                       prefill_chunk=128 if backend == "softmax" else 64)
    total = {"launches": 0}

    def run(label, submit=None, drive=None, **attrs):
        for k, v in dict(dict(injector=None, draft=None, max_queue=None,
                              shed_policy="reject_new",
                              degrade_threshold=None), **attrs).items():
            setattr(eng, k, v)
        eng.reset()
        for i, (p, g, _) in enumerate(mix):
            (submit or (lambda i, p, g: eng.submit(p, g)))(i, p, g)
        reset_launches()
        t0 = time.perf_counter()
        if drive is not None:
            drive()
        comps = eng.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        st = eng.stats.to_dict()
        want = serve.stream_launches(cfg, st, eng.ingest, eng.admission)
        others = {k: n for k, n in launches.items() if k != name and n}
        if launches[name] != want or others:
            raise AssertionError(f"phase {phase}: {label}: {name} launched "
                                 f"{launches[name]} times, want {want}; "
                                 f"others {others}")
        total["launches"] += launches[name]
        total[label] = {k: st[k] for k in (
            "preemptions", "resumes", "quarantined", "retries", "failed",
            "checkpoints", "finite_checks", "shed", "cancelled",
            "deadline_evictions", "degrade_transitions", "spec_disables",
            "spec_rounds", "spec_rewinds", "spec_rewind_rounds")}
        total[label]["seconds"] = round(dt, 3)
        return comps, st

    def same(label, comps, ref, allow_short=()):
        for c in comps:
            want = ref[c.uid].tokens.tolist()
            got = c.tokens.tolist()
            if c.uid in allow_short:
                want = want[:len(got)]
            if got != want:
                raise AssertionError(f"phase {phase}: {label}: request "
                                     f"{c.uid} gives {got}, the clean run "
                                     f"{want}")

    clean, st0 = run("clean")
    if any(c.status != "ok" for c in clean) or st0["quarantined"]:
        raise AssertionError(f"phase {phase}: clean run: {st0}")

    def preempt_one():
        for _ in range(2):
            eng.step()
        slot = int(np.nonzero(eng._active)[0][0])
        eng.preempt(slot)
    comps, st = run("preempt", drive=preempt_one)
    same("preempt", comps, clean)
    if (st["preemptions"], st["resumes"]) != (1, 1):
        raise AssertionError(f"phase {phase}: preempt: {st}")

    comps, st = run("nan", injector=FaultInjector(nan=((1, 0),)))
    same("nan", comps, clean)
    retried = [c.uid for c in comps if c.retries]
    if (st["quarantined"], st["retries"], st["failed"], retried) != \
            (1, 1, 0, [0]) or not eng._quarantined[0] or st["resumes"] != 1:
        raise AssertionError(f"phase {phase}: nan: {st}, retried "
                             f"{retried}")

    rewound = {}
    orig = eng.step_spec_round

    def spec_round():
        before, r = eng.stats.spec_rewinds, eng.stats.spec_rounds
        orig()
        rewound[r] = (eng.stats.spec_rewinds - before, int(
            (eng._active & (eng._spec_k > 0)).sum()))
    eng.step_spec_round = spec_round
    comps, st = run("spec", submit=lambda i, p, g: eng.submit(
        p, g, speculate_k=SPEC_K if i % 2 == 0 else 0),
        draft=NgramDraft(), injector=FaultInjector(spec_mismatch=(1,)))
    del eng.step_spec_round
    same("spec", comps, clean)
    if rewound[1][0] != rewound[1][1] or not rewound[1][0] or \
            st["spec_rewind_rounds"] != st["spec_rewind_dispatches"]:
        raise AssertionError(f"phase {phase}: sabotaged round rewound "
                             f"{rewound[1]}: {st}")

    def cancel_and_deadline(i, p, g):
        eng.submit(p, g, deadline_s=12.0 if i == 4 else None)
    uids = {}

    def drive_cancel():
        uids["queued"] = 10
        if not eng.cancel(uids["queued"]):
            raise AssertionError(f"phase {phase}: cancel of a queued "
                                 f"request")
        live = []
        while not live:               # degraded: 4 ingest chunks of 32
            eng.step()
            live = [eng._slot_req[s].uid for s in np.nonzero(eng._active)[0]
                    if eng._slot_req[s].uid != 4 and
                    eng._slot_req[s].max_new_tokens > 8]
        uids["active"] = int(live[0])
        eng.cancel(uids["active"])
    comps, st = run("shed", submit=cancel_and_deadline,
                    drive=drive_cancel, max_queue=12,
                    degrade_threshold=0.5)
    by = {c.uid: c for c in comps}
    same("shed", [c for c in comps if c.status != "shed"], clean,
         allow_short=(4, uids["active"], uids["queued"]))
    statuses = [c.status for c in comps]
    if (statuses.count("shed"), st["shed"]) != (20, 20) or \
            by[uids["queued"]].status != "cancelled" or \
            by[uids["active"]].status != "cancelled" or \
            not by[uids["active"]].tokens.size or \
            by[4].status != "deadline" or \
            not 0 < by[4].tokens.size < clean[4].tokens.size or \
            st["cancelled"] != 2 or st["deadline_evictions"] != 1 or \
            st["degrade_transitions"] != 2:
        raise AssertionError(f"phase {phase}: shed/cancel/deadline/degrade: "
                             f"{statuses}, {st}")

    comps, st = run("evict_lowest", submit=lambda i, p, g: eng.submit(
        p, min(g, 4), priority=i % 3), max_queue=4,
        shed_policy="evict_lowest")
    kept = [c.uid for c in comps if c.status == "ok"]
    if st["shed"] != 28 or len(kept) != 4 or \
            any(c.uid % 3 != 2 for c in comps if c.status == "ok"):
        raise AssertionError(f"phase {phase}: evict_lowest kept {kept}: "
                             f"{st}")
    same("evict_lowest", [c for c in comps if c.status == "ok"], clean,
         allow_short=tuple(kept))
    print(f"phase {phase}: qwen3-0.6b {backend} lifecycle, "
          f"{cfg.n_layers} layers fp32, "
          f"8 slots, 32 requests: preempt/resume, NaN quarantine and retry "
          f"(request {retried[0]}), a sabotaged round, cancels, a deadline, "
          f"both shed policies and degradation all equal the clean run's "
          f"tokens; {name} {total['launches']} launches, each run's "
          f"exactly stream_launches; {json.dumps(total)}")
    del eng, params
    torch.cuda.empty_cache()
    return {"name": name, "launches": total["launches"], "runs": total}


# phase 44: 16 requests of a 192-token shared prefix and a 64-token suffix
# each, 16 tokens each, 8 slots, segments of 8, chunks of 64
PREFIX_SHARED, PREFIX_SUFFIX, PREFIX_REQUESTS, PREFIX_GEN = 192, 64, 16, 16
PREFIX_CHUNK = 64
# the counts of each run, the CPU dry run's (``prefix_cache_runs`` on the
# smoke widths: the scheduler's counts do not depend on the widths), and
# the cache's counter deltas over the run
PREFIX_EXPECT = {
    "off": dict(cache_hits=0, cache_misses=0, cached_prefix_tokens=0,
                prefills=16, prefill_dispatches=2, ingest_chunks=6,
                segments=4),
    "cold": dict(cache_hits=8, cache_misses=8, cached_prefix_tokens=1536,
                 prefills=8, prefill_dispatches=1, ingest_chunks=4,
                 segments=4, inserts=19, evictions=0),
    "warm": dict(cache_hits=16, cache_misses=0, cached_prefix_tokens=3072,
                 prefills=0, prefill_dispatches=0, ingest_chunks=2,
                 segments=4, inserts=0, evictions=0),
}
PREFIX_COW = {"cold": 24, "warm": 48}
# the cache's bytes for the shared prefix at qwen3-0.6b's full widths,
# fp32 and ``SERVE_TIME_LAYERS`` layers: one linear entry (16 heads'
# 128 x 128 s and 128 z a layer), one softmax block (64 rows of K and V,
# 8 kv heads of 128, a layer)
PREFIX_LINEAR_BYTES = SERVE_TIME_LAYERS * 16 * (128 * 128 + 128) * 4
PREFIX_BLOCK_BYTES = SERVE_TIME_LAYERS * 2 * 64 * 8 * 128 * 4


def prefix_cache_prompts(vocab, seed=0):
    """One seeded shared prefix and a unique suffix per request."""
    import numpy as np
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, size=PREFIX_SHARED)
    return [np.concatenate([shared, rng.integers(
        0, vocab, size=PREFIX_SUFFIX)]).astype(np.int32)
        for _ in range(PREFIX_REQUESTS)]


def cache_tensors(cache) -> dict:
    """Every tensor the cache holds, by entry or block digest."""
    from repro_torch.tree import leaves
    if hasattr(cache, "_entries"):
        return {k: leaves(e["state"]) for k, e in cache._entries.items()}
    return {k: leaves(b.payload) for k, b in cache._blocks.items()}


def same_tensors(a: dict, b: dict) -> bool:
    """Every entry of ``a`` in ``b``, bit for bit."""
    import torch
    return all(k in b and len(a[k]) == len(b[k]) and all(
        torch.equal(x, y) for x, y in zip(a[k], b[k])) for k in a)


def prefix_cache_runs(cfg, params, dev, save_dir=None) -> dict:
    """Phase 44's runs on one engine config: ``off`` (no cache), ``cold``
    (an empty cache, 1 GiB), ``warm`` (``reset``: the cache survives) and,
    given ``save_dir``, ``reloaded`` (``save_cache``, a fresh engine,
    ``load_cache``, the warm run). Each run: completions, stats, the
    cache's counter deltas, launches, seconds and tokens/s; after each,
    every paged block's refcount must be 0 and the entries held before
    the run bit for bit unchanged. Also the cache's bytes for the shared
    prefix at 64, 128 and 192 tokens."""
    import torch
    from repro_torch.serving import DecodeEngine
    prompts = prefix_cache_prompts(cfg.vocab_size)
    kw = dict(n_slots=8, segment_len=8, prefill_chunk=PREFIX_CHUNK,
              max_len=PREFIX_SHARED + PREFIX_SUFFIX + PREFIX_GEN + 8)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {}

    def run(label, eng):
        before = ({} if eng.cache is None else
                  {k: [t.clone() for t in ts]
                   for k, ts in cache_tensors(eng.cache).items()})
        c0 = eng.cache.counters() if eng.cache is not None else None
        eng.reset()
        for p in prompts:
            eng.submit(p, PREFIX_GEN)
        reset_launches()
        t0 = time.perf_counter()
        comps = eng.run()
        sync()
        dt = time.perf_counter() - t0
        rec = {"completions": comps, "stats": eng.stats.to_dict(),
               "launches": read_launches(), "seconds": dt,
               "tok_s": sum(len(c.tokens) for c in comps) / dt}
        if eng.cache is not None:
            c1 = eng.cache.counters()
            rec["cache"] = {k: c1[k] - c0[k] for k in c1}
            rec["cache"]["bytes_used"] = c1["bytes_used"]
            if not same_tensors(before, cache_tensors(eng.cache)):
                raise AssertionError(f"{label}: a cache entry changed")
            if any(b.refcount for b in getattr(eng.cache, "_blocks",
                                               {}).values()):
                raise AssertionError(f"{label}: a paged block still pinned")
            if any(h is not None for h in eng._cache_hold):
                raise AssertionError(f"{label}: a slot still holds a pin")
        out[label] = rec
        return eng

    off = DecodeEngine(params, cfg, **kw)
    # untimed: a wave, a continuation chunk and a segment, so no first
    # use lands in the timed runs
    off.submit(prompts[0][:PREFIX_CHUNK + 1], 2)
    off.run()
    run("off", off)
    eng = run("cold", DecodeEngine(params, cfg, prefix_cache=True,
                                   cache_bytes=1 << 30, **kw))
    run("warm", eng)
    out["prefix_nbytes"] = {n: eng.cache.prefix_nbytes(prompts[0], n)
                            for n in (64, 128, 192)}
    out["entries"] = len(eng.cache)
    if save_dir is not None:
        eng.save_cache(str(save_dir))
        fresh = DecodeEngine(params, cfg, prefix_cache=True,
                             cache_bytes=1 << 30, **kw)
        if not fresh.load_cache(str(save_dir)):
            raise AssertionError("load_cache found nothing")
        saved, loaded = cache_tensors(eng.cache), cache_tensors(fresh.cache)
        if len(saved) != len(loaded) or not same_tensors(saved, loaded):
            raise AssertionError("the reloaded cache differs from the saved")
        del eng
        run("reloaded", fresh)
    out["prompts"] = prompts
    return out


def prefix_cache_main_path(backend, dev, phase) -> dict:
    """Phase 44: the engine's prefix cache on qwen3-0.6b cut to
    ``SERVE_TIME_LAYERS`` layers in fp32 (random weights from seed 0), 8
    slots, segments of 8, chunks of 64, 16 requests at step 0 of one seeded
    192-token prefix and a 64-token suffix each, 16 tokens each:
    ``prefix_cache_runs`` (off, cold, warm and, under linear, reloaded
    through a directory under ``build/``, removed at the end). Every
    request's tokens equal across the runs (else the top-2 margin where
    they part), the counts exactly ``PREFIX_EXPECT``'s, the launches
    ``stream_launches`` a run and no B10 launch or varlen prefill in a warm
    run; the cache's bytes for the shared prefix flat under linear and
    growing with it under softmax. Every kernel's count set to 0 before
    each run and read after. Returns the backend kernel's launches and the
    numbers."""
    import shutil
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    name = serve.STREAM_KERNELS[backend][0]
    cfg = full_width("qwen3-0.6b", backend, SERVE_TIME_LAYERS)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    save_dir = ROOT / "build" / "chip_smoke_prefix_cache"
    shutil.rmtree(save_dir, ignore_errors=True)
    try:
        out = prefix_cache_runs(cfg, params, dev,
                                save_dir if backend == "linear" else None)
    finally:
        shutil.rmtree(save_dir, ignore_errors=True)
    labels = [k for k in ("off", "cold", "warm", "reloaded") if k in out]
    ref = out["off"]["completions"]
    total, rec = 0, {}
    for label in labels:
        r = out[label]
        st = r["stats"]
        for c, c_ref in zip(r["completions"], ref):
            got, want = c.tokens.tolist(), c_ref.tokens.tolist()
            if got != want:
                i = next((j for j, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
                margin = serve._top2_margin(params, cfg,
                                            out["prompts"][c.uid],
                                            c_ref.tokens, i)
                raise AssertionError(
                    f"phase {phase}: {backend} {label}: request {c.uid} "
                    f"parts from the uncached run at token {i} (top-2 "
                    f"margin {margin:.3g}): {got} against {want}")
        expect = PREFIX_EXPECT["warm" if label == "reloaded" else label]
        got = {k: (r["cache"][k] if k in ("inserts", "evictions")
                   else st[k]) for k in expect}
        if got != expect:
            raise AssertionError(f"phase {phase}: {backend} {label}: counts "
                                 f"{got}, want {expect}")
        if backend == "softmax" and label in PREFIX_COW and \
                r["cache"]["cow_copies"] != PREFIX_COW[label]:
            raise AssertionError(f"phase {phase}: {label}: cow_copies "
                                 f"{r['cache']['cow_copies']}")
        want = serve.stream_launches(cfg, st, "recurrent", "batched")
        launches = r["launches"]
        others = {k: n for k, n in launches.items() if k != name and n}
        if launches[name] != want or others:
            raise AssertionError(f"phase {phase}: {backend} {label}: {name} "
                                 f"launched {launches[name]} times, want "
                                 f"{want}; others {others}")
        if label in ("warm", "reloaded") and (
                launches["flash_attention_fwd"] or st["prefill_dispatches"]):
            raise AssertionError(f"phase {phase}: {label}: a prefill ran")
        total += launches[name]
        rec[label] = {"seconds": round(r["seconds"], 3),
                      "tok_s": round(r["tok_s"], 1),
                      "launches": launches[name],
                      "cache_hits": st["cache_hits"],
                      "cached_prefix_tokens": st["cached_prefix_tokens"]}
        if "cache" in r:
            rec[label]["cache"] = r["cache"]
    nb = out["prefix_nbytes"]
    if backend == "linear":
        ok = nb[64] == nb[128] == nb[192] == PREFIX_LINEAR_BYTES
    else:
        ok = (nb[64], nb[128], nb[192]) == tuple(
            k * PREFIX_BLOCK_BYTES for k in (1, 2, 3))
    if not ok:
        raise AssertionError(f"phase {phase}: {backend} prefix_nbytes {nb}")
    rec["prefix_nbytes"] = nb
    rec["entries"] = out["entries"]
    print(f"phase {phase}: qwen3-0.6b {backend} prefix cache, "
          f"{cfg.n_layers} layers "
          f"fp32, 8 slots, 16 requests of 192 shared + 64 own tokens: "
          f"{', '.join(labels)} give every request the same tokens; counts "
          f"as the CPU dry run's; {name} {total} launches, each run's "
          f"exactly stream_launches; refcounts 0, entries unchanged; "
          f"{json.dumps(rec)}")
    del out, params
    torch.cuda.empty_cache()
    return {"name": name, "launches": total, "runs": rec}


def prefix_fork_cli(dev, phase) -> dict:
    """Phase 44's CLI run: ``serve --mode stream --prefix-cache on --fork 3
    --slots 8 --n-requests 8 --prompt-len 256 --gen-len 16`` (linear,
    bf16): 24 completions, 8 prefills and 16 forks, each member's tokens
    its primary's, the launches ``stream_launches``."""
    import torch
    from repro_torch.launch import serve
    args = serve.parse_args(
        ["--mode", "stream", "--prefix-cache", "on", "--fork", "3",
         "--slots", "8", "--n-requests", "8", "--prompt-len", "256",
         "--gen-len", "16"])
    reset_launches()
    res = serve.stream(args)
    torch.cuda.synchronize()
    launches = read_launches()
    st, comps = res["stats"], res["completions"]
    by = {c.uid: c.tokens.tolist() for c in comps}
    same = all(by[u] == by[u - u % 3] for u in by)
    want = res["want_launches"] + res["warmup_launches"]
    if len(comps) != 24 or (st["prefills"], st["forks"]) != (8, 16) or \
            not same or res["decode_launches"] != res["want_launches"] or \
            launches["decode_linear"] != want:
        raise AssertionError(
            f"phase {phase}: fork CLI: {len(comps)} completions, prefills "
            f"{st['prefills']}, forks {st['forks']}, members equal {same}, "
            f"decode_linear {launches['decode_linear']} (want {want})")
    rec = {"tok_s": round(res["tokens_per_s"], 1),
           "seconds": round(res["seconds"], 3),
           "launches": launches["decode_linear"]}
    print(f"phase {phase}: serve --mode stream --prefix-cache on --fork 3: "
          f"24 completions off 8 prefills, 16 forks, every member's tokens "
          f"its primary's; {json.dumps(rec)}")
    del res
    torch.cuda.empty_cache()
    return {"name": "decode_linear", "launches": launches["decode_linear"],
            "rec": rec}


@contextlib.contextmanager
def method_clock(*targets):
    """The seconds of every call of each ``(class, method name)`` while the
    block runs, by method name; the methods are put back after it."""
    times = {name: [] for _, name in targets}
    saved = [(cls, name, getattr(cls, name)) for cls, name in targets]
    for cls, name, orig in saved:
        def timed(self, *args, _orig=orig, _name=name, **kwargs):
            t0 = time.perf_counter()
            try:
                return _orig(self, *args, **kwargs)
            finally:
                times[_name].append(time.perf_counter() - t0)
        setattr(cls, name, timed)
    try:
        yield times
    finally:
        for cls, name, orig in saved:
            setattr(cls, name, orig)


# phase 45: JAX's mix of 32 requests (128 prompt tokens, 32 or 4 generated)
# at step 0, 8 slots, segments of 8, chunks of 64 (softmax 128). The CPU
# dry run of ``durability_runs`` at smoke widths gives 9 events a run, so
# checkpoints land after events 4 and 8 and the crashes at events 5 and 7
# restore the one after event 4
DURABLE_REQUESTS, DURABLE_PROMPT, DURABLE_GEN = 32, 128, 32
DURABLE_MAX_LEN = DURABLE_PROMPT + DURABLE_GEN + 8
DURABLE_EVERY = 4
DURABLE_CRASHES = (5, 7)
# one slot's decode state at qwen3-0.6b's full widths in fp32: linear s and
# z of 16 heads a layer; softmax K and V of 168 rows of 8 kv heads a layer
DURABLE_SLOT_BYTES = {"linear": 28 * 16 * (128 * 128 + 128) * 4,
                      "softmax": 28 * 2 * DURABLE_MAX_LEN * 8 * 128 * 4}


def durability_runs(cfg, params, dev, workdir) -> dict:
    """Phase 45's engine runs on one config, each in a directory of its
    own under ``workdir``: ``clean`` (uncrashed, journal and checkpoints
    every ``DURABLE_EVERY`` events); ``crash5`` and ``crash7`` (killed at
    that event, then ``DecodeEngine.recover`` from the journal and the
    newest checkpoint); ``journal5`` (killed at event 5 with no
    checkpoint directory, then recovered from the journal alone). Every
    drive has every kernel's count set to 0 before it and read after.
    Returns each drive's completions, stats before and after, launches
    and seconds, each recovery's seconds, the acks in each journal file,
    and the clean run's checkpoint and journal bytes and the seconds of
    every save, restore, replay and journal append."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import (DecodeEngine, FaultInjector,
                                     InjectedCrash, Journal)
    from repro_torch.serving.journal import read_journal
    mix = serve.make_request_mix(np.random.default_rng(0), DURABLE_REQUESTS,
                                 DURABLE_PROMPT, DURABLE_GEN, cfg.vocab_size,
                                 0.0)
    # softmax admits each prompt whole (phase 43's choice): a chunk of 64
    # would step the second half of every prompt one token at a time
    kw = dict(n_slots=8, segment_len=8, max_len=DURABLE_MAX_LEN,
              prefill_chunk=128 if cfg.attention_backend == "softmax"
              else 64)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    out = {"prompts": [p for p, _, _ in mix]}

    def drive(eng):
        stats0 = eng.stats.to_dict()
        reset_launches()
        t0 = time.perf_counter()
        crashed = None
        try:
            eng.run()
        except InjectedCrash as e:
            crashed = e.event_idx
        sync()
        return {"completions": eng.completions(), "crashed": crashed,
                "launches": read_launches(),
                "seconds": time.perf_counter() - t0, "stats0": stats0,
                "stats": eng.stats.to_dict()}

    def fresh(label, **engine_kw):
        d = Path(workdir) / label
        shutil.rmtree(d, ignore_errors=True)
        jp = str(d / "wal.journal")
        eng = DecodeEngine(params, cfg, journal=jp, **kw, **engine_kw)
        for p, g, _ in mix:
            eng.submit(p, g)
        return eng, jp

    def acks(jp):
        return sorted(r["uid"] for r in read_journal(jp)[0]
                      if r["t"] == "ack")

    with method_clock((DecodeEngine, "save_checkpoint"),
                      (DecodeEngine, "restore_checkpoint"),
                      (DecodeEngine, "_replay_journal"),
                      (Journal, "append")) as clock:
        cd = str(Path(workdir) / "clean" / "ck")
        eng, jp = fresh("clean", checkpoint_dir=cd,
                        checkpoint_every=DURABLE_EVERY)
        out["clean"] = drive(eng)
        eng.journal.close()
        out["clean"]["acks"] = acks(jp)
        out["state_bytes"] = lm.state_bytes(eng.state)
        out["checkpoint_bytes"] = {int(d.name[5:]): dir_bytes(d)
                                   for d in Path(cd).glob("step_*")}
        out["journal_bytes"] = Path(jp).stat().st_size
        out["journal_records"] = len(read_journal(jp)[0])
        out["save_s"] = list(clock["save_checkpoint"])
        out["events"] = eng._events
        out["append_s"] = list(clock["append"])
        del eng
        for label, crash, ckpt in [(f"crash{e}", e, True)
                                   for e in DURABLE_CRASHES] + [
                                       ("journal5", 5, False)]:
            cd = str(Path(workdir) / label / "ck") if ckpt else None
            eng, jp = fresh(label, checkpoint_dir=cd,
                            checkpoint_every=DURABLE_EVERY if ckpt else 0,
                            injector=FaultInjector(crash=(crash,)))
            run = {"crash": drive(eng)}
            eng.journal.close()
            del eng
            n_restore = len(clock["restore_checkpoint"])
            n_replay = len(clock["_replay_journal"])
            t0 = time.perf_counter()
            rec = DecodeEngine.recover(params, cfg, journal=Journal(jp),
                                       checkpoint_dir=cd, **kw)
            run["recover_s"] = time.perf_counter() - t0
            run["restore_s"] = clock["restore_checkpoint"][n_restore:]
            run["replay_s"] = clock["_replay_journal"][n_replay:]
            run["recover"] = drive(rec)
            rec.journal.close()
            run["acks"] = acks(jp)
            run["expected_crash"] = crash
            out[label] = run
            del rec
    return out


def durability_main_path(backend, dev, phase) -> dict:
    """Phase 45: engine durability on the full 28-layer qwen3-0.6b in fp32
    (random weights from seed 0): ``durability_runs`` under ``build/``
    (removed at the end). The decode state exactly 8 slots x
    ``DURABLE_SLOT_BYTES``; every crash where it was set; every uid's
    tokens after each recovery the clean run's (else the top-2 margin
    where they part); each journal file with one ack per uid; each drive's
    launches exactly ``stream_launches`` of its stats (a recovery's less
    those its checkpoint restored) and no other kernel's. Prints the
    checkpoint and journal bytes, the save, restore, replay and append
    times. Returns the backend kernel's launches and the numbers."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    name = serve.STREAM_KERNELS[backend][0]
    cfg = full_width("qwen3-0.6b", backend, 28)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    workdir = ROOT / "build" / "chip_smoke_durability"
    shutil.rmtree(workdir, ignore_errors=True)
    try:
        out = durability_runs(cfg, params, dev, workdir)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    if out["state_bytes"] != 8 * DURABLE_SLOT_BYTES[backend]:
        raise AssertionError(f"phase {phase}: {backend} state "
                             f"{out['state_bytes']} B")
    total = 0

    def check_launches(label, r):
        nonlocal total
        want = (serve.stream_launches(cfg, r["stats"], "recurrent",
                                      "batched")
                - serve.stream_launches(cfg, r["stats0"], "recurrent",
                                        "batched"))
        launches = r["launches"]
        others = {k: n for k, n in launches.items() if k != name and n}
        if launches[name] != want or others:
            raise AssertionError(f"phase {phase}: {backend} {label}: {name} "
                                 f"launched {launches[name]} times, want "
                                 f"{want}; others {others}")
        total += launches[name]

    ref = {c.uid: c.tokens.tolist() for c in out["clean"]["completions"]}
    uids = list(range(DURABLE_REQUESTS))
    if sorted(ref) != uids or out["clean"]["acks"] != uids or any(
            c.status != "ok" for c in out["clean"]["completions"]):
        raise AssertionError(f"phase {phase}: {backend} clean run: "
                             f"{sorted(ref)}, acks {out['clean']['acks']}")
    check_launches("clean", out["clean"])
    rec = {"state_bytes": out["state_bytes"],
           "checkpoint_bytes": out["checkpoint_bytes"],
           "save_s": [round(t, 4) for t in out["save_s"]],
           "journal_bytes": out["journal_bytes"],
           "journal_records": out["journal_records"],
           "append_us": round(float(np.mean(out["append_s"])) * 1e6, 1),
           "append_us_max": round(max(out["append_s"]) * 1e6, 1),
           "clean_s": round(out["clean"]["seconds"], 3)}
    for label in [f"crash{e}" for e in DURABLE_CRASHES] + ["journal5"]:
        r = out[label]
        if r["crash"]["crashed"] != r["expected_crash"]:
            raise AssertionError(f"phase {phase}: {backend} {label}: crashed "
                                 f"at {r['crash']['crashed']}")
        check_launches(f"{label} until the crash", r["crash"])
        check_launches(f"{label} recovered", r["recover"])
        for c in r["recover"]["completions"]:
            got, want = c.tokens.tolist(), ref[c.uid]
            if got != want:
                i = next((j for j, (a, b) in enumerate(zip(got, want))
                          if a != b), min(len(got), len(want)))
                margin = serve._top2_margin(params, cfg,
                                            out["prompts"][c.uid],
                                            np.asarray(want), i)
                raise AssertionError(
                    f"phase {phase}: {backend} {label}: request {c.uid} "
                    f"parts from the clean run at token {i} (top-2 margin "
                    f"{margin:.3g}): {got} against {want}")
        got_uids = [c.uid for c in r["recover"]["completions"]]
        if got_uids != uids or r["acks"] != uids:
            raise AssertionError(f"phase {phase}: {backend} {label}: "
                                 f"completions {got_uids}, acks {r['acks']}")
        rec[label] = {"recover_s": round(r["recover_s"], 4),
                      "restore_s": [round(t, 4) for t in r["restore_s"]],
                      "replay_s": [round(t, 5) for t in r["replay_s"]],
                      "restored_events": r["recover"]["stats0"]["segments"],
                      "run_s": round(r["recover"]["seconds"], 3)}
    if not total:
        raise AssertionError(f"phase {phase}: {backend}: no {name} launch")
    print(f"phase {phase}: qwen3-0.6b {backend} durability, 28 layers fp32, "
          f"8 slots, 32 requests: crashed at events {DURABLE_CRASHES} "
          f"(recovered from the journal and a checkpoint) and at 5 (the "
          f"journal alone), every uid's tokens the uncrashed run's, one ack "
          f"each; state {out['state_bytes']} B = 8 x "
          f"{DURABLE_SLOT_BYTES[backend]}; {name} {total} launches, each "
          f"drive's exactly stream_launches; {json.dumps(rec)}")
    del out, params
    torch.cuda.empty_cache()
    return {"name": name, "launches": total, "rec": rec}


def durability_cli(dev, phase) -> dict:
    """Phase 45's CLI run: ``serve --mode stream --slots 8 --n-requests 32
    --prompt-len 128 --gen-len 32`` (qwen3-0.6b linear, bf16) with
    ``--journal`` and ``--checkpoint-dir`` under ``build/`` (removed at the
    end): ``--crash-at-event 5`` returns exit code 3, then ``--recover``
    completes the stream with each request acked once in the journal;
    both runs' B1 launches exactly ``stream_launches`` (the recovery's
    less what its checkpoint restored)."""
    import shutil
    import torch
    from repro_torch.launch import serve
    from repro_torch.serving.journal import read_journal
    d = ROOT / "build" / "chip_smoke_durability_cli"
    shutil.rmtree(d, ignore_errors=True)
    argv = ["--mode", "stream", "--slots", "8", "--segment-len", "8",
            "--n-requests", "32", "--prompt-len", "128", "--gen-len", "32",
            "--journal", str(d / "wal.journal"), "--checkpoint-dir",
            str(d / "ck")]
    try:
        reset_launches()
        res = serve.stream(serve.parse_args(argv + ["--crash-at-event",
                                                    "5"]))
        torch.cuda.synchronize()
        crash_launches = read_launches()
        eng = res["engine"]
        want_crash = serve.stream_launches(eng.cfg, eng.stats.to_dict(),
                                           eng.ingest, eng.admission)
        eng.journal.close()
        acked_at_crash = len(eng.journal.acked())
        del eng, res
        if crash_launches["decode_linear"] != want_crash:
            raise AssertionError(f"phase {phase}: the crashed CLI run "
                                 f"launched {crash_launches['decode_linear']}"
                                 f", want {want_crash}")
        reset_launches()
        res = serve.stream(serve.parse_args(argv + ["--recover"]))
        torch.cuda.synchronize()
        launches = read_launches()
        res["engine"].journal.close()
        acks = sorted(r["uid"] for r in read_journal(
            str(d / "wal.journal"))[0] if r["t"] == "ack")
    finally:
        shutil.rmtree(d, ignore_errors=True)
    if res["exit_code"] != 0 or acks != list(range(32)) or \
            res["acks"] != 32 or not crash_launches["decode_linear"] or \
            launches["decode_linear"] != res["want_launches"]:
        raise AssertionError(f"phase {phase}: CLI recover: exit "
                             f"{res['exit_code']}, acks {acks}, launches "
                             f"{launches['decode_linear']} (want "
                             f"{res['want_launches']})")
    rec = {"acked_at_crash": acked_at_crash,
           "crash_launches": crash_launches["decode_linear"],
           "recover_launches": launches["decode_linear"],
           "recover_s": round(res["seconds"], 3)}
    print(f"phase {phase}: serve --mode stream --journal --checkpoint-dir "
          f"--crash-at-event 5 exits 3; --recover then acks each of the 32 "
          f"requests once; {json.dumps(rec)}")
    del res
    torch.cuda.empty_cache()
    return {"name": "decode_linear",
            "launches": rec["crash_launches"] + rec["recover_launches"],
            "rec": rec}


# phase 46: the fleet's groups, 24 requests of JAX's mix (128 prompt
# tokens, 32 or 4 generated) in turn, 2 replicas of 4 slots a group
FLEET_GROUPS = ("linear", "gated_linear", "softmax")
FLEET_REQUESTS = 24


def fleet_main_path(dev, phase) -> dict:
    """Phase 46, the fleet: qwen3-0.6b whole (28 layers, fp32, random
    weights from one seed a group) under linear, gated_linear and
    softmax, 2 replicas of 4 slots a group, segments of 8, chunks of 64.
    Replica 0 of the linear group crashes at its event 1: every original
    uid completes once, with the tokens of its group's single engine, one
    failover, no uid unrecovered. Then a fleet with per-replica journals
    and checkpoints is stepped twice, checkpointed, and
    ``FleetEngine.recover`` reaches the same completions. Every kernel's
    launches exactly ``serve.fleet_launches`` of the replicas' stats (the
    recovery's less what its checkpoints restored). Returns the launches
    by kernel and the numbers."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serving import DecodeEngine, FaultInjector, FleetEngine
    groups = {}
    for i, b in enumerate(FLEET_GROUPS):
        cfg = full_width("qwen3-0.6b", b, 28)
        groups[b] = (lm.init_params(torch.Generator(device=dev).manual_seed(
            i), cfg), cfg)
    mix = serve.make_request_mix(np.random.default_rng(0), FLEET_REQUESTS,
                                 128, 32, groups["linear"][1].vocab_size, 0.0)
    route = [FLEET_GROUPS[i % len(FLEET_GROUPS)] for i in range(len(mix))]
    kw = dict(n_slots=4, segment_len=8, prefill_chunk=64, max_len=168)
    # softmax admits each prompt whole, as in phase 45
    per_group = {"softmax": {"prefill_chunk": 128}}
    ref = {}
    for b, (params, cfg) in groups.items():
        eng = DecodeEngine(params, cfg, **dict(kw, **per_group.get(b, {})))
        for i, (p, g, _) in enumerate(mix):
            if route[i] == b:
                eng.submit(p, g, uid=i)
        ref.update({c.uid: c.tokens.tolist() for c in eng.run()})
        del eng
    total = {}

    def drive(fleet, label):
        want0 = serve.fleet_launches(fleet)
        reset_launches()
        t0 = time.perf_counter()
        comps = fleet.run()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        want = serve.fleet_launches(fleet)
        for k in want:
            want[k] -= want0.get(k, 0)
        others = {k: n for k, n in launches.items() if k not in want and n}
        if any(launches[k] != n for k, n in want.items()) or others:
            raise AssertionError(f"phase {phase}: fleet {label}: launches "
                                 f"{launches}, want {want}")
        for k, n in want.items():
            total[k] = total.get(k, 0) + n
        got = {c.uid: c.tokens.tolist() for c in comps}
        if got != ref:
            bad = [u for u in ref if got.get(u) != ref[u]]
            raise AssertionError(f"phase {phase}: fleet {label}: uids {bad} "
                                 f"differ from their group's single engine")
        return dt

    # replica 0 of linear holds requests 0 and 12, of 32 tokens each:
    # both run past its event 1
    fleet = FleetEngine(groups, replicas=2, per_group=per_group,
                        replica_injectors={
                            ("linear", 0): FaultInjector(crash=(1,))}, **kw)
    for i, (p, g, _) in enumerate(mix):
        fleet.submit(p, g, backend=route[i])
    failover_s = drive(fleet, "failover")
    st = fleet.stats()
    if st["failovers"] != 1 or not st["readmitted"] or st["unrecovered"] \
            or not st["replicas"]["linear"][0]["dead"]:
        raise AssertionError(f"phase {phase}: fleet failover: {st}")
    rec = {"failover_s": round(failover_s, 3),
           "readmitted": st["readmitted"]}
    del fleet
    d = ROOT / "build" / "chip_smoke_fleet"
    shutil.rmtree(d, ignore_errors=True)
    try:
        durable = dict(replicas=2, journal_dir=str(d / "wal"),
                       checkpoint_dir=str(d / "ck"), per_group=per_group,
                       **kw)
        fleet = FleetEngine(groups, **durable)
        for i, (p, g, _) in enumerate(mix):
            fleet.submit(p, g, backend=route[i])
        for _ in range(2):
            fleet.step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fleet.save_checkpoint()
        rec["save_s"] = round(time.perf_counter() - t0, 3)
        rec["checkpoint_bytes"] = dir_bytes(d / "ck")
        for reps in fleet._replicas.values():
            for rs in reps:
                rs.engine.journal.close()
        del fleet
        t0 = time.perf_counter()
        fleet = FleetEngine.recover(groups, **durable)
        rec["recover_s"] = round(time.perf_counter() - t0, 3)
        rec["recovered_run_s"] = round(drive(fleet, "recover"), 3)
        for reps in fleet._replicas.values():
            for rs in reps:
                rs.engine.journal.close()
        del fleet
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec["launches"] = dict(total)
    if sorted(k for k, n in total.items() if n) != sorted(
            serve.STREAM_KERNELS[b][0] for b in FLEET_GROUPS):
        raise AssertionError(f"phase {phase}: fleet launches {total}")
    print(f"phase {phase}: a fleet of qwen3-0.6b (28 layers fp32) under "
          f"{', '.join(FLEET_GROUPS)}, 2 replicas of 4 slots a group, "
          f"{FLEET_REQUESTS} requests: replica 0 of linear crashed, "
          f"failed over, every uid once with its group's single-engine "
          f"tokens; a fleet checkpoint and FleetEngine.recover reach them "
          f"too; launches exactly fleet_launches; {json.dumps(rec)}")
    del groups
    torch.cuda.empty_cache()
    return {"launches": total, "rec": rec}


def fleet_cli(dev, phase) -> dict:
    """Phase 46's CLI run: ``serve --mode stream --backends mamba2,rwkv6
    --replicas 2 --slots 4 --n-requests 16 --prompt-len 64 --gen-len 32``
    at ``fleet_demo_config``'s configs: 16 completions, B8 (the Mamba-2
    blocks' and RWKV-6's prefill) launched exactly ``fleet_launches``
    times and no other kernel."""
    import torch
    from repro_torch.launch import serve
    reset_launches()
    res = serve.stream(serve.parse_args(
        ["--mode", "stream", "--backends", "mamba2,rwkv6", "--replicas", "2",
         "--slots", "4", "--n-requests", "16", "--prompt-len", "64",
         "--gen-len", "32"]))
    torch.cuda.synchronize()
    launches = read_launches()
    name = "gated_linear_attention_fwd"
    others = {k: n for k, n in launches.items() if k != name and n}
    if len(res["completions"]) != 16 or res["want_launches"] != {
            name: launches[name]} or others:
        raise AssertionError(f"phase {phase}: fleet CLI: "
                             f"{len(res['completions'])} completions, "
                             f"launches {launches}, want "
                             f"{res['want_launches']}")
    rec = {"launches": launches[name], "seconds": round(res["seconds"], 3),
           "tok_s": round(res["tokens_per_s"], 1)}
    if not launches[name]:
        raise AssertionError(f"phase {phase}: fleet CLI: no {name} launch")
    print(f"phase {phase}: serve --mode stream --backends mamba2,rwkv6 "
          f"--replicas 2: 16 completions; {json.dumps(rec)}")
    del res
    return {"name": name, "launches": launches[name], "rec": rec}


# phase 46's lookup: the paper's k = 100 over 1,024 documents of 750 tokens
LOOKUP_K, LOOKUP_DOCS, LOOKUP_LEN = 100, 1024, 750
LOOKUP_QUERIES, LOOKUP_WAVE = 16384, 256


def lookup_durability_main_path(dev, phase) -> dict:
    """Phase 46's lookup: a ``LookupEngine`` of the paper's k = 100 (an
    fp32 GRU encoder of 32-wide embeddings over a 1,000-token vocabulary,
    random from a seed) ingests 1,024 documents of 750 tokens (a 41 MB
    store), checkpoints under ``build/`` (removed at the end) and answers
    16,384 single-query requests in waves of 256; ``LookupEngine.recover``
    from the checkpoint holds the store bitwise and answers the same
    requests bitwise alike. ``HedgedLookup`` over 2 replicas restored from
    the checkpoint, ``hedge_after`` 64 ticks: unkilled (no hedge) and
    with replica 0 killed (its 8,192 requests hedged to replica 1, each
    a hedge win, none delivered twice), the answers bitwise the single
    engine's. B4 launched once a wave in every run."""
    import shutil
    import numpy as np
    import torch
    from repro_torch.qa.gru import gru_params
    from repro_torch.serving import HedgedLookup, LookupEngine
    gens = [torch.Generator(device=dev).manual_seed(i) for i in range(3)]
    enc = {"embed": torch.randn((1000, 32), generator=gens[0], device=dev)
           * 0.1, "gru": gru_params(gens[1], 32, LOOKUP_K)}
    kw = dict(wave_size=LOOKUP_WAVE, capacity=LOOKUP_DOCS, device=dev)
    eng = LookupEngine(enc, **kw)
    rng = np.random.default_rng(0)
    for i in range(LOOKUP_DOCS):
        eng.ingest(f"doc{i}", rng.integers(0, 1000, size=LOOKUP_LEN))
    t0 = time.perf_counter()
    eng.flush()
    torch.cuda.synchronize()
    rec = {"ingest_s": round(time.perf_counter() - t0, 3)}
    docs = list(eng.rows())
    queries = torch.randn((LOOKUP_QUERIES, LOOKUP_K), generator=gens[2],
                          device=dev).cpu().numpy()
    total = 0

    def serve_all(target, label, kill=None):
        nonlocal total
        uids = [target.submit(docs[(i * 7) % len(docs)], queries[i])
                for i in range(LOOKUP_QUERIES)]
        if kill is not None:
            target.kill(kill)
        reset_launches()
        t0 = time.perf_counter()
        res = {r.uid: r for r in target.run()}
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = read_launches()
        engines = getattr(target, "engines", [target])
        waves = sum(e.stats.waves for e in engines) - sum(
            w0.get(id(e), 0) for e in engines)
        others = {k: n for k, n in launches.items()
                  if k != "mass_lookup_indexed" and n}
        if launches["mass_lookup_indexed"] != waves or others or \
                len(res) != LOOKUP_QUERIES:
            raise AssertionError(f"phase {phase}: lookup {label}: launches "
                                 f"{launches}, {waves} waves, "
                                 f"{len(res)} results")
        total += waves
        rec[f"{label}_s"] = round(dt, 4)
        return np.stack([res[u].answers for u in uids])

    w0 = {}
    d = ROOT / "build" / "chip_smoke_lookup_ckpt"
    shutil.rmtree(d, ignore_errors=True)
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.save_checkpoint(str(d))
        rec["save_s"] = round(time.perf_counter() - t0, 3)
        rec["checkpoint_bytes"] = dir_bytes(d)
        rec["store_bytes"] = sum(t.numel() * t.element_size()
                                 for t in eng.store.values())
        w0 = {id(eng): eng.stats.waves}
        ref = serve_all(eng, "serve")
        t0 = time.perf_counter()
        back = LookupEngine.recover(enc, directory=str(d), **kw)
        torch.cuda.synchronize()
        rec["restore_s"] = round(time.perf_counter() - t0, 3)
        if any(not torch.equal(back.store[k], eng.store[k])
               for k in eng.store):
            raise AssertionError(f"phase {phase}: the restored store differs")
        w0 = {id(back): back.stats.waves}
        if not np.array_equal(serve_all(back, "restored"), ref):
            raise AssertionError(f"phase {phase}: the restored engine's "
                                 f"answers differ")
        del back
        for label, kill in (("hedged", None), ("hedged_killed", 0)):
            h = HedgedLookup(enc, replicas=2, hedge_after=64, **kw)
            for e in h.engines:
                e.restore_checkpoint(str(d))
            w0 = {id(e): e.stats.waves for e in h.engines}
            got = serve_all(h, label, kill)
            if not np.array_equal(got, ref):
                raise AssertionError(f"phase {phase}: {label} answers differ "
                                     f"from the single engine's")
            rec[label] = {"hedged": h.hedged, "hedge_wins": h.hedge_wins,
                          "losers_cancelled": h.losers_cancelled}
            want = (0, 0) if kill is None else (LOOKUP_QUERIES // 2,) * 2
            if (h.hedged, h.hedge_wins) != want:
                raise AssertionError(f"phase {phase}: {label}: {rec[label]}")
            del h
    finally:
        shutil.rmtree(d, ignore_errors=True)
    rec["launches"] = total
    print(f"phase {phase}: LookupEngine k={LOOKUP_K}, {LOOKUP_DOCS} documents "
          f"of {LOOKUP_LEN} tokens: the checkpoint restores the store "
          f"bitwise and {LOOKUP_QUERIES} queries in waves of {LOOKUP_WAVE} "
          f"answer bitwise alike; HedgedLookup with a replica killed gives "
          f"the same answers; {json.dumps(rec)}")
    del eng
    torch.cuda.empty_cache()
    return {"name": "mass_lookup_indexed", "launches": total, "rec": rec}


# ---------------------------------------------------------------------------
# phase 47: the sharded paths, two ranks on the one card
# ---------------------------------------------------------------------------
#
# Each rank is a process that this phase spawns, on cuda:0, in a gloo group
# with CUDA tensors (NCCL refuses two ranks on one device). gloo's CUDA
# coverage is partial, and a gap can crash the process rather than raise:
# each collective the checks reach is first tried by a pair of ranks of its
# own. A check whose collective gloo cannot run on CUDA runs at world size 1
# over NCCL instead, and the phase says which. Point-to-point sends
# (GPipe's) go through host memory under gloo (``pipeline/gpipe.py``).

MULTI_RANKS = 2
MULTI_LAYERS = 2           # the train and decode slices (qwen3-0.6b)
MULTI_PIPE_LAYERS = 4      # GPipe: 2 layers a stage on 2 ranks
MULTI_DECODE_STEPS = 16
MULTI_PROMPT = 64
# the collectives each check reaches: DTensor redistributes through the
# functional collectives (all-gather to replicate a shard, reduce-scatter
# and all-reduce to settle a partial sum, all-to-all to move a shard),
# the MoE all-to-all is one, and the softmax decode step and the pipeline
# loss sum with ``dist.all_reduce``
MULTI_COLLECTIVES = ("all_reduce", "fc_all_gather", "fc_reduce_scatter",
                     "fc_all_reduce", "fc_all_to_all")
MULTI_NEEDS = {
    "train": ("fc_all_gather", "fc_reduce_scatter", "fc_all_reduce",
              "fc_all_to_all"),
    "decode": ("all_reduce", "fc_all_gather", "fc_reduce_scatter",
               "fc_all_reduce", "fc_all_to_all"),
    "moe": ("fc_all_gather", "fc_reduce_scatter", "fc_all_reduce",
            "fc_all_to_all"),
    "gpipe": ("all_reduce", "fc_all_gather", "fc_reduce_scatter",
              "fc_all_reduce"),
    "checkpoint": ("fc_all_gather",),
}


def probe_rank(rank, world, init, name, out_path):
    """One rank of a probe pair: one collective on a CUDA tensor under
    gloo; rank 0 writes "ok" or the error it raised."""
    import torch
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as fc
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    g = dist.group.WORLD
    x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
    try:
        if name == "all_reduce":
            dist.all_reduce(x.clone())
        else:
            fn = {"fc_all_gather": lambda: fc.all_gather_tensor(x, 0, g),
                  "fc_reduce_scatter": lambda: fc.reduce_scatter_tensor(
                      x, "sum", 0, g),
                  "fc_all_reduce": lambda: fc.all_reduce(x, "sum", g),
                  "fc_all_to_all": lambda: fc.all_to_all_single(
                      x, None, None, g)}[name]
            y = fn()
            if hasattr(y, "wait"):
                y = y.wait()
        torch.cuda.synchronize()
        res = "ok"
    except (RuntimeError, NotImplementedError, ValueError) as e:
        res = f"raises {type(e).__name__}: {str(e).splitlines()[0][:120]}"
    if rank == 0:
        Path(out_path).write_text(res)
    dist.destroy_process_group()


def probe_gloo_cuda() -> dict:
    """Which collectives two gloo ranks run on CUDA tensors, each tried by
    a pair of ranks of its own, all pairs at once: "ok", the error it
    raised, or the signal that ended a rank (a gap in gloo's CUDA path
    can crash the process)."""
    import shutil
    import torch.multiprocessing as mp
    ctx = mp.get_context("spawn")
    work = ROOT / "build" / "phase47_probe"
    shutil.rmtree(work, ignore_errors=True)
    procs = {}
    for name in MULTI_COLLECTIVES:
        d = work / name
        d.mkdir(parents=True)
        procs[name] = [ctx.Process(target=probe_rank, args=(
            r, MULTI_RANKS, f"file://{d}/rendezvous", name, str(d / "out")))
            for r in range(MULTI_RANKS)]
        for pr in procs[name]:
            pr.start()
    out = {}
    for name, prs in procs.items():
        for pr in prs:
            pr.join(timeout=180)
            if pr.is_alive():
                pr.kill()
                pr.join()
        codes = [pr.exitcode for pr in prs]
        res = work / name / "out"
        out[name] = (res.read_text() if res.exists() and not any(codes)
                     else f"crashes (exit codes {codes})")
    shutil.rmtree(work, ignore_errors=True)
    return out


def multi_train(dev, meshes) -> dict:
    """qwen3-0.6b at full width, MULTI_LAYERS layers, linear, bf16 compute,
    batch 2 x 256: ``lm_loss`` and every gradient leaf on each mesh
    against the one-rank run (phase 9's bf16 limits); B2/B3 launches per
    rank equal the one-rank run's."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.optim import GradAccumulator
    from repro_torch.sharding import Rules, distribute_tree, full
    from repro_torch.tree import leaves
    cfg, params0, batch = slice_model("linear", "bfloat16", dev,
                                      n_layers=MULTI_LAYERS)
    reset_launches()
    loss1, _, g1 = GradAccumulator(1).run(
        lambda p, b: lm.lm_loss(p, b, cfg), params0, batch)
    torch.cuda.synchronize()
    want = {k: n for k, n in read_launches().items() if n}
    out = {"want": want, "meshes": {}}
    for shape in meshes:
        rules = Rules.for_mesh(make_mesh(shape, ("data", "model"), device=dev.type))
        dp = distribute_tree(params0, lm.param_specs(cfg), rules)
        reset_launches()
        t0 = time.perf_counter()
        loss2, _, g2 = GradAccumulator(1).run(
            lambda p, b: lm.lm_loss(p, b, cfg, rules=rules), dp, batch)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        got = {k: n for k, n in read_launches().items() if n}
        loss2 = full(loss2)
        torch.testing.assert_close(loss2.float(), loss1.float(),
                                   rtol=BF16_SLICE_TOL["loss"], atol=0.0)
        errs = [leaf_err(full(a), b)
                for a, b in zip(leaves(g2), leaves(g1))]
        if max(errs) > BF16_SLICE_TOL["leaf"]:
            raise AssertionError(f"phase 47: mesh {shape} gradient leaf "
                                 f"normwise {max(errs):.3e}")
        if got != want:
            raise AssertionError(f"phase 47: mesh {shape} launches {got} per "
                                 f"rank, want {want}")
        shards = sum(x.to_local().nbytes for x in leaves(dp))
        out["meshes"][str(shape)] = {
            "loss": loss2.item(), "loss_one_rank": loss1.item(),
            "max_leaf_err": max(errs), "launches": got, "seconds": sec,
            "param_bytes_per_rank": shards,
            "param_bytes": sum(x.nbytes for x in leaves(params0))}
    return out


def multi_decode(dev, backend, shape) -> dict:
    """qwen3-0.6b at full width, MULTI_LAYERS layers, fp32, batch 4:
    prefill of MULTI_PROMPT tokens and MULTI_DECODE_STEPS greedy steps on
    the mesh and on one rank; the tokens identical, B1 (linear) and B10
    (softmax prefill) launches per rank equal the one-rank run's."""
    import torch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import Rules, distribute_tree, full
    cfg, params, _ = slice_model(backend, "float32", dev,
                                 n_layers=MULTI_LAYERS)
    prompt = torch.randint(0, cfg.vocab_size, (4, MULTI_PROMPT), device=dev,
                           generator=torch.Generator(device=dev).manual_seed(5))
    max_len = MULTI_PROMPT + MULTI_DECODE_STEPS

    def run(p, rules):
        with torch.no_grad():
            logits, st = lm.prefill(p, prompt, cfg, rules=rules)
            st = lm.pad_decode_state(st, cfg, max_len)
            tok, toks = full(logits).argmax(-1), []
            for i in range(MULTI_DECODE_STEPS):
                pos = torch.tensor(MULTI_PROMPT + i, dtype=torch.int32,
                                   device=dev)
                logits, st = lm.decode_step(p, st, tok, pos, cfg,
                                            rules=rules)
                tok = full(logits).argmax(-1)
                toks.append(tok)
            torch.cuda.synchronize()
            return torch.stack(toks, 1)

    reset_launches()
    ref = run(params, Rules.null())
    want = {k: n for k, n in read_launches().items() if n}
    rules = Rules.for_mesh(make_mesh(shape, ("data", "model"), device=dev.type))
    dp = distribute_tree(params, lm.param_specs(cfg), rules)
    reset_launches()
    t0 = time.perf_counter()
    got_toks = run(dp, rules)
    sec = time.perf_counter() - t0
    got = {k: n for k, n in read_launches().items() if n}
    if not torch.equal(got_toks, ref):
        raise AssertionError(f"phase 47: {backend} decode on {shape}: tokens "
                             f"differ from one rank's")
    if got != want or not got:
        raise AssertionError(f"phase 47: {backend} decode launches {got} per "
                             f"rank, want {want}")
    return {"launches": got, "seconds": sec, "tokens": ref.shape[1]}


def multi_moe(dev, shape) -> dict:
    """deepseek-moe-16b's MoE layer at full width (64 experts, top 6),
    fp32, 4 x 256 tokens, capacity factor 8 (nothing drops): the output
    and aux of ``moe_apply_shard_map`` on the mesh (the experts split
    over the model axis) against the einsum path within 1e-5, and each
    rank's routing (experts chosen for its tokens) equal to the einsum
    path's for the same tokens."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import moe as MOE
    from repro_torch.sharding import (Rules, distribute, distribute_tree,
                                      full)
    cfg = get_config("deepseek-moe-16b")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    p = MOE.moe_params(torch.Generator(device=dev).manual_seed(0), cfg)
    x = torch.randn(4, 256, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(1))
    ecfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, dispatch="einsum"))
    with torch.no_grad():
        o1, aux1 = MOE.moe_apply(p, x, ecfg)
        rules = Rules.for_mesh(make_mesh(shape, ("data", "model"), device=dev.type))
        pd = distribute_tree(p, MOE.moe_param_specs(cfg), rules)
        xd = distribute(x, rules, "batch", "seq_sp", None)
        t0 = time.perf_counter()
        # JAX's selection takes this path when the model axis (> 1)
        # divides the experts; called directly, it runs on any mesh
        o2, aux2 = MOE.moe_apply_shard_map(pd, xd, cfg, rules)
        o2, aux2 = full(o2), full(aux2)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        _, e_full, _ = MOE.route(p["router"], x.reshape(-1, cfg.d_model),
                                 cfg.moe.top_k)
        local = xd.to_local()
        _, e_loc, _ = MOE.route(p["router"], local.reshape(-1, cfg.d_model),
                                cfg.moe.top_k)
    err = leaf_err(o2, o1)
    if err > 1e-5 or abs(aux2.item() - aux1.item()) > 1e-5 * abs(aux1.item()):
        raise AssertionError(f"phase 47: MoE shard_map vs einsum normwise "
                             f"{err:.3e}, aux {aux2.item()} vs {aux1.item()}")
    # this rank's tokens: its block of (batch, seq) under the placements
    rows = torch.arange(x.shape[0] * x.shape[1], device=dev).reshape(
        x.shape[:2])
    mine = distribute(rows, rules, "batch", "seq_sp").to_local().reshape(-1)
    if not torch.equal(e_loc, e_full[mine]):
        raise AssertionError("phase 47: MoE routing differs on the mesh")
    return {"normwise": err, "aux": aux2.item(), "seconds": sec,
            "experts_per_rank": cfg.moe.n_experts // rules.model_size}


def multi_gpipe(dev) -> dict:
    """GPipe over (stage = the ranks, data 1, model 1): qwen3-0.6b at full
    width, MULTI_PIPE_LAYERS layers, linear, fp32, batch 4 x 128 in 2
    microbatches; the loss and every gradient leaf against the plain
    ``lm_loss`` (loss 1e-5 relative, leaves normwise 1e-4)."""
    import torch
    from repro_torch.models import lm
    from repro_torch.pipeline import (
        gpipe_loss_fn, make_pipeline_mesh, place_pipeline_params)
    from repro_torch.sharding import Rules, full
    from repro_torch.tree import leaves
    cfg, params0, _ = slice_model("linear", "float32", dev,
                                  n_layers=MULTI_PIPE_LAYERS)
    toks = torch.randint(0, cfg.vocab_size, (4, 129), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(2))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    flat0 = leaves(params0)
    for x in flat0:
        x.requires_grad_(True)
    loss1 = lm.lm_loss(params0, batch, cfg)[0]
    g1 = torch.autograd.grad(loss1, flat0)
    for x in flat0:
        x.requires_grad_(False)
    import torch.distributed as dist
    stages = dist.get_world_size()
    mesh = make_pipeline_mesh(stages=stages, data=1, model=1,
                              device=dev.type)
    rules = Rules.for_mesh(mesh)
    pp = place_pipeline_params(params0, cfg, rules)
    flat = leaves(pp)
    for x in flat:
        x.requires_grad_(True)
    reset_launches()
    t0 = time.perf_counter()
    loss2 = gpipe_loss_fn(cfg, rules, mesh, n_micro=2)(pp, batch)
    g2 = torch.autograd.grad(loss2, flat)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    got = {k: n for k, n in read_launches().items() if n}
    torch.testing.assert_close(loss2.detach(), loss1.detach(), rtol=1e-5,
                               atol=0.0)
    errs = [leaf_err(full(a), b) for a, b in zip(g2, g1)]
    if max(errs) > 1e-4:
        raise AssertionError(f"phase 47: GPipe gradient leaf normwise "
                             f"{max(errs):.3e}")
    # each stage runs its 2 layers on each of 2 microbatches: the forward
    # kernel twice (forward, the tick's remat recompute), B3 once
    per = MULTI_PIPE_LAYERS // stages * 2
    want = {"linear_attention_fwd": 2 * per,
            "linear_attention_bwd_dq": per, "linear_attention_bwd_dkv": per}
    if got != want:
        raise AssertionError(f"phase 47: GPipe launches {got} per rank, "
                             f"want {want}")
    return {"loss": loss2.item(), "loss_plain": loss1.item(),
            "max_leaf_err": max(errs), "launches": got, "seconds": sec,
            "stages": stages}


def multi_checkpoint(dev, workdir) -> dict:
    """qwen3-0.6b's MULTI_LAYERS-layer parameters placed on (1, 2), saved
    by ``CheckpointManager`` (the whole arrays, from rank 0) and restored
    by ``restore_on_mesh`` on (2, 1): every leaf bit for bit."""
    import torch
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager, restore_on_mesh
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import lm
    from repro_torch.sharding import Rules, distribute_tree, full
    from repro_torch.tree import leaves
    cfg, params0, _ = slice_model("linear", "float32", dev,
                                  n_layers=MULTI_LAYERS)
    specs = lm.param_specs(cfg)
    world = dist.get_world_size()
    a = distribute_tree(params0, specs, Rules.for_mesh(
        make_mesh((1, world), ("data", "model"), device=dev.type)))
    t0 = time.perf_counter()
    CheckpointManager(workdir).save(1, a, blocking=True)
    dist.barrier()
    mesh_b = make_mesh((world, 1), ("data", "model"), device=dev.type)
    b, _ = restore_on_mesh(f"{workdir}/step_1", params0, specs, mesh_b)
    same = all(torch.equal(full(x), y)
               for x, y in zip(leaves(b), leaves(params0)))
    sec = time.perf_counter() - t0
    if not same:
        raise AssertionError("phase 47: checkpoint restored on (2, 1) "
                             "differs from the arrays saved on (1, 2)")
    return {"leaves": len(leaves(b)), "seconds": sec,
            "bytes": sum(x.nbytes for x in leaves(params0))}


def multidevice_worker(rank, world, init, backend, checks, out_path,
                       workdir):
    """One rank of phase 47: joins the group, runs ``checks`` on meshes
    of ``world`` ranks and, on rank 0, writes the results. A rank that
    crashes prints its Python stack (``faulthandler``)."""
    import faulthandler
    import torch
    import torch.distributed as dist
    faulthandler.enable()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group(backend, init_method=init, rank=rank,
                            world_size=world)
    try:
        out = {}
        for check in checks:
            t0 = time.perf_counter()
            if rank == 0:
                print(f"  phase 47: {world} rank(s), {backend}: {check}",
                      flush=True)
            if check == "train":
                out[check] = multi_train(
                    dev, [(1, world), (world, 1)] if world > 1 else [(1, 1)])
            elif check == "decode":
                out[check] = {b: multi_decode(dev, b, (1, world))
                              for b in ("linear", "softmax")}
            elif check == "moe":
                out[check] = multi_moe(dev, (1, world))
            elif check == "gpipe":
                out[check] = multi_gpipe(dev)
            elif check == "checkpoint":
                out[check] = multi_checkpoint(dev, workdir)
            out[check]["world"] = world
            out[check]["backend"] = backend
            out[check + "_seconds"] = time.perf_counter() - t0
            torch.cuda.empty_cache()
        if rank == 0:
            Path(out_path).write_text(json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_ranks(world, backend, checks, tag) -> dict:
    """Spawn ``world`` ranks on the card for ``checks`` and return rank
    0's results. A rank that fails fails the phase."""
    import shutil
    import torch.multiprocessing as mp
    work = ROOT / "build" / f"phase47_{tag}"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    out_path = work / "out.json"
    mp.start_processes(
        multidevice_worker,
        args=(world, f"file://{work}/rendezvous", backend, checks,
              str(out_path), str(work / "ckpt")),
        nprocs=world, start_method="spawn")
    out = json.loads(out_path.read_text())
    shutil.rmtree(work, ignore_errors=True)
    return out


def multidevice_main_path(phase, checks=tuple(MULTI_NEEDS)) -> dict:
    """Phase 47: the sharded paths with MULTI_RANKS ranks on the one card
    (gloo, CUDA tensors); a check that reaches a collective gloo cannot
    run on CUDA runs at world size 1 over NCCL. Returns the records and
    each kernel's launches per rank."""
    t0 = time.perf_counter()
    probe = probe_gloo_cuda()
    print(f"phase {phase}: gloo on CUDA tensors, {MULTI_RANKS} ranks on "
          f"cuda:0, each collective by a pair of its own: "
          f"{json.dumps(probe)}")
    on_gloo, on_nccl = [], []
    for check in checks:
        lack = [c for c in MULTI_NEEDS[check] if probe[c] != "ok"]
        (on_nccl if lack else on_gloo).append(check)
        if lack:
            print(f"phase {phase}: {check} reaches {', '.join(lack)}, which "
                  f"gloo cannot run on CUDA tensors: it runs at world size 1 "
                  f"over NCCL")
    out = {}
    if on_gloo:
        out.update(run_ranks(MULTI_RANKS, "gloo", on_gloo, "gloo"))
    if on_nccl:
        out.update(run_ranks(1, "nccl", on_nccl, "nccl"))
    launches = {}
    tr = out.get("train")
    if tr:
        for shape, rec in tr["meshes"].items():
            print(f"phase {phase}: train step on mesh {shape} ({tr['world']} "
                  f"rank(s), {tr['backend']}): loss {rec['loss']:.6f} vs one "
                  f"rank {rec['loss_one_rank']:.6f}, every gradient leaf "
                  f"normwise <= {rec['max_leaf_err']:.3e}; launches per rank "
                  f"{rec['launches']} (one rank's); parameters "
                  f"{rec['param_bytes_per_rank']:,} B per rank of "
                  f"{rec['param_bytes']:,} B; {rec['seconds']:.2f} s")
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
    dec = out.get("decode")
    if dec:
        for backend in ("linear", "softmax"):
            rec = dec[backend]
            print(f"phase {phase}: {backend} prefill + {rec['tokens']} greedy "
                  f"steps on (1, {dec['world']}) ({dec['backend']}): tokens "
                  f"identical to one rank's; launches per rank "
                  f"{rec['launches']}; {rec['seconds']:.2f} s")
            for k, n in rec["launches"].items():
                launches[k] = launches.get(k, 0) + n
    rec = out.get("moe")
    if rec:
        print(f"phase {phase}: deepseek-moe-16b MoE layer through "
              f"moe_apply_shard_map ({rec['world']} rank(s), "
              f"{rec['backend']}), {rec['experts_per_rank']} experts a rank: "
              f"normwise {rec['normwise']:.3e} against the einsum path, "
              f"routing identical; {rec['seconds']:.2f} s")
    rec = out.get("gpipe")
    if rec:
        print(f"phase {phase}: GPipe, {rec['stages']} stage(s) over "
              f"{MULTI_PIPE_LAYERS} layers ({rec['backend']}): loss "
              f"{rec['loss']:.6f} vs plain {rec['loss_plain']:.6f}, leaves "
              f"normwise <= {rec['max_leaf_err']:.3e}; launches per rank "
              f"{rec['launches']}; {rec['seconds']:.2f} s")
        for k, n in rec["launches"].items():
            launches[k] = launches.get(k, 0) + n
    rec = out.get("checkpoint")
    if rec:
        print(f"phase {phase}: checkpoint of {rec['leaves']} leaves "
              f"({rec['bytes']:,} B) saved on (1, {rec['world']}), restored "
              f"on ({rec['world']}, 1) bit for bit ({rec['backend']}); "
              f"{rec['seconds']:.2f} s")
    print(f"phase {phase}: seconds by check "
          f"{json.dumps({c: round(out[c + '_seconds'], 1) for c in checks})}"
          f", {time.perf_counter() - t0:.1f} s with the probe and the ranks' "
          f"start")
    return {"launches": launches, "out": out, "probe": probe}


# -- phase 48: introspection on the card ------------------------------------

# the dry run's cells, full configs, in this order. The list went on
# with yi-34b:train_4k:single, qwen3-0.6b:train_4k:multi and
# qwen3-0.6b:train_4k:pipeline (70, 37 and 67 s of tracing on the card's
# host, each ok): cut from the end, so that phase 48 stays within 120 s
# (PERF.md §4)
DRYRUN_CELLS = ("qwen3-0.6b:train_4k:single", "qwen3-0.6b:prefill_32k:single",
                "qwen3-0.6b:decode_32k:single",
                "qwen3-0.6b:long_500k:single:linear",
                "zamba2-7b:decode_32k:single")
# FakeTensorMode starts the device's context by making (and freeing) a
# 4-byte CUDA tensor (torch's ``init_gpu_context``), a 512-byte block of
# the allocator; the dry run itself holds nothing on the card
CONTEXT_TOUCH_BYTES = 1024
PEAK_TOL = 0.10          # predicted against measured peak memory


def dryrun_on_card(phase) -> dict:
    """Phase 48 (a): ``python -m repro_torch.launch.dryrun`` in a
    subprocess on the ``DRYRUN_CELLS`` (fake CUDA tensors, a fake process
    group of 256 or 512 ranks): each cell ``ok``, and the subprocess's
    peak of device bytes allocated 0. Returns the cells' figures from
    their artifacts."""
    import os
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun"]
    for cell in DRYRUN_CELLS:
        cmd += ["--cell", cell]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=900)
    seconds = time.perf_counter() - t0
    lines = [line for line in res.stdout.splitlines()
             if line.startswith("[")]
    for line in lines:
        print(f"  {line}")
    peak = re.search(r"device bytes allocated: peak (\d+)", res.stdout)
    if res.returncode or len(lines) != len(DRYRUN_CELLS) or \
            any(not line.startswith("[ok") for line in lines):
        raise AssertionError(f"phase {phase}: the dry run failed (exit "
                             f"{res.returncode}):\n{res.stdout[-3000:]}\n"
                             f"{res.stderr[-3000:]}")
    if peak is None or int(peak.group(1)) > CONTEXT_TOUCH_BYTES:
        raise AssertionError(f"phase {phase}: the dry run allocated on the "
                             f"card: {peak and peak.group(0)}")
    cells = []
    for cell in DRYRUN_CELLS:
        arch, shape, mesh, *backend = cell.split(":")
        suffix = f"__{backend[0]}" if backend else ""
        art = json.loads((ROOT / "build" / "artifacts" /
                          f"{arch}__{shape}__{mesh}{suffix}.json").read_text())
        rl = art["roofline"]
        cells.append(dict(
            cell=cell, trace_s=art["t_trace_s"],
            flops_per_device=art["flops_per_device"],
            hbm_bytes_per_device=art["hbm_bytes_per_device"],
            wire_bytes=art["collectives"]["wire_bytes"],
            collectives=art["collectives"]["count"],
            peak_bytes_per_device=art["memory"]["peak_bytes_per_device"],
            t_bound_s=rl["t_bound_s"], bottleneck=rl["bottleneck"],
            kernels=art["kernels"]))
    print(f"phase {phase}: the dry run, {len(cells)} cells ok in "
          f"{seconds:.1f} s; device bytes allocated 0 after every cell, "
          f"peak {peak.group(1)} (FakeTensorMode's context touch)")
    return dict(seconds=seconds, cells=cells)


def profiled_device_ms(fn, *args) -> tuple:
    """(device ms from torch.profiler, or None when it reports none; the
    step's time between CUDA events) of one call of ``fn``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 ) as prof:
        start.record()
        fn(*args)
        end.record()
        torch.cuda.synchronize()
    rows, _ = profile_rows(prof)
    total = sum(t for t, _, _ in rows) / 1e3
    return (total or None), start.elapsed_time(end)


def predicted_against_card(name, fn, args, base, phase) -> dict:
    """Phase 48 (b) for one step: ``fn(*args)`` traced on fake copies of
    its arguments, then run for real inside ``analyze_step``. The fake
    trace's dot FLOPs, kernel FLOPs, major bytes and kernel calls must
    equal the real run's (the same program); its predicted peak
    (argument + temp + output − alias) must lie within ``PEAK_TOL`` of
    ``torch.cuda.max_memory_allocated()`` over the step less ``base``
    (what the card held before the case built its arguments); then the
    step is profiled (``profiled_device_ms``) against the roofline's
    ``t_bound``."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.launch.hlo import analyze_step
    from repro_torch.launch.roofline import RooflineTerms
    from repro_torch.tree import tree_map
    t0 = time.perf_counter()
    with FakeTensorMode() as mode:
        fake = tree_map(mode.from_tensor, tuple(args))
        _, pred = analyze_step(fn, *fake)
    t_fake = time.perf_counter() - t0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, real = analyze_step(fn, *args)
    torch.cuda.synchronize()
    measured = torch.cuda.max_memory_allocated() - base
    same = dict(
        dot_flops=(pred.dot_flops, real.dot_flops),
        kernel_flops=(pred.kernel_flops, real.kernel_flops),
        major_bytes=(pred.hbm_bytes, real.hbm_bytes),
        kernel_bytes=(pred.kernel_bytes, real.kernel_bytes),
        kernels=(pred.kernel_counts(), real.kernel_counts()))
    bad = {k: v for k, v in same.items() if v[0] != v[1]}
    if bad:
        raise AssertionError(f"phase {phase}: {name}: the fake trace and "
                             f"the run differ: {bad}")
    if {k.route for k in real.kernels} - {"kernel"} or \
            {k.route for k in pred.kernels} - {"fake"}:
        raise AssertionError(f"phase {phase}: {name}: routes "
                             f"{[k.route for k in real.kernels][:4]}")
    rel = abs(pred.peak_bytes - measured) / measured
    terms = RooflineTerms(flops_per_device=pred.flops,
                          hbm_bytes_per_device=pred.bytes,
                          wire_bytes_per_device=0.0, n_devices=1)
    device_ms, event_ms = profiled_device_ms(fn, *args)
    t_bound_ms = terms.t_bound * 1e3
    share = (lambda ms: None if not ms else t_bound_ms / ms)
    print(f"  {name}: {pred.dot_flops / 1e9:.3f} GFLOP dot + "
          f"{pred.kernel_flops / 1e9:.3f} GFLOP in {len(pred.kernels)} "
          f"kernel calls ({json.dumps(pred.kernel_counts())}), "
          f"{pred.hbm_bytes / 1e9:.3f} + {pred.kernel_bytes / 1e9:.3f} GB: "
          f"fake trace = run (traced in {t_fake:.1f} s)")
    print(f"  {name}: peak predicted {pred.peak_bytes / 2**30:.3f} GiB "
          f"(arguments {pred.argument_bytes / 2**30:.3f}, temp "
          f"{pred.temp_bytes / 2**30:.3f}, outputs "
          f"{pred.output_bytes / 2**30:.3f}, aliased "
          f"{pred.alias_bytes / 2**30:.3f}), measured "
          f"{measured / 2**30:.3f} GiB ({100 * rel:.2f}% apart)")
    print(f"  {name}: t_bound {t_bound_ms:.4f} ms ({terms.bottleneck}); "
          f"device time {'not measured' if device_ms is None else f'{device_ms:.4f} ms'}"
          f" (profiler), {event_ms:.4f} ms between CUDA events; share of "
          f"t_bound {'not measured' if device_ms is None else f'{100 * share(device_ms):.1f}%'}"
          f" of device time, {100 * share(event_ms):.1f}% of event time")
    if rel > PEAK_TOL:
        raise AssertionError(f"phase {phase}: {name}: predicted peak "
                             f"{pred.peak_bytes} B is {100 * rel:.1f}% from "
                             f"the measured {measured} B")
    return dict(step=name, dot_flops=pred.dot_flops,
                kernel_flops=pred.kernel_flops, major_bytes=pred.hbm_bytes,
                kernel_bytes=pred.kernel_bytes,
                kernels=pred.kernel_counts(),
                predicted_peak=pred.peak_bytes, measured_peak=measured,
                peak_rel=rel, t_bound_ms=t_bound_ms,
                bottleneck=terms.bottleneck, device_ms=device_ms,
                event_ms=event_ms, trace_s=t_fake)


def introspection_main_path(dev, phase) -> dict:
    """Phase 48 (b): qwen3-0.6b at full width and depth, world size 1,
    bf16 compute: the linear train step at phase 10's 8 × 1,024 (B2,
    B3), the softmax prefill at 8 × 512 (B10), the linear and gated
    decode steps at batch 8 after a 512-token prompt (B1, B7); and
    rwkv6-1.6b's prefill at 8 × 512 (B8's exclusive route). Each traced
    on fake tensors and run for real (``predicted_against_card``); every
    kernel's launch count set to 0 before and read after."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import lm
    from repro_torch.optim import adamw
    from repro_torch.runtime.steps import make_train_step

    def settle() -> int:
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        return torch.cuda.memory_allocated()

    gen = torch.Generator(device=dev).manual_seed(0)
    steps = []
    reset_launches()
    # the linear train step (phase 10's shape)
    base = settle()
    cfg = get_config("qwen3-0.6b").with_backend("linear")
    params = lm.init_params(gen, cfg)
    opt = adamw(3e-4)
    state = opt.init(params)
    batch = {k: torch.randint(0, cfg.vocab_size, (8, 1024), generator=gen,
                              device=dev) for k in ("tokens", "labels")}
    steps.append(predicted_against_card(
        "train linear 8x1024", make_train_step(cfg, opt),
        (params, state, batch), base, phase))
    del params, state, batch, opt
    # the serving steps: bf16 parameters, as serve builds them
    for backend, kind in (("softmax", "prefill"), ("linear", "decode"),
                          ("gated_linear", "decode")):
        base = settle()
        cfg = get_config("qwen3-0.6b").with_backend(backend)
        params = lm.cast_params(lm.init_params(gen, cfg), torch.bfloat16)
        prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                               device=dev)

        @torch.no_grad()
        def prefill(params, tokens, cfg=cfg):
            return lm.prefill(params, tokens, cfg)
        if kind == "prefill":
            steps.append(predicted_against_card(
                f"prefill {backend} 8x512", prefill, (params, prompt), base,
                phase))
        else:
            st = prefill(params, prompt)[1]
            tok = torch.randint(0, cfg.vocab_size, (8,), generator=gen,
                                device=dev)
            pos = torch.tensor(512, dtype=torch.int32, device=dev)

            @torch.no_grad()
            def decode(params, state, token, pos, cfg=cfg):
                return lm.decode_step(params, state, token, pos, cfg)
            steps.append(predicted_against_card(
                f"decode {backend} batch 8 at 512", decode,
                (params, st, tok, pos), base, phase))
            del st
        del params, prompt
    # rwkv6-1.6b's prefill (B8's exclusive route)
    base = settle()
    cfg = get_config("rwkv6-1.6b")
    params = lm.cast_params(lm.init_params(gen, cfg), torch.bfloat16)
    prompt = torch.randint(0, cfg.vocab_size, (8, 512), generator=gen,
                           device=dev)

    @torch.no_grad()
    def rwkv_prefill(params, tokens):
        return lm.prefill(params, tokens, cfg)
    steps.append(predicted_against_card(
        "prefill rwkv6-1.6b 8x512", rwkv_prefill, (params, prompt), base,
        phase))
    del params, prompt
    launches = {k: n for k, n in read_launches().items() if n}
    settle()
    print(f"phase {phase}: five steps, each fake trace equal to its run; "
          f"launches {json.dumps(launches)}")
    return dict(steps=steps, launches=launches)


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
    sources = [ops.SOURCE, ops.GATED_SOURCE, LU.SOURCE, LA.SOURCE,
               GL.SOURCE, FA.SOURCE]
    build.build(sources)
    ops.load()
    ops.load_gated()
    LU.load()
    LA.load()
    GL.load()
    FA.load()
    print(f"phase 1: built and loaded the kernels in "
          f"{time.perf_counter() - t0:.1f} s "
          f"(nvcc {build.BUILD_SECONDS})")
    for source in sources:     # this run's build, or the one kept
        for line in ptxas_notes(build.build_log(source) or ""):
            print(f"  {source.name}: {line}")
    # the bf16 routes of B10, B8/B9 and B2/B3 run on the tensor cores
    for source, ids in ((FA.SOURCE, "B10"), (GL.SOURCE, "B8/B9"),
                        (LA.SOURCE, "B2/B3")):
        n_hgmma = sass_count(build, source, "HGMMA")
        if not n_hgmma:
            raise AssertionError(f"phase 1: no HGMMA in {source.name}'s "
                                 f"library: {ids}'s bf16 route is not on "
                                 f"the tensor cores")
        print(f"  {source.name}: {n_hgmma} HGMMA (wgmma) instructions in "
              f"the built library (cuobjdump --dump-sass)")
    # B4/B5's even-K route copies each state by cp.async.bulk, B6's bulk
    # route in and back out, unspilled
    n_bulk = sass_count(build, LU.SOURCE, "UBLKCP")
    bulk_ops = sass_opcodes(build, LU.SOURCE, "UBLKCP")
    if not n_bulk:
        raise AssertionError("phase 1: no UBLKCP in lookup.cu's library: "
                             "B4-B6 copy no state by cp.async.bulk")
    lookup_log = build.build_log(LU.SOURCE)
    if lookup_log is None:
        raise AssertionError("phase 1: no ptxas report for lookup.cu's "
                             "library (built without its .log): remove "
                             "build/kernels and run again")
    if spills(lookup_log):
        raise AssertionError(f"phase 1: ptxas spills in lookup.cu: "
                             f"{spills(lookup_log)}")
    print(f"  {LU.SOURCE.name}: {n_bulk} UBLKCP (cp.async.bulk) "
          f"instructions in the built library ({json.dumps(bulk_ops)}), no "
          f"spill ({len(ptxas_notes(lookup_log))} ptxas lines)")
    for line in ptxas_notes(lookup_log):
        if "decode_" in line:
            print(f"  B6: {line}")
    # B1/B7 keep D²/threads floats of the state in registers per thread
    # (64 at D = 128, 32 at D = 96, 16 at D = 64): none may spill
    for source in (ops.SOURCE, ops.GATED_SOURCE):
        log = build.build_log(source)
        if log is None or spills(log):
            why = "no ptxas report" if log is None else spills(log)
            raise AssertionError(f"phase 1: {source.name}: {why}")
    print("  decode_linear.cu, decode_gated.cu: no spill at any D")
    # the D = 112 instantiations (zamba2-7b's shared attention): B1 and B7
    # on 448 threads, B10's two routes; no B10 instantiation may spill
    fa_log = build.build_log(FA.SOURCE)
    if spills(fa_log):
        raise AssertionError(f"phase 1: flash_attention.cu spills: "
                             f"{spills(fa_log)}")
    for source in (ops.SOURCE, ops.GATED_SOURCE, FA.SOURCE, LA.SOURCE,
                   GL.SOURCE):
        notes = [line for line in ptxas_notes(build.build_log(source))
                 if re.search(r"Li112[E>]", line.split(":")[0])]
        if not notes:
            raise AssertionError(f"phase 1: {source.name}: no D = 112 "
                                 f"instantiation in the ptxas report")
        for line in notes:
            print(f"  D = 112: {line}")
    print("  flash_attention.cu: no spill at any D")
    # the exclusive backward (RWKV-6's training): its bf16 launches at
    # every D (at D <= 64 two rows a block, exclusive_d*_tc), registers,
    # spills and serialized wgmmas; none may spill at D <= 64
    notes = [line for line in ptxas_notes(build.build_log(GL.SOURCE))
             if re.search(r"decay_sweep_d(q|kv)_tc<Li\d+ELb1>|"
                          r"exclusive_d(q|kv)_tc<Li\d+>",
                          line.split(":")[0])]
    pair = [line for line in notes if line.startswith("exclusive_d")]
    if not notes or len({line.split(":")[0] for line in pair}) != 4:
        raise AssertionError("phase 1: gated_linear_attention.cu: the "
                             "exclusive backward's launches at D = 16 and "
                             f"64 are not all in the ptxas report: {notes}")
    for line in notes:
        print(f"  exclusive backward: {line}")
    bad = spills("\n".join(pair))
    if bad:
        raise AssertionError(f"phase 1: the exclusive backward spills at "
                             f"D <= 64: {bad}")
    for source in (LA.SOURCE, GL.SOURCE):
        print(f"  {source.name}: spills "
              f"{spills(build.build_log(source)) or 'none'}")
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
    # the stream path's recurrent ingest: 64-token chunks, rows of 0 to 64
    for normalize in (False, True):
        check_decode_linear(128, 128, 64, normalize, True, gen, dev)
    # phase 24's rows (batch 4 x 64 heads) and qwen3-moe-235b-a22b's at
    # batch 8 (8 x 64), in both input types
    for n in (256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            for normalize in (False, True):
                check_decode_linear(n, 128, 1, normalize, False, gen, dev,
                                    dtype=dtype)
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
        for decay in ("mild", "scalar", "strong", "zero"):  # stream ingest
            check_decode_gated(128, 128, 64, dtype, True, decay, gen, dev)
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
    check_lookup_indexed(512, 64, 4, 256, None, gen, dev)  # K = 256: ring
    check_lookup_indexed(64, 16, 130, 64, 128, gen, dev)   # M-tile loop
    check_lookup_indexed(64, 16, 130, 256, 128, gen, dev)  # ring per tile
    check_lookup_indexed(64, 32, 3, 66, None, gen, dev)    # K % 4 == 2
    check_lookup_indexed(256, 64, 3, 33, None, gen, dev)   # odd K: direct
    check_lookup_indexed(256, 64, 1, 33, None, gen, dev)
    for kd in (64, 100, 256, 33):
        err = check_mass_lookup(64, 4, kd, gen, dev)
        if kd == 100:
            errs["mass_lookup"] = err
    for kd in (64, 256, 33):
        check_lookup_nan_rows(kd, gen, dev)
    # B6 on both routes: the paper's width, the LM's decode shape, a state
    # larger than a block holds (direct), rows of 200 bytes (bulk, copies
    # of two rows) and an odd Dk·Dv (direct)
    for dk, dv in ((64, 64), (100, 48), (100, 100), (128, 128), (256, 256),
                   (36, 50), (33, 17)):
        for dtype in (torch.float32, torch.bfloat16):
            err = check_fused_decode(256, dk, dv, dtype, gen, dev)
            if (dk, dv, dtype) == (100, 100, torch.float32):
                errs["fused_decode"] = err      # the timed shape
    print(f"phase 2: mass_lookup_indexed, mass_lookup and fused_decode "
          f"agree with their plain versions (o rtol/atol {LOOKUP_TOL}, "
          f"non-symmetric states; fused_decode's state bitwise; rows "
          f"outside the store NaN)")
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
    # kv heads, T = S = 512, bf16), the training path's (the same rows at
    # T = S = 1024, phase 18's lse forward), the prefill shape with K/V of
    # 16 heads, then each D the kernel takes on both routes with ragged T,
    # t_off < S - T and s_real < S, grouped (Hkv < H) and one to one, and
    # the wrapper's padding
    errs["flash_attention_fwd"] = check_flash_attention(
        128, 512, 512, 128, torch.bfloat16, gen, dev, kv_heads=8, heads=16)
    check_flash_attention(128, 1024, 1024, 128, torch.bfloat16, gen, dev,
                          kv_heads=8, heads=16)
    check_flash_attention(128, 512, 512, 128, torch.bfloat16, gen, dev)
    # 64 q heads over 8 kv heads (llama-3.2-vision-90b, phase 24's
    # prefill at batch 4) and over 4 (qwen3-moe-235b-a22b): GQA groups of
    # 8 and 16; deepseek-moe-16b's 16 over 16 is the one-to-one check
    # above
    for hkv in (8, 4):
        check_flash_attention(256, 512, 512, 128, torch.bfloat16, gen, dev,
                              kv_heads=hkv, heads=64)
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
    dense_kernel_checks(gen, dev)
    training_kernel_checks(gen, dev)
    zamba2_kernel_checks(gen, dev)
    errs.update(training_kernel_checks_112_and_exclusive(gen, dev))
    done(2, t0)

    # -- 3. the linear slice, kernel vs plain recurrence, fp32 -------------
    t0 = time.perf_counter()
    generate_kernel_vs_reference(full_width("qwen3-0.6b", "linear", 2), dev,
                                 3)
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
    print_lookup_times(times)
    replaces = {"mass_lookup_indexed": 69, "mass_lookup": 41,
                "fused_decode": 116}
    for name, line in replaces.items():
        t = times[name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/lookup/csrc/lookup.cu",
            "replaces": f"src/repro/kernels/lookup/kernel.py:{line}",
            "launches": main6["launches"][name],
            "launches_by_path": {"lookup": main6["launches"][name]},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    del main6, engine, times
    torch.cuda.empty_cache()
    done(6, t0)

    # -- 7. the gated slice, kernel vs plain recurrence, fp32 --------------
    t0 = time.perf_counter()
    generate_kernel_vs_reference(
        full_width("qwen3-0.6b", "gated_linear", 2), dev, 7)
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

    # -- 15. the engine slice, kernel engine vs reference engine, fp32 -----
    t0 = time.perf_counter()
    for backend in ("linear", "gated_linear", "softmax"):
        for workload in ENGINE_SLICE_WORKLOADS:
            engine_slice(backend, dev, 15, *workload)
    torch.cuda.empty_cache()
    done(15, t0)

    # -- 16. the stream main path ------------------------------------------
    t0 = time.perf_counter()
    from repro_torch.launch import serve
    stream = {serve.STREAM_KERNELS[b][0]: stream_main_path(
        b, dev, 16, n_layers=SERVE_TIME_LAYERS)
        for b in ("linear", "gated_linear", "softmax")}
    done(16, t0)

    # -- 17. the softmax training slice, B10 vs plain, fp32 and bf16 -------
    t0 = time.perf_counter()
    training_slice("softmax", dev, 17)
    training_slice_bf16("softmax", dev, 17)
    torch.cuda.empty_cache()
    done(17, t0)

    # -- 18. the softmax training main path ----------------------------------
    t0 = time.perf_counter()
    train = {"flash_attention_fwd": training_main_path("softmax", dev, gen,
                                                       18)}
    done(18, t0)

    # -- 19. the retrieve main path -------------------------------------------
    t0 = time.perf_counter()
    retrieve_main_path(dev, 19)
    done(19, t0)

    # -- 20. the MoE slice: one layer vs its oracle, kernels vs reference --
    t0 = time.perf_counter()
    for arch, n_layers in (("deepseek-moe-16b", 2),
                           ("qwen3-moe-235b-a22b", 1)):
        moe_layer_checks(arch, dev, 20)
        for backend in ("linear", "gated_linear", "softmax"):
            generate_kernel_vs_reference(full_width(arch, backend, n_layers),
                                         dev, 20)
    done(20, t0)

    # -- 21. the MoE generate main path ------------------------------------
    t0 = time.perf_counter()
    moe_decode = moe_generate_main_path(dev, 21)
    done(21, t0)

    # -- 22. MoE training: the slice, kernels vs plain, then the loop ------
    t0 = time.perf_counter()
    training_slice("linear", dev, 22, arch="deepseek-moe-16b", seq=512)
    training_slice_bf16("linear", dev, 22, arch="deepseek-moe-16b", seq=512)
    torch.cuda.empty_cache()
    train_moe = moe_training_main_path(dev, 22)
    done(22, t0)

    # -- 23. the cross slice: kernels vs reference, the paper's identity ---
    t0 = time.perf_counter()
    cross_slice(dev, 23)
    done(23, t0)

    # -- 24. the vision generate main path ---------------------------------
    t0 = time.perf_counter()
    vision = vision_generate_main_path(dev, 24)
    done(24, t0)

    # -- 25. the dense slice: kernels vs reference, every backend ----------
    t0 = time.perf_counter()
    for arch in DENSE_ARCHS:
        for backend in ("linear", "gated_linear", "softmax"):
            generate_kernel_vs_reference(full_width(arch, backend, 2), dev,
                                         25)
    done(25, t0)

    # -- 26. the dense generate main path ----------------------------------
    t0 = time.perf_counter()
    dense, dense_times = {}, {}
    for arch, backends in DENSE_RUNS:
        for backend in backends:
            dense[arch, backend] = dense_generate_main_path(arch, backend,
                                                            dev, 26)
        for name, rec in dense_kernel_times(arch, backends, gen,
                                            dev).items():
            dense_times.setdefault(name, []).append(rec)
    sizes = dense[("yi-34b", "linear")]["sizes"]
    print(f"phase 26: yi-34b at batch 8: linear state "
          f"{sizes['linear']:.2f} MiB (s and z; s alone "
          f"{sizes['gated_linear']:.2f}) against a KV cache of 576 rows "
          f"{sizes['softmax']:.2f} MiB; under 56 heads over 8 the "
          f"fixed-size state is the larger until the cache holds "
          f"{sizes['crossover_rows']:.1f} rows "
          f"({sizes['crossover_rows_s_only']:.1f} without z)")
    done(26, t0)

    # -- 27. the dense stream path ------------------------------------------
    t0 = time.perf_counter()
    stream_dense = stream_main_path("linear", dev, 27, arch="musicgen-large",
                                    n_layers=DENSE_STREAM_LAYERS)
    done(27, t0)

    # -- 28. the dense training slices, kernels vs plain, fp32 and bf16 -----
    t0 = time.perf_counter()
    for arch in DENSE_TRAIN_ARCHS:
        for backend in ("linear", "gated_linear"):
            training_slice(backend, dev, 28, arch=arch)
            training_slice_bf16(backend, dev, 28, arch=arch)
    torch.cuda.empty_cache()
    done(28, t0)

    # -- 29. the dense training main path -----------------------------------
    t0 = time.perf_counter()
    train_dense = [dense_training_main_path(arch, backend, dev, gen, 29)
                   for arch in DENSE_TRAIN_ARCHS
                   for backend in ("linear", "gated_linear")]
    done(29, t0)

    # -- 30. the rwkv6 slice, B8's exclusive route vs plain, fp32 -----------
    t0 = time.perf_counter()
    rwkv6_slice(dev, 30)
    done(30, t0)

    # -- 31. the rwkv6 generate main path -----------------------------------
    t0 = time.perf_counter()
    rwkv_gen = rwkv6_generate_main_path(dev, gen, 31)
    done(31, t0)

    # -- 32. the rwkv6 stream path ------------------------------------------
    t0 = time.perf_counter()
    rwkv_stream = stream_main_path(None, dev, 32, arch=RWKV_ARCH)
    done(32, t0)

    # -- 33. the zamba2 and feature-gate slices: kernels vs reference ------
    t0 = time.perf_counter()
    for backend in ("linear", "gated_linear", "softmax"):
        generate_kernel_vs_reference(zamba2_unit(backend), dev, 33)
    for backend in ("linear", "gated_linear"):
        generate_kernel_vs_reference(dataclasses.replace(
            full_width("qwen3-0.6b", backend, 2), feature_gate=True), dev, 33)
    done(33, t0)

    # -- 34. the zamba2 generate main path ---------------------------------
    t0 = time.perf_counter()
    zamba_gen = {b: zamba2_generate_main_path(b, dev, 34)
                 for b in ("linear", "gated_linear", "softmax")}
    zamba_times = zamba2_kernel_times(gen, dev)
    done(34, t0)

    # -- 35. the zamba2 stream path ------------------------------------------
    t0 = time.perf_counter()
    zamba_stream = zamba2_stream_main_path(dev, 35)
    done(35, t0)

    # -- 36. the zamba2 and rwkv6 training slices, kernels vs plain ---------
    t0 = time.perf_counter()
    for arch, backends, n_layers in (
            (ZAMBA_ARCH, ("linear", "gated_linear", "softmax"), 6),
            (RWKV_ARCH, ("gated_linear",), 2)):
        for backend in backends:
            for dtype in ("float32", "bfloat16"):
                pinned_training_slice(backend, dev, 36, arch, n_layers,
                                      dtype)
    done(36, t0)

    # -- 37. the zamba2 training main path -----------------------------------
    t0 = time.perf_counter()
    train_zamba = {b: cut_training_main_path(ZAMBA_ARCH, b, dev, 37)
                   for b in ("linear", "gated_linear", "softmax")}
    done(37, t0)

    # -- 38. the rwkv6 training main path; the kernels at the training shapes
    t0 = time.perf_counter()
    train_rwkv = cut_training_main_path(RWKV_ARCH, None, dev, 38)
    train_shapes, rwkv_fwd_shape, excl_times = \
        zamba2_rwkv6_training_kernel_times(gen, dev)
    for name in EXCLUSIVE_KERNELS[1:]:
        t = excl_times[name]
        records.append({
            "name": name, "route": "cuda",
            "source": "src/repro_torch/kernels/gated_linear_attention/csrc/"
                      "gated_linear_attention.cu",
            "replaces": "src/repro/core/gated.py:156",
            "note": "no Pallas original: JAX trains RWKV-6 through jnp "
                    "autodiff of chunked_gla(exclusive=True, u)",
            "launches": train_rwkv["launches"][name],
            "launches_by_path": {"train_rwkv6": train_rwkv["launches"][name]},
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": None,
            "kernel": "exclusive_d" + ("q" if name.endswith("dq") else "kv")
                      + "_tc<64> (two rows a block, bf16 tensor cores)"})
    done(38, t0)

    # -- 39. the paper's QA: card vs CPU, the Figure-1 sweep, n = 748 -------
    t0 = time.perf_counter()
    qa_parity(dev, 39)
    qa_figure1(dev, 39)
    qa_paper_length(dev, 39)
    done(39, t0)

    # -- 40. checkpointed, resumable training through launch/train.py -------
    t0 = time.perf_counter()
    train_ckpt = checkpoint_main_path(dev, 40)
    done(40, t0)

    # -- 41. the spec slice: kernel engine vs reference engine, fp32 --------
    t0 = time.perf_counter()
    for backend in ("linear", "gated_linear", "softmax"):
        spec_slice(backend, dev, 41)
    torch.cuda.empty_cache()
    done(41, t0)

    # -- 42. serve --mode spec at full depth, fp32, every draft -------------
    t0 = time.perf_counter()
    spec_runs = [spec_main_path(backend, draft, dev, 42)
                 for backend, draft in SPEC_RUNS]
    done(42, t0)

    # -- 43. the engine's lifecycle at full depth, fp32 ---------------------
    t0 = time.perf_counter()
    life_runs = [lifecycle_main_path(backend, dev, 43)
                 for backend in ("linear", "softmax")]
    done(43, t0)

    # -- 44. the prefix cache and fork at full depth, fp32; the fork CLI ----
    t0 = time.perf_counter()
    prefix_runs = [prefix_cache_main_path(backend, dev, 44)
                   for backend in ("linear", "softmax")]
    prefix_runs.append(prefix_fork_cli(dev, 44))
    done(44, t0)

    # -- 45. engine durability at full depth, fp32; the crash/recover CLI ---
    t0 = time.perf_counter()
    durable_runs = [durability_main_path(backend, dev, 45)
                    for backend in ("linear", "softmax")]
    durable_runs.append(durability_cli(dev, 45))
    done(45, t0)

    # -- 46. the fleet with failover, the fleet CLI, lookup checkpoints and
    # HedgedLookup -------------------------------------------------------
    t0 = time.perf_counter()
    fleet_run = fleet_main_path(dev, 46)
    fleet_runs = [{"name": k, "launches": n}
                  for k, n in fleet_run["launches"].items()]
    fleet_runs.append(fleet_cli(dev, 46))
    lookup_ckpt = lookup_durability_main_path(dev, 46)
    done(46, t0)

    # -- 47. the sharded paths: two ranks on the card (gloo, CUDA tensors) --
    t0 = time.perf_counter()
    multi = multidevice_main_path(47)
    done(47, t0)

    # -- 48. introspection: the dry run, and its prediction held against
    # the card ------------------------------------------------------------
    t0 = time.perf_counter()
    dry = dryrun_on_card(48)
    intro = introspection_main_path(dev, 48)
    done(48, t0)
    print(f"phase 48: {json.dumps({'dryrun': dry, 'steps': intro['steps']})}")

    for r in records:
        r["max_abs_err"] = errs[r["name"]]
        if r["name"] in stream:   # B1/B7: generate, stream; B10: and train
            r["launches_by_path"] = {"generate": r["launches"],
                                     "stream": stream[r["name"]]}
            if r["name"] in train:
                r["launches_by_path"]["train"] = train[r["name"]]
            r["launches"] = sum(r["launches_by_path"].values())
    # the paths of phases 21, 22 and 24 (B2/B3's first path: phase 10's)
    more = {"decode_linear": {"generate_moe": moe_decode,
                              "generate_vision": vision["decode_linear"]},
            "flash_attention_fwd": {
                "generate_vision": vision["flash_attention_fwd"]}}
    more.update({name: {"train_moe": n} for name, n in train_moe.items()})
    # phases 26 and 27
    for (arch, backend), run in dense.items():
        path = more.setdefault(run["name"], {})
        path["generate_dense"] = path.get("generate_dense", 0) + \
            run["launches"]
    more["decode_linear"]["stream_dense"] = stream_dense
    # phases 29, 31 and 32
    for run in train_dense:
        for name, n in run["launches"].items():
            path = more.setdefault(name, {})
            path["train_dense"] = path.get("train_dense", 0) + n
        for name, rec in run["shapes"].items():
            dense_times.setdefault(name, []).append(rec)
    more.setdefault("gated_linear_attention_fwd", {}).update(
        generate_rwkv6=rwkv_gen["launches"], stream_rwkv6=rwkv_stream)
    dense_times.setdefault("gated_linear_attention_fwd", []).append(
        rwkv_gen["shape"])
    # phases 34 and 35
    for run in zamba_gen.values():
        for name, n in run["launches"].items():
            path = more.setdefault(name, {})
            path["generate_zamba2"] = path.get("generate_zamba2", 0) + n
    for name, n in zamba_stream.items():
        more.setdefault(name, {})["stream_zamba2"] = n
    for name, rec in zamba_times.items():
        dense_times.setdefault(name, []).append(rec)
    # phases 37 and 38
    for run in train_zamba.values():
        for name, n in run["launches"].items():
            path = more.setdefault(name, {})
            path["train_zamba2"] = path.get("train_zamba2", 0) + n
    more.setdefault("gated_linear_attention_fwd", {})["train_rwkv6"] = \
        train_rwkv["launches"]["gated_linear_attention_fwd"]
    for name, rec in train_shapes.items():
        dense_times.setdefault(name, []).append(rec)
    # phase 40
    for name, n in train_ckpt["launches"].items():
        more.setdefault(name, {})["train_ckpt"] = n
    # phases 42 and 43
    for run in spec_runs:
        path = more.setdefault(run["name"], {})
        path["spec"] = path.get("spec", 0) + run["launches"]
    for run in life_runs:
        more.setdefault(run["name"], {})["lifecycle"] = run["launches"]
    # phase 44
    for run in prefix_runs:
        path = more.setdefault(run["name"], {})
        path["prefix_cache"] = path.get("prefix_cache", 0) + run["launches"]
    # phase 47: rank 0's launches (each rank launches the same)
    for name, n in multi["launches"].items():
        more.setdefault(name, {})["multidevice_per_rank"] = n
    # phase 48: the five steps' real runs and their profiles
    for name, n in intro["launches"].items():
        more.setdefault(name, {})["introspection"] = n
    # phases 45 and 46
    for label, runs in (("durability", durable_runs), ("fleet", fleet_runs),
                        ("lookup_durability", [lookup_ckpt])):
        for run in runs:
            path = more.setdefault(run["name"], {})
            path[label] = path.get(label, 0) + run["launches"]
    dense_times["gated_linear_attention_fwd"].append(rwkv_fwd_shape)
    for r in records:
        if r["name"] in more:
            r.setdefault("launches_by_path", {"train": r["launches"]})
            r["launches_by_path"].update(more[r["name"]])
            r["launches"] = sum(r["launches_by_path"].values())
        if r["name"] in dense_times:    # the dense family's shapes
            r["dense_shapes"] = dense_times[r["name"]]
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
