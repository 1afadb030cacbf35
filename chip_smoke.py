#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failed check raises; nothing is caught):

1. Report: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build every kernel of the paths from ``ops/csrc`` (one
   ``nvcc`` per source, all started together) and print the build
   seconds and ``ptxas -v``.
   The TMA/wgmma kernels, the forward and the backward's dQ and dK/dV
   (D=64 and 128 each), must show no spill, no local memory and no
   wgmma serialization warning; their registers at launch, the
   ``setmaxnreg`` of each warpgroup role (from the SASS) and their
   shared memory are printed.  The paged kernels (``rpa_mma`` over bf16,
   int8 and e4m3 pages and ``rpa_combine``, D=64 and 128) and the
   quantization kernels (``quant_ring``, ``quant_kernel`` and
   ``dequant_kernel`` over bf16, fp16 and fp32) must show no spill and
   no local memory.
2. Kernel against plain: the flash-attention forward kernel against its
   plain PyTorch version on the card, in bf16 at the serving shape, the
   training shape (B 4, H 32/4, S 2048, D 64, causal) and three more,
   plus an fp32 case; ``o`` and ``lse`` both compared.  Times the kernel
   (with its TFLOP/s), the plain version and, as a yardstick the port
   never calls, ``scaled_dot_product_attention``.
3. The v1 slice: ``init_inference`` on ``llama3-8b`` at full width and
   depth, bf16, random seeded weights made on the card; greedy
   ``generate`` of 4 prompts x 1000 tokens + 64 new tokens twice
   (identical tokens), and a sampled one.  Every ``generate`` must launch
   the flash kernel exactly once per layer.
4. v1 end to end against the CPU: the same engine at full width with 2
   layers in fp32 (TF32 off), one set of weights made as a flax-layout
   tree and passed through the weight bridge; prefill logits on the card
   against the port on the CPU.
5. Paged kernels against plain: ragged paged attention over bf16, int8
   and e4m3 pages (kernels #9 and #8) against their plain versions at
   the v2 path's shapes (decode, mixed decode + prefill chunk, a
   few-sequence decode of 2 x 2048 keys, a long decode of 16 x 8192,
   sliding window, page-table holes, D=64; speculation's verify tick,
   the draft's decode, its two-row first step and its catch-up chunk,
   and a ``kv_len`` past the page table) and an fp32 case; two decode
   calls bit-identical.  Times the kernels on the device (20 calls in a
   CUDA graph, replayed) beside the wrapper's host loop and the bound at
   the four decode and mixed shapes, the verify tick and the draft's
   three shapes, and the plain versions at decode, mixed and verify.
   Then both with the long-context scan's incoming carry (B4b) at its
   shapes, a 4096-key table whose columns 1-52 are parked holes: a
   decode row, a 64-token prefill page (one split: the carry alone sends
   it through ``rpa_combine``) and 4 ragged decode rows with their own
   holes, each with the neutral carry (bit-identical to no carry) and a
   random one from ``staged_attend_stats``, bf16 queries over bf16, int8
   and e4m3 pages and fp32 over fp32, int8 and e4m3; the random carry's
   bf16 decode and prefill cases timed beside their bound.
6. The v2 slice: ``RaggedInferenceEngineV2`` on ``llama3-8b`` at full
   width and depth, bf16, serving 24 requests (16 slots) twice with
   identical tokens, eager and unpipelined (phase 14's reference); the paged kernel launched once per layer per model
   tick and the flash kernel never; then a tight pool that must evict,
   and int8 and fp8 pools that must launch kernel #8.  The allocator's
   audit is clean after every run.
7. v2 end to end against the CPU: 2 layers at full width in fp32 through
   the same bridged weights; 4 greedy requests on the card and on the
   CPU, over an fp32 pool and then an int8 pool, give the same tokens (a
   token may differ only where the CPU's top-2 logit margin is under
   1e-3).
8. Training kernels against plain: the flash-attention backward (dQ and
   dK/dV kernels) in bf16 at the training shape (B 4, H 32/4, S 2048,
   D 64, causal) and at D 128 with GQA 32/8 (S 1000, a tail; Sk > S;
   rows that see no key), plus fp32, with the forward's ``o`` and ``lse``
   checked at each of these shapes too, and two backward calls at the
   training shape bit-identical; fused Adam (L2 and AdamW) and Lion
   over flat buffers of ``llama-1b``'s parameter count.  Times each
   kernel, its plain version, its bound and, as yardsticks the port never
   calls, the SDPA backward (its fastest backend, named) and
   ``torch.optim.AdamW(fused=True).step``.
9. The training slice: ``initialize`` on ``llama-1b`` (TinyLlama shape)
   at full width and depth, bf16 with fp32 master weights, fused AdamW,
   WarmupLR, clipping 1.0, micro-batch 4 x 2048 tokens, 2 accumulation
   steps; 10 ``train_batch`` steps on one seeded batch (the loss must be
   finite and fall), then 3 fused-Lion steps on a second engine.  Every
   step launches dQ and dK/dV 22 x 2 times, the flash forward 22 x 2 x 2
   times (remat recomputes it) and the optimizer kernel once.
10. Training against the CPU: ``llama-1b`` at full width with 2 layers in
   fp32 (TF32 off), weights made as a flax-layout tree and bridged; 3
   steps on the card against 3 on the CPU.  Then ``save_checkpoint``, 2
   more steps, and a fresh engine that ``load_checkpoint``s and takes the
   same 2 steps: bit-identical losses and params on the card.
11. Quantization kernels against plain: group-wise int8 quantize and
   dequantize (kernels #6 and #7) at the int8 serving path's shapes
   (``gate_proj`` [4096, 14336] at groups of 128 and 2048, the embedding
   [128256, 4096]), at groups of 32 and 64, in fp16, at a ZeRO++-like
   flat shard of 2^26 values at groups of 2048 (fp32 8-bit, bf16 4-bit)
   and at tails, symmetric and asymmetric, 8 and 4 bits, bf16 and fp32:
   payload, scale, offset and dequantized output bit-identical to the
   plain versions.  Times both kernels on the device (20 calls in a CUDA
   graph, replayed) at ``gate_proj`` and the flat shard, beside the
   wrapper's host loop, their plain versions and their byte bounds.
12. The int8 slice: (a) ``init_inference`` on ``llama3-8b`` at full width
   and depth with ``quant.enabled`` int8 (groups of 128), phase 3's
   prompts greedy twice (identical tokens); kernel #6 launched 226 times
   at construction, #7 226 times per forward, flash once per layer per
   prefill.  (b) ``RaggedInferenceEngineV2`` with
   ``quantize_weights="int8"`` (groups of 2048) serving phase 6's 24
   requests twice (identical tokens); #7 226 times per model tick.
   Resident weight bytes and peak memory while serving beside the bf16
   runs'.  (c) 1 layer at full width in fp32: weights quantized on the
   card and on the CPU are byte-identical, and 4 greedy v2 requests give
   the same tokens (the margin rule of phase 7); the CPU's half runs in a
   worker process beside phases 13-21 and is compared in phase 22.

13. ZeRO across ranks: ``init_distributed(dist_backend="nccl")`` (one
   rank: NCCL puts one rank on each card, and the run needs one card),
   then ``initialize`` at ``zero_optimization.stage`` 1, 2 and 3 on
   ``llama-1b`` at full width and depth, 3 AdamW steps each on phase 9's
   seed and batch, losses within rtol 2e-3 of phase 9's stage 0 (the
   reference's ``tests/unit/test_engine.py:55`` bound); 2 Lion steps at
   stage 2 against phase 9's Lion.  Every step launches the fused
   optimizer exactly once and issues exactly the plan's collectives
   (``comms_logger`` counts against ``plan.step_collectives``).  Step ms
   and peak GiB per stage (of the init and of the steps).  Every one of
   those collectives goes through the NCCL group (``comm.backend_calls``),
   a world of one's too: none is a local copy.  Then a stage-3 engine's
   partitioned checkpoint after a step, at full width and 2 of the 22
   layers (``build/smoke_zero_ckpt``, removed afterwards): save, 2 more
   steps, and a fresh engine that loads and retakes them,
   bit-identically.
14. CUDA graphs and the pipelined host path: phase 6's 24 requests on
   ``llama3-8b`` again with ``enable_cuda_graph`` and the pipeline on,
   then graphs with the pipeline off and the pipeline without graphs;
   phase 12's int8 v2 traffic with graphs and the pipeline; phase 3's v1
   prompts (4 x 1000 + 64) with the decode step replayed, then v1 at
   prompts of 500, 1500 and 1000 in turn (each a recapture, against an
   eager engine of the same call).  Every request's tokens equal the
   eager unpipelined run's (phases 3, 6 and 12; sampled v1 too where
   torch registers a generator with a graph).
   The paged kernel's and the dequantize's Python counters tick at
   warm-ups and captures only: each is held equal to its launches per
   tick x (eager ticks + 2 K x captures), from the engine's
   ``graph_captures`` and ``graph_replays``; the device's launches are
   derived from those (the counters never see a replay), not traced.
   Printed beside the eager runs of the same call: decode tokens/s in
   decode blocks, blocking fetches per block and ``host_bound_fraction``
   in blocks; v1 decode tokens/s; peak memory with graphs and without;
   capture and recapture seconds.

15. GPT-2's kernel shapes (``models/gpt2.py``, the model of the JAX
   package's benchmark matrix): the flash forward in bf16 at B 64 H 12/12
   S 128 (v1 prefill), B 12 H 12/12 S 1024 (config 1) and B 4 H 32/32
   S 1024 (config 2), D 64, causal, q, k and v strided views of one
   ``[B, S, 3E]`` ``c_attn`` output; dQ and dK/dV at the two training
   shapes; each against its plain version at phase 2's and phase 8's
   limits and timed beside its bound and SDPA's forward or backward;
   fused AdamW over each configuration's parameters; quantize and
   dequantize at ``c_fc`` and the tied table, groups of 128.
16. v1 GPT-2: ``gpt2-125m`` (``n_positions`` 1024, bf16, flash) at the
   reference's inference shape (``bench.py:485-500``: 64 prompts x 128
   + 128 new): greedy twice, sampled, ``generate_async`` and the same
   module graphed (greedy twice, sampled), all tokens equal, the flash
   kernel once per layer per ``generate``; decode tokens/s, prefill ms,
   peak GiB and ``host_bound_fraction`` eager and graphed.  Then
   ``gpt2-1.3b`` at 4 x 900 + 64 the same way, and ``gpt2-125m`` with
   int8 weights (groups of 128): 50 quantize launches at build, 51
   dequantize a forward (the tied table twice), tokens against bf16's.
17. GPT-2 training, ``bench.py``'s configs: 1, ``gpt2-125m`` at ZeRO 0,
   fused AdamW (lr 1e-4, wd 0.01), micro 12 x 1024, remat off, 10 steps
   on one seeded batch, the loss falling; 2, ``gpt2-1.3b`` at ZeRO 2 over
   one NCCL rank, FusedAdam, micro 4 x 1024, ``dots_saveable``, 5 steps.
   Step ms, tokens/s, MFU and peak GiB; launches held every step (config
   1: 12 forward, 12 dQ, 12 dK/dV, 1 Adam; config 2: 48, 24, 24, 1).
   Config 2 one step under ``full`` and under ``none``: its peak lies
   between theirs, the losses within phase 13's limit; its ZeRO-2
   checkpoint after a step at 2 of its 24 layers
   (``build/smoke_gpt2_ckpt``, removed afterwards): save, 2 steps, load,
   the same 2 steps bit-identically.
18. GPT-2 against the CPU: ``gpt2-125m`` at full width with 2 layers in
   fp32 (TF32 off), one flax-layout tree through the bridge: prefill
   logits through v1, and one training step's loss and gradients, on
   the card against the port on the CPU.

19. KV tiering and the prefix cache on ``llama3-8b`` at full width and
   8 of its 32 layers, bf16, with CUDA graphs as in phase 14.  Tiering:
   phase 6's tight pool (129 pages) under its 16 x (100 + 500) traffic,
   with a host
   tier of 8 pages (pinned) that overflows to an NVMe tier of 128 pages
   (``build/smoke_kvtier``, removed afterwards), on a bf16 pool (#9) and
   an int8 pool (#8), pipeline on and off (the same tokens), beside an
   evicting run (bf16 pool) with graphs and the pipeline: sequences
   spill, the host tier demotes to NVMe, every restored page is
   digest-verified and
   read back from the pool equal to the bytes spilled, the NVMe tier
   never fails; spills, restores, evictions, re-prefilled tokens
   avoided, copy and digest ms a page, wall and decode tokens/s against
   the evicting run.  The prefix cache: 24 requests on one 1024-token
   prefix (request 0 first, then 23, one of them the prefix alone: a
   full match and a COW), cache on with the pipeline on and off (the
   same tokens and counters) and off: hits, prefill tokens computed and
   cached, TTFT p50/p99 with and without.  Then a second tenant's prefix
   in a 65-page pool with tiering: the first prefix's index pages
   demote into the tiers and revive for its later requests.  #9 and #8
   launched under spilled, restored and shared pages.

20. Speculative decoding (A9.4) on ``llama3-8b`` at full width and
   SPEC_LAYERS of its 32 layers (the runs check tokens, launches and
   the pipeline, the same at any depth), bf16, phase 6's
   engine with CUDA graphs and the pipeline, phase
   6's prompts and budgets: n-gram drafting (k 4), greedy, twice
   identical, equal with the pipeline off and eager, and how many of the
   24 equal speculation off's (run in the same call) with the first
   divergence; sampled (t 0.8, top-p 0.95) twice identical; over an int8
   pool (#8); draft mode with TinyLlama's shape and Llama 3's vocabulary
   (SPEC_LAYERS of its 22 layers, D 64), greedy twice identical,
   pipeline on and off equal.
   Then 2 layers at full width in fp32, random weights made on the card:
   n-gram, a 2-layer draft and self-draft greedy against speculation off
   by phase 7's margin rule; self-draft accepts at least 95% of its
   proposals.  Per run: acceptance, mean accepted length, speculative
   dispatches, blocking fetches against dispatches (fewer when
   pipelined), decode tokens/s in blocks beside speculation off's,
   capture seconds and peak GiB; #9's and #8's Python
   counters held to the ticks, captures and draft catch-ups, and the
   device launches derived from the replays.  Phase 5 holds #9 and #8
   at the verify tick's shape (16 x 5 tokens), the draft's decode, first
   step (16 x 2) and catch-up chunk (512 over 1536 keys; H 32/4, D 64)
   and a ``kv_len`` past the page table.

21. Long context (A9.5) on ``llama3-8b`` at full width and 8 of its 32
   layers, bf16, CUDA graphs on, the reference's knobs (sink 1, window
   8, groups of 4): one 4064 + 32 greedy request on a 17-page pool (4x over it; tiers of
   24 host and 64 NVMe pages under ``build/smoke_lc``, removed
   afterwards) against the same request fully resident, over a bf16 and
   an int8 pool: tokens equal to the control and the first divergence,
   the first sampled position's max |dlogit|, page-ins (every page
   digest-verified), ``pagein_wait`` / ``pagein_verify`` ms a tick,
   staged-stats dispatches a tick, decode tokens/s beside the control's,
   the residency ratio, and the peak GiB at 2048 and at 4096 tokens of
   context (within 0.5 GiB); #9 / #8 launched exactly 8 times a tick.
   Then the request beside 4 normal ones (128-512 + 32-64, submitted
   once its prompt is in), pipeline on and off: the same tokens, its own
   equal to its solo run's, and no decode block while it is live; and 2
   layers at full width in fp32, random weights made on the card,
   1024 + 32 against the resident control by phase 7's margin rule.
22. The fp8, fp6 and w8a8 weight formats (A9.6): K1 ``dequant_scaled``
   (e4m3, and int8 a scale a row) and K2 ``dequantize_fp6`` (groups of
   128 and 2048) bit-identical to their plain versions at ``gate_proj``,
   ``down_proj`` and ``lm_head``, and the W8A8 Linear (its row pre-pass
   ``w8a8_quant_rows``, then the GEMM ``w8a8_gemm``) at those and
   ``k_proj``, at 1, 16, 17, 80 and 512 rows; each
   timed at ``gate_proj`` beside its bound and plain version, the W8A8
   GEMM at 16 and 512 rows beside ``torch._int_mm`` and bf16
   ``F.linear``, and at 16 rows at ``k_proj`` and ``lm_head``.  Then
   ``llama3-8b`` at full width and depth through v2
   with each format, phase 6's 24 requests graphed and pipelined twice
   (the same tokens; w8a8 once more with the pipeline off, the same
   tokens), each format's counters exact against the ticks and captures
   as in phase 14 (K1 or K2 226 a tick; the pre-pass and ``w8a8_gemm``
   225 each and #7 once a tick for w8a8),
   resident and peak GiB, decode tokens/s, TTFT p50/p99 and
   how many requests equal the bf16 run's; v1 with each format at 4 x
   1000 + 16, greedy twice identical, #1 32 times and the format's
   kernels exactly per forward; and 1 layer at full hidden and MLP width
   in fp32 per format (vocabulary 8192), card against CPU as phase 12(c),
   where native w8a8 may also differ after a rounding flip, every W8A8
   Linear is held bit-identical to its plain version on the card's own
   inputs, and one request at least shows no flip; then phase 12(c)'s
   comparison.
23. Disaggregated serving (A9.7, A10a): ``llama3-8b`` at full width and
   depth, bf16, CUDA graphs and the pipeline, one module serving
   a fused control engine and a prefill and a decode replica (each its
   own pool and pinned host tier) behind ``Router`` with ``set_roles``.
   16 greedy requests, 8 x 32 and 8 x 1024 tokens + 64 each: every
   request finishes once with its full count, every long one hands its
   KV off (no fold), every restore is digest-verified, both pools end
   all free; #9's Python count equals every replica's ticks, captures
   and replays as in phase 14; after every leg no replica died, was
   re-routed from or left ``healthy``.  The same 16 again on the router
   and on the control, warm (no capture in the leg).  Then one
   ``handoff.import`` bitflip (the
   session quarantined and re-prefilled), 8 requests with the roles off
   (both replicas capture and replay from their own threads), and 4
   SSE streams through ``FrontDoorServer`` on ``127.0.0.1:0`` whose
   tokens equal the engines' ``get_outputs``.  Printed beside the card:
   TTFT p50/p99 short and long (and the control's), ``handoff_stall_ms``
   p50/p99, restore ms a page, decode tokens/s beside the control's,
   the share of outputs equal to the control's and the first
   divergence (bf16: reported, not gated), peak GiB and the phase's
   seconds.  Then 2 layers at full width in fp32, the 1P1D router
   against the fused control by phase 7's margin rule.  Phase 23 runs
   right after phase 21 and before phase 22.
24. Sparse MoE (``moe/``, ``models/qwen2_moe.py``, ``models/mixtral.py``),
   last: #9 and #8 at the group-1 shape of ``qwen1.5-moe-a2.7b`` (H 16
   over Hkv 16, D 128) at decode and mixed against their plain versions
   over bf16, int8 and e4m3 pages, timed beside their bound.  Then
   ``qwen1.5-moe-a2.7b`` at full size (24 layers, 60 experts of 1408,
   4 a token, a shared expert of 5632, vocabulary 151936), bf16, random
   seeded weights made on the card, the router kept fp32 by v2: phase
   6's 24 requests eager and unpipelined (routed copies dropped for
   capacity a tick, read from the gating), then graphed and pipelined,
   graphed and unpipelined, and phase 6's int8 pool over 8 requests,
   every run's tokens equal to the eager run's and #9 / #8 counted once
   a layer a tick as in phase 14; v1 on the same module at 4 x 512 + 32,
   eager and with the decode step replayed (the same tokens), #1 once a
   layer a prefill.  Decode tokens/s, TTFT p50/p99, prefill
   tokens/s, ``host_bound_fraction``, resident and peak GiB.  The same
   module as target of a 2-layer Qwen2-MoE draft at its widths (A12c),
   ``speculation="draft"`` at k 4, graphed, 4 prompts + 32 greedy tokens:
   pipelined
   twice and unpipelined once with equal tokens, #9 held to the target's
   and the draft's layers a tick, a draft step and a catch-up chunk;
   acceptance and catch-up chunks printed.  Then 2 of
   its layers at full width in fp32 (``drop_tokens`` off, so that v1's
   batch and v2's padded tick route each token alike): v2 against v1 by
   phase 7's margin rule, where a token may also differ after a position
   that the two engines routed to different experts (both runs' router
   logits recorded and compared row by row), and the same 2 layers with
   a 2-layer MoE draft against speculation off by phase 7's margin
   rule; and ``mixtral-8x7b`` at full width and 2 of
   its 32 layers (top 2 of 8, renormalised gates), bf16, graphed and
   pipelined against eager, #9 twice a tick.
25. Quantized expert banks (A12b), last: (a) #6 and #7 (int8, groups of
   2048), K1 (fp8, one scale) and K2 (fp6, groups of 2048) over one
   ``mixtral-8x7b`` bank [8, 4096, 14336] and one ``qwen1.5-moe-a2.7b``
   bank [60, 2048, 1408] in bf16, bit-identical to their plain versions,
   each timed (graph-replayed) beside its byte bound and plain version.
   (b) ``mixtral-8x7b`` at full size (32 layers, published widths, 46.7 B
   parameters: 87.0 GiB in bf16, more than the card holds), built on meta
   and quantized to int8 by v2 one module at a time: #6 226 times, the
   build's and the serving's peak memory under the bf16 size; 8 seeded
   requests (128..1024 + 32..64) eager and unpipelined, then graphed and
   pipelined, the same tokens, #7 226 and #9 32 times a tick (counted as
   in phase 14, the device's launches derived); decode tokens/s, TTFT
   p50/p99, ``host_bound_fraction``, and a replayed tick's wall time
   against the int8 weight read.  (c) v1 on the same module (cast by its
   own rule: the router to bf16), int8 at groups of 2048, 2 x 512 + 32
   eager and graphed, the same tokens, #1 once a layer a prefill and #7
   226 a forward.  (d) ``qwen1.5-moe-a2.7b`` at full width and 8 of its
   24 layers with fp8 and with fp6 banks through v2 over the same 8
   requests, graphed and pipelined against eager, K1 / K2 90 a tick.
   (e) phase 24's fp32 leg with int8 weights and banks.
26. The tuning layer (A10b), last: (a) ``Autotuner`` on bench.py's
   config 1 (``gpt2-125m`` at full size, bf16, fused AdamW, seq 1024)
   over ZeRO stages 0-2 and micro batches 4..32 doubling, every point a
   fresh engine on the card (``engine_runner``) launching #1, #2, #3 and
   #4 12, 12, 12 and 1 a step, its samples/s and peak GiB beside the
   memory model's estimate; the winner's config written under build/ and
   read back, then run again in a fresh interpreter through
   ``make_subprocess_runner``.  (b) ``llama3-8b`` at full width and
   depth, graphed and pipelined, phase 6's traffic with the controller
   armed (a tick every step) against control off: tokens and graph
   captures equal, probes made, #9 once a layer a tick; decisions and
   ``host_bound_fraction`` on and off printed.  (c) ``autotune_serving``
   over decode block 4/8 x harvest 1/4 on 8 of the requests, its profile
   under build/ keyed by the card's fingerprint; a new engine seeded from
   it starts at the winner's knobs before any capture and serves the 24
   requests with control off's tokens at that block size; the block size
   set between two runs captures once more and serves control off's
   tokens at the other size.  Then the controller over phase 19's tight
   pool at 8 layers with the tiers, prefetch off at the start, bf16 and
   int8 pools: the prefetch rule fires on the spill signal, every
   restored page digest-verified and read back equal, tokens equal to
   control off.
27. ZeRO-Offload and ZeRO-Infinity (A11), last: (a) ``llama-1b`` at full
   size on phase 9's config, seed and batch, 3 steps each: stage 0 with
   the optimizer state in page-locked host RAM (tier cpu) bit-identical
   to a resident stage-0 run (losses and the final master); stage 3
   with both offloads bit-identical to a resident stage-3 run, and
   within ``STAGE_LOSS_RTOL`` of stage 0; stage 2 with the
   moments on NVMe (tier nvme) pipelined against serial, bit-identical;
   an NVMe checkpoint (2 layers) resumed into a resident engine,
   bit-identical; #4 once a bucket a step, exactly.  (b) ``llama3-8b``
   at full width, ZeRO stage 2 over one NCCL rank, tier cpu, bf16, fused
   AdamW, full remat, 1 x 2048 tokens, a warm-up and 3 steps, at the
   depth the host's RAM holds with 16 GiB spare (``MemTotal`` /
   ``MemAvailable`` and the free disk printed first, the cut printed);
   losses, peak card GiB, page-locked host GiB and its pinning time, the
   step against the PCIe bound (the stream's bytes over page-locked
   copy rates measured in the phase), #4 once a bucket a step, and the
   largest bucket's #4 against plain.  (c) ``llama3-8b`` at full size
   through ``NvmeWeightStreamingEngine``, 4 x 128 + 8 greedy, against
   v1's tokens on the same seeded weights; resident bytes, GB read and
   new tokens/s against a sweep's read bound.  Files under
   ``build/smoke_offload``, removed afterwards.

Phases 3, 6, 12, 14, 22, 23, 24's first model, 25's Mixtral and 26's
first model keep their full depth;
phases 19 and 21 (the KV tiers), 20 and 26's tiering leg
run 8 of the 32 layers, and the
checkpoint legs of phases 13 and 17 2 layers, so that the whole run
stays well inside its time limit; phase 12's CPU parity runs one layer
(two until phase 19 came).  The CPU halves of phases
12(c) and 22 run in a worker process (``--cpu-side``, no card visible,
4 threads, files under ``build/smoke_cpu``, removed afterwards) started
at phase 12, so that the whole run stays inside its time limit.
``--gpt2-only`` runs the build and phases 15-18
alone, ``--tiering-only`` the build and phase 19, ``--spec-only`` the
build and phase 20, ``--lc-only`` the build, phase 5's carry cases and
phase 21, ``--wq-only`` the build and phase 22, ``--disagg-only`` the
build and phase 23, ``--moe-only`` the build and phases 24 and 25,
``--tuning-only`` the build and phase 26, ``--offload-only`` the build
and phase 27; none prints result lines.  The line before the last is the ``kernels`` JSON;
the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA GPU it exits
nonzero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

SEED = 0
PEAK_BF16 = 989e12          # dense tensor-core FLOP/s, H100 SXM data sheet
PEAK_FP32 = 67e12           # fp32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12        # HBM3 bytes/s
PEAK_INT8 = 1979e12         # dense tensor-core int8 OP/s
# bf16 tolerance, kernel against plain: both compute fp32 scores from the
# same bf16 inputs and cast p to bf16 before PV; they differ in summation
# order and in where each rounds o to bf16 (half an ulp: 2^-8 relative)
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
LSE_ATOL, LSE_RTOL = 2e-3, 1e-4      # lse stays fp32 in both
FP32_ATOL = 1e-4                     # fp32 kernel: full fp32 products
LOGITS_ATOL = 1e-3                   # phase 4, fp32 card vs fp32 CPU
# phase 5, bf16 queries: K and V are O(1) for every page type, so |o|
# falls to ~0.04 at 2048 keys; atol sits well under that, rtol covers one
# bf16 ulp of o (2^-8 relative) where the two round it differently
PAGED_ATOL, PAGED_RTOL = 2e-3, 2e-2
MARGIN = 1e-3       # phase 7: a token may differ only below this margin


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back runs."""
    for _ in range(warmup):
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


def graph_ms(fn, reps: int = 20) -> float:
    """Device time of one ``fn`` call: ``reps`` calls captured in a CUDA
    graph and replayed, so that the host's time per call (Python checks,
    allocation, ctypes) is not in it."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (5 * reps)


def pairs_of(S, Sk, causal):
    """Valid (query, key) pairs of one head: bottom-right causal or all."""
    if not causal:
        return S * Sk
    return int(np.clip(np.arange(S) + (Sk - S) + 1, 0, Sk).sum())


def attention_bound(B, H, Hkv, S, Sk, D, causal, dtype):
    """Least time (ms) the card could take, and what bounds it: the q-k
    pairs these inputs need, 4*D operations each, at the peak rate of
    their type; each input read once and each output written once."""
    ops = 4 * B * H * D * pairs_of(S, Sk, causal)
    elem = torch.finfo(dtype).bits // 8
    nbytes = elem * (2 * B * H * S * D + 2 * B * Hkv * Sk * D) + 4 * B * H * S
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_report():
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"device {torch.cuda.get_device_name(0)}")
    from deepspeed_tpu_torch.ops import builder

    t0 = time.perf_counter()
    built = builder.build_all(["flash_fwd", "ragged_paged_attn",
                               "flash_bwd", "fused_adam", "quantization",
                               "weight_formats", "w8a8_gemm"])
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}")
    for name, b in built.items():
        log(f"[{name}] nvcc {b.seconds:.1f} s\n{b.log.strip()}")
    check_hopper_build(built["flash_fwd"], "flash_fwd",
                       ["flash_fwd_hopper"],
                       lambda lib, k, d: lib.dstpu_flash_fwd_smem_bytes(d))
    check_hopper_build(built["flash_bwd"], "flash_bwd",
                       ["dq_hopper", "dkv_hopper"],
                       lambda lib, k, d: lib.dstpu_flash_bwd_smem_bytes(
                           0 if k == "dq_hopper" else 1, d))
    # the bf16-query paged kernels (rpa_mma over bf16, int8 and e4m3 pages
    # and rpa_combine, D=64 and 128; neither wgmma nor setmaxnreg), then
    # quantize (the ring and the first design) and dequantize, 3 input
    # types each
    check_no_spill(built["ragged_paged_attn"], "ragged_paged_attn",
                   ("rpa_mma", "rpa_combine"), 8)
    check_no_spill(built["quantization"], "quantization",
                   ("quant_ring", "quant_kernel", "dequant_kernel"), 18)
    # the weight formats' kernels: K1 over int8 and e4m3 and K2, each at
    # both vector widths and three output types
    check_no_spill(built["weight_formats"], "weight_formats",
                   ("dequant_scaled_kernel", "dequant_fp6_kernel"), 18)
    # the W8A8 GEMM at 16, 32, 64, 128 and 256-token tiles and its row
    # pre-pass at 512 and 128 threads a row, three types each; its wgmma
    # must not be serialized either
    check_no_spill(built["w8a8_gemm"], "w8a8_gemm",
                   ("w8a8_gemm", "w8a8_rows"), 21, wgmma=True)
    return smi


def check_no_spill(built, name, kernels, count, wgmma=False):
    """The ``count`` kernels of library ``name`` whose names contain one
    of ``kernels``, from ``ptxas -v``: no warning (the source's flags make
    a spill or local memory one), no stack, no spill; with ``wgmma``, no
    wgmma that ptxas had to serialize (C7520, printed as info)."""
    from deepspeed_tpu_torch.ops import builder

    if not built.log:           # built before this run: build it again
        built.path.unlink()
        built = builder.build_all([name])[name]
    lines = built.log.splitlines()
    bad = [ln for ln in lines
           if ("warning" in ln and any(k in ln for k in kernels)) or
           (wgmma and ("C7520" in ln or "serialized" in ln))]
    assert not bad, f"ptxas warns about {kernels}:\n" + "\n".join(bad)
    props = {}
    for i, ln in enumerate(lines):
        if ln.startswith("ptxas info    : Function properties for") and \
                any(k in ln for k in kernels):
            props[ln.split()[-1]] = (lines[i + 1].strip(),
                                     lines[i + 2].split(": ", 1)[-1].strip())
    assert len(props) == count, f"ptxas lines for {kernels}: {sorted(props)}"
    for fn, (frame, regs) in sorted(props.items()):
        assert frame.startswith("0 bytes stack frame, 0 bytes spill "
                                "stores, 0 bytes spill loads"), (fn, frame)
        log(f"{fn}: {regs}; {frame}")


def check_hopper_build(built, name, kernels, smem_bytes):
    """The TMA/wgmma kernels of library ``name`` at D=64 and D=128, from
    its ``ptxas -v`` log and its SASS: no spill and no local memory, no
    wgmma that ptxas had to serialize, and the registers each warpgroup
    role asks for.  ``smem_bytes(lib, kernel, d)`` reads a kernel's dynamic
    shared memory from the library."""
    import ctypes

    from deepspeed_tpu_torch.ops import builder

    if not built.log:           # built before this run: build it again
        built.path.unlink()
        built = builder.build_all([name])[name]
    log_lines = built.log.splitlines()
    bad = [ln for ln in log_lines if "serialized" in ln or "C7520" in ln
           or ("warning" in ln and any(k in ln for k in kernels))]
    assert not bad, f"ptxas warns about {kernels}:\n" + "\n".join(bad)
    props = {}
    for i, ln in enumerate(log_lines):
        kernel = next((k for k in kernels if k in ln), None)
        if ln.startswith("ptxas info    : Function properties for") and \
                kernel:
            d = 64 if "ILi64E" in ln else 128
            props[kernel, d] = (log_lines[i + 1].strip(),
                                log_lines[i + 2].split(": ", 1)[-1].strip())
    want = sorted((k, d) for k in kernels for d in (64, 128))
    assert sorted(props) == want, f"ptxas lines for {kernels}: {props}"
    # the role registers: setmaxnreg compiles to USETMAXREG in the SASS
    sass = subprocess.run(
        [os.path.join(os.path.dirname(builder.nvcc()), "cuobjdump"),
         "-sass", str(built.path)], capture_output=True, text=True,
        check=True).stdout
    roles, func = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            kernel = next((k for k in kernels if k in ln), None)
            func = (kernel, 64 if "ILi64E" in ln else 128) if kernel \
                else None
        elif func and "SETMAXREG" in ln:
            roles.setdefault(func, []).append(" ".join(
                ln.split("*/")[1].split("/*")[0].split()).rstrip(" ;"))
    lib = ctypes.CDLL(str(built.path))
    for kernel, d in want:
        spills, regs = props[kernel, d]
        assert "0 bytes spill stores, 0 bytes spill loads" in spills, spills
        assert len(roles.get((kernel, d), [])) >= 2, roles
        log(f"{kernel}<{d}>: {regs}; {spills}; setmaxnreg in SASS: "
            f"{roles[kernel, d]}; dynamic shared memory "
            f"{smem_bytes(lib, kernel, d)} bytes; no wgmma serialization "
            f"warning")


def _qkv(gen, B, H, Hkv, S, Sk, D, dtype):
    # the layout the model hands the kernel: [B, S, heads, D] projections
    # seen as [B, heads, S, D]
    def make(n, s):
        return torch.randn(B, s, n, D, generator=gen, device="cuda",
                           dtype=dtype).transpose(1, 2)

    return make(H, S), make(Hkv, Sk), make(Hkv, Sk)


def check_fwd(name, o, lse, ro, rlse, dtype):
    """The forward kernel's ``o`` and ``lse`` against the plain version's,
    to the phase-2 limits; returns the largest errors of both."""
    of, rof = o.float(), ro.float()
    err = (of - rof).abs()
    atol, rtol = (BF16_ATOL, BF16_RTOL) if dtype == torch.bfloat16 \
        else (FP32_ATOL, FP32_ATOL)
    assert torch.isfinite(of).all(), f"{name}: non-finite output"
    assert (err <= atol + rtol * rof.abs()).all(), (
        f"{name}: o differs from plain by up to {err.max().item():.3e}")
    inf = torch.isinf(rlse)
    assert torch.equal(torch.isinf(lse), inf), f"{name}: lse inf rows"
    lerr = (lse - rlse)[~inf].abs()
    assert (lerr <= LSE_ATOL + LSE_RTOL * rlse[~inf].abs()).all(), (
        f"{name}: lse differs by up to {lerr.max().item():.3e}")
    return err.max().item(), lerr.max().item()


def phase_kernel():
    from deepspeed_tpu_torch.ops.flash_attention import (flash_fwd,
                                                         flash_fwd_reference)
    from torch.nn import functional as F

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [  # name, B, H, Hkv, S, Sk, D, causal, dtype
        ("serving", 4, 32, 8, 1000, 1000, 128, True, bf16),
        ("s2048", 4, 32, 8, 2048, 2048, 128, True, bf16),
        ("d64_noncausal", 4, 32, 8, 1000, 1000, 64, False, bf16),
        ("sk_lt_s", 2, 32, 8, 1000, 600, 128, True, bf16),
        ("train", 4, 32, 4, 2048, 2048, 64, True, bf16),
        ("fp32", 1, 8, 2, 300, 300, 128, True, f32),
    ]
    entry = None
    for i, (name, B, H, Hkv, S, Sk, D, causal, dtype) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(SEED + i)
        q, k, v = _qkv(gen, B, H, Hkv, S, Sk, D, dtype)
        o, lse = flash_fwd(q, k, v, causal=causal)
        ro, rlse = flash_fwd_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err, lerr = check_fwd(name, o, lse, ro, rlse, dtype)
        if causal and Sk < S:   # rows before the diagonal see no key
            blind = S - Sk
            inf = torch.isinf(rlse)
            assert inf[:, :, :blind].all() and not inf[:, :, blind:].any()
            assert (o[:, :, :blind] == 0).all()
        ms = time_ms(lambda: flash_fwd(q, k, v, causal=causal))
        # SDPA's causal mask is top-left aligned, so it computes the same
        # function only when S == Sk
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)) \
            if (not causal or S == Sk) else None
        bound, by = attention_bound(B, H, Hkv, S, Sk, D, causal, dtype)
        tflop = 4 * B * H * D * pairs_of(S, Sk, causal) / 1e12
        log(f"flash_fwd[{name}] B={B} H={H} Hkv={Hkv} S={S} Sk={Sk} D={D} "
            f"causal={causal} {dtype}: max|o-plain|={err:.3e} "
            f"max|lse-plain|={lerr:.3e} kernel {ms:.4f} ms "
            f"({tflop / ms * 1e3:.1f} TFLOP/s), sdpa "
            f"{lib_ms if lib_ms is None else round(lib_ms, 4)} ms"
            f"{'' if lib_ms is None else f' ({tflop / lib_ms * 1e3:.1f} TFLOP/s)'}"
            f", bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
        if name == "serving":
            plain_ms = time_ms(
                lambda: flash_fwd_reference(q, k, v, causal=causal),
                reps=3, warmup=1)
            log(f"flash_fwd[serving] plain {plain_ms:.3f} ms")
            entry = dict(name="flash_fwd", route="cuda",
                         source="deepspeed_tpu_torch/ops/csrc/flash_fwd.cu",
                         replaces="deepspeed_tpu/ops/flash_attention.py:225",
                         launches=0, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                         library_ms=lib_ms)
        del q, k, v, o, lse, ro, rlse
    return entry


def phase_slice():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    cfg = get_config("llama3-8b")
    B, P, NEW = 4, 1000, 64
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "max_out_tokens": 2048},
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in engine.module.parameters())
    log(f"llama3-8b: {n_params / 1e9:.3f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card, "
        f"init {time.perf_counter() - t0:.1f} s")
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(SEED))

    logits = engine.forward(prompts[:, :16])
    assert logits.shape == (B, 16, cfg.vocab_size), logits.shape
    assert torch.isfinite(logits).all(), "non-finite logits"
    del logits

    def run(**kw):
        before = flash_fwd.launches
        t = time.perf_counter()
        out = engine.generate(prompts, **kw)
        dt = time.perf_counter() - t
        n = flash_fwd.launches - before
        assert n == cfg.num_hidden_layers, (
            f"generate launched the flash kernel {n} times, want "
            f"{cfg.num_hidden_layers}")
        new = kw["max_new_tokens"]
        assert out.shape == (B, P + new), out.shape
        assert torch.equal(out[:, :P], prompts)
        assert ((out[:, P:] >= 0) & (out[:, P:] < cfg.vocab_size)).all()
        return out, dt

    flash_fwd.launches = 0          # the main path's run starts here
    greedy1, t1 = run(max_new_tokens=NEW)
    greedy2, t2 = run(max_new_tokens=NEW)
    sampled, ts = run(max_new_tokens=NEW, do_sample=True, temperature=0.8,
                      top_k=50, top_p=0.9,
                      generator=torch.Generator(device="cuda").manual_seed(
                          SEED))
    _, tp1 = run(max_new_tokens=1)
    _, tp2 = run(max_new_tokens=1)
    launches = flash_fwd.launches
    assert torch.equal(greedy1, greedy2), "greedy runs differ"
    peak = torch.cuda.max_memory_allocated() / 2**30
    prefill_ms = tp2 * 1e3
    decode_tps = B * (NEW - 1) / (t2 - tp2)
    log(f"slice: generate {B}x{P}+{NEW}: {t1:.3f} s (first), {t2:.3f} s, "
        f"sampled {ts:.3f} s; prefill (generate 1 token) {tp1 * 1e3:.1f} / "
        f"{prefill_ms:.1f} ms; decode {decode_tps:.1f} tokens/s "
        f"({(t2 - tp2) / (NEW - 1) * 1e3:.2f} ms/step at batch {B}); "
        f"peak memory {peak:.2f} GiB; flash launches {launches} over 5 "
        f"generate calls; stages {engine.serving_stages()}")
    log(f"slice: greedy tokens row 0: {greedy1[0, P:P + 16].tolist()}; "
        f"sampled row 0: {sampled[0, P:P + 16].tolist()}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, greedy1, dict(sampled=sampled, decode_tps=decode_tps,
                                   peak=peak)


def flax_tree(cfg, rng):
    """A random flax-layout Llama param tree (unrolled layers) in numpy.
    The values come from a torch CPU generator keyed by ``rng`` (its
    normal draws are a few times faster than numpy's), and each kernel
    is drawn ``[out, in]`` and handed over as its transposed view, so
    that the bridge's transpose back to torch's layout copies nothing:
    at llama3-8b's vocabulary the tables are 0.5 G values each."""
    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)
    gen = torch.Generator().manual_seed(int(rng.integers(2**62)))

    def normal(*shape):
        return torch.randn(shape, generator=gen)

    def dense(n_in, n_out):
        w = normal(n_out, n_in).mul_(1 / math.sqrt(n_in))
        return {"kernel": w.numpy().T}

    def norm():
        return {"scale": normal(E).mul_(0.1).add_(1).numpy()}

    model = {"embed_tokens": {"embedding": normal(V, E).numpy()},
             "norm": norm()}
    for i in range(cfg.num_hidden_layers):
        model[f"layers_{i}"] = {
            "input_layernorm": norm(), "post_attention_layernorm": norm(),
            "self_attn": {"q_proj": dense(E, H * Dh),
                          "k_proj": dense(E, Hkv * Dh),
                          "v_proj": dense(E, Hkv * Dh),
                          "o_proj": dense(H * Dh, E)},
            "mlp": {"gate_proj": dense(E, I), "up_proj": dense(E, I),
                    "down_proj": dense(I, E)}}
    return {"params": {"model": model, "lm_head": dense(E, V)}}


def phase_cpu_parity():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.module_inject.flax_bridge import \
        flax_to_state_dict

    # full fp32 on both sides: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3-8b", num_hidden_layers=2, dtype=torch.float32)
    rng = np.random.default_rng(SEED)
    t0 = time.perf_counter()
    state = flax_to_state_dict(flax_tree(cfg, rng))
    log(f"parity: bridged {len(state)} tensors in "
        f"{time.perf_counter() - t0:.1f} s")
    ids = rng.integers(0, cfg.vocab_size, size=(2, 64))
    logits = {}
    for dev in ("cuda", "cpu"):
        with torch.device("meta"):
            model = LlamaForCausalLM(cfg)
        eng = deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "float32", "max_out_tokens": 128},
            params=state, device=dev)
        logits[dev] = eng.forward(ids).cpu()
        del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    gpu, cpu = logits["cuda"], logits["cpu"]
    assert gpu.shape == (2, 64, cfg.vocab_size) and torch.isfinite(gpu).all()
    err = (gpu - cpu).abs().max().item()
    log(f"parity: 2-layer fp32 prefill logits, card vs CPU: max|diff| "
        f"{err:.3e} (logit std {cpu.std().item():.3f}, tolerance "
        f"{LOGITS_ATOL})")
    assert err <= LOGITS_ATOL, f"card and CPU logits differ by {err:.3e}"
    return cfg, state

# ---------------------------------------------------------------------------
# Phase 5: the paged-attention kernels against their plain versions
# ---------------------------------------------------------------------------

def paged_case(seed, q_lens, kv_lens, H=32, Hkv=8, D=128, page=64,
               qdtype=torch.bfloat16, pdtype=torch.bfloat16, holes=False,
               pad=0, pp=None, hole_cols=None):
    """q, a pool of just the pages the sequences use (plus the trash page
    0, in a shuffled order), fp32 scales for 1-byte pages, and the tick's
    metadata, on the card.  K and V are standard normal; 1-byte pages hold
    them as the pool's own write quantizes them (scale = row absmax /
    qmax), so every page type dequantizes to values of the same size.
    ``holes`` marks every other page before a sequence's first query
    token -1; ``pad`` adds padding tokens; ``pp`` caps the page table's
    width, so that a ``kv_len`` may pass ``pp * page`` (a verify tick
    near ``max_seq_len``).  ``hole_cols``: per sequence, the page-table
    columns to mark -1 (a long-context sequence's parked middle)."""
    from deepspeed_tpu_torch.inference.paged import PagedKVPool

    g = torch.Generator().manual_seed(seed)
    S = len(q_lens)
    cols = [min(-(-kv // page), pp or kv) for kv in kv_lens]
    n_pages = 1 + sum(cols)
    ids = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    table = torch.full((S, max(cols)), -1, dtype=torch.int32)
    for j, c in enumerate(cols):
        table[j, :c] = torch.tensor(ids[:c], dtype=torch.int32)
        ids = ids[c:]
        if holes:
            table[j, 1:(kv_lens[j] - q_lens[j]) // page:2] = -1
        if hole_cols is not None:
            table[j, list(hole_cols[j])] = -1
    kv = torch.randn(n_pages, page, 2 * Hkv, D, generator=g)
    scales = None
    if pdtype in (torch.int8, torch.float8_e4m3fn):
        pool = PagedKVPool(n_pages, page, Hkv, D,
                           "int8" if pdtype == torch.int8 else "fp8",
                           qdtype, "cpu")
        rows = kv.view(n_pages * page, 2 * Hkv, D)
        pool.write(rows[:, 0::2], rows[:, 1::2],
                   torch.arange(n_pages * page))
        pages, scales = pool.pages, pool.scales.to("cuda")
    else:
        pages = kv.to(pdtype)
    q = torch.randn(sum(q_lens) + pad, H, D, generator=g).to("cuda", qdtype)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    cu[1:] = torch.cumsum(torch.tensor(q_lens), 0)
    meta = [torch.tensor(kv_lens, dtype=torch.int32), table, cu,
            torch.tensor([S], dtype=torch.int32)]
    return q, pages.to("cuda"), scales, [m.to("cuda") for m in meta]


def paged_bound(q_lens, kv_lens, table, H, Hkv, D, page, qdtype, pdtype,
                window=None, carry=False):
    """Least time (ms) the card could take for one ragged paged attention
    call, and what bounds it.  Bytes: q and o once, every page a sequence
    attends (pages with a key in its window, holes excluded) once, with
    its scale rows for 1-byte pages, and a ``carry``'s m, l and acc once.
    Operations: 4*D per valid (query head, resident key) pair, at the
    bf16 tensor-core rate for bf16 queries and the fp32 rate for fp32
    ones."""
    qe = torch.finfo(qdtype).bits // 8
    pe = 1 if pdtype in (torch.int8, torch.float8_e4m3fn) else \
        torch.finfo(pdtype).bits // 8
    row = 2 * Hkv * (D * pe + (4 if pe == 1 else 0))
    nbytes = 2 * sum(q_lens) * H * D * qe
    if carry:
        nbytes += 4 * sum(q_lens) * H * (D + 2)
    pairs = 0
    span = table.shape[1] * page       # keys past the table do not exist
    for j, (n, kv) in enumerate(zip(q_lens, kv_lens)):
        qpos = np.arange(kv - n, kv)
        lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(
            qpos)
        # resident keys below each position: holes hold none
        live = np.repeat(table[j].numpy() >= 0, page)[:span]
        below = np.concatenate([[0], np.cumsum(live)])
        hi = np.minimum(qpos + 1, span)
        pairs += int(np.maximum(below[hi] - below[np.minimum(lo, hi)], 0
                                ).sum()) * H
        first = int(lo.min()) // page
        cols = [c for c in range(first, min(-(-kv // page),
                                            table.shape[1]))
                if int(table[j, c]) >= 0]
        nbytes += len(cols) * page * row
    ops = 4 * D * pairs
    peak = PEAK_BF16 if qdtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_paged_kernels():
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    bf16, f32 = torch.bfloat16, torch.float32
    i8, e4m3 = torch.int8, torch.float8_e4m3fn
    decode = ([1] * 16, [128 * (j + 1) for j in range(16)])
    mixed = ([1] * 8 + [512], [128 + 256 * j for j in range(8)] + [1500])
    # name, (q_lens, kv_lens), options, timed
    shapes = [("decode", decode, {}, True),
              ("mixed", mixed, {}, True),
              ("few_decode", ([1, 1], [2048, 2048]), {}, True),
              ("long_decode", ([1] * 16, [8192] * 16), {}, True),
              ("window", mixed, {"window": 256}, False),
              ("holes", ([1] * 4 + [200], [700, 900, 1000, 1300, 1500]),
               {"holes": True, "pad": 7}, False),
              ("d64", ([1] * 8 + [300], [200 * (j + 1) for j in range(9)]),
               {"D": 64, "H": 16, "Hkv": 4}, False),
              # speculation: the verify tick (k+1 = 5 rows a sequence),
              # the draft's decode (llama-1b's heads, D 64), and a verify
              # tick near max_seq_len whose kv_len passes pp * page (last)
              ("verify", ([5] * 16, [128 * (j + 1) for j in range(16)]), {},
               True),
              ("draft_decode", decode, {"D": 64, "H": 32, "Hkv": 4}, True),
              # the draft's first step of a tick (2 rows a sequence) and
              # its catch-up chunk (one sequence, 8 query heads a KV head)
              ("draft_first", ([2] * 16, decode[1]),
               {"D": 64, "H": 32, "Hkv": 4}, True),
              ("draft_prefill", ([512], [1536]),
               {"D": 64, "H": 32, "Hkv": 4}, True),
              ("past_table", ([5, 5, 1], [4 * 64 + 3, 300, 4 * 64]),
               {"pp": 4, "pad": 3}, False)]
    cases = [(n, qk, opt, timed, pd) for n, qk, opt, timed in shapes
             for pd in (bf16, i8, e4m3)]
    cases.append(("fp32", ([1, 1, 37], [65, 200, 150]),
                  {"H": 8, "Hkv": 2, "page": 16, "pad": 3, "window": 50,
                   "qdtype": f32}, False, f32))
    cases += [("fp32", ([1, 1, 37], [65, 200, 150]),
               {"H": 8, "Hkv": 2, "page": 16, "qdtype": f32}, False, pd)
              for pd in (i8, e4m3)]
    entries = {}
    worst = {"ragged_paged_attn": 0.0, "ragged_paged_attn_quant": 0.0}
    for i, (name, (q_lens, kv_lens), opt, timed, pd) in enumerate(cases):
        opt = dict(opt)
        window = opt.pop("window", None)
        q, pages, scales, meta = paged_case(SEED + i, q_lens, kv_lens,
                                            pdtype=pd, **opt)
        sm = q.shape[-1] ** -0.5
        quant = scales is not None
        fn = rpa.ragged_paged_attention_quant if quant \
            else rpa.ragged_paged_attention
        ref = (rpa.ref_paged_attention_quant if quant
               else rpa.ref_paged_attention)
        args = (q, pages, scales, *meta) if quant else (q, pages, *meta)
        out = fn(*args, sm_scale=sm, sliding_window=window)
        want = ref(*args, sm_scale=sm, sliding_window=window)
        torch.cuda.synchronize()
        of, wf = out.float(), want.float()
        err = (of - wf).abs()
        atol = FP32_ATOL if q.dtype == f32 else PAGED_ATOL
        rtol = FP32_ATOL if q.dtype == f32 else PAGED_RTOL
        limit = atol + rtol * wf.abs()
        assert torch.isfinite(of).all(), f"paged {name} {pd}: non-finite"
        assert (err <= limit).all(), (
            f"paged {name} {pd}: differs from plain by up to "
            f"{err.max().item():.3e}")
        n_real = int(sum(q_lens))
        assert (out[n_real:] == 0).all(), f"paged {name}: padding rows"
        kname = "ragged_paged_attn_quant" if quant else "ragged_paged_attn"
        if q.dtype == bf16:
            worst[kname] = max(worst[kname], err.max().item())
        line = (f"{kname}[{name}] pages {str(pd)[6:]} q {str(q.dtype)[6:]}"
                f" T={q.shape[0]} H={q.shape[1]} D={q.shape[2]} "
                f"page={pages.shape[1]} window={window}: "
                f"max|o-plain|={err.max().item():.3e} "
                f"({(err / limit).max().item():.1%} of the limit; median "
                f"|o| {wf[:n_real].abs().median().item():.3e})")
        if name == "decode":    # no atomics: two calls, the same bits
            assert torch.equal(out, fn(*args, sm_scale=sm,
                                       sliding_window=window)), (
                f"paged decode {pd}: two calls differ")
            line += "; bit-identical twice"
        if timed:
            # device time, graph-replayed; the wrapper's host loop beside
            ms = graph_ms(lambda: fn(*args, sm_scale=sm))
            host_ms = time_ms(lambda: fn(*args, sm_scale=sm))
            bound, by = paged_bound(q_lens, kv_lens, meta[1].cpu(),
                                    q.shape[1], pages.shape[2] // 2,
                                    q.shape[2], pages.shape[1], q.dtype, pd)
            S, pp = meta[1].shape
            splits = rpa.split_plan(q.shape[0], S, q.shape[1],
                                    pages.shape[2] // 2, pp,
                                    pages.shape[1])[0]
            line += (f" splits {splits} ({1 + (splits > 1)} device kernels "
                     f"a call); kernel {ms:.4f} ms on the device, "
                     f"{host_ms:.4f} ms in a host loop, bound {bound:.4f} ms "
                     f"({by}), {bound / ms:.1%} of bound")
            if name in ("decode", "mixed", "verify"):
                plain_ms = time_ms(lambda: ref(*args, sm_scale=sm), reps=3,
                                   warmup=1)
                line += f", plain {plain_ms:.3f} ms"
            # the JSON row of each kernel: its decode shape (bf16 pages for
            # #9, int8 pages for #8), the serving steady state
            if name == "decode" and pd in (bf16, i8):
                entries[kname] = dict(
                    name=kname, route="cuda",
                    source="deepspeed_tpu_torch/ops/csrc/"
                           "ragged_paged_attn.cu",
                    replaces=("deepspeed_tpu/ops/ragged_paged_quant.py:51"
                              if quant else
                              "deepspeed_tpu/inference/paged.py:602"),
                    launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None)
        log(line)
        del q, pages, scales, meta, out, want
    for kname, e in entries.items():
        e["max_abs_err"] = worst[kname]
    log("paged kernels: no PyTorch call reads a page table, so library_ms "
        "is null")
    torch.cuda.empty_cache()
    return entries["ragged_paged_attn"], entries["ragged_paged_attn_quant"]


# ---------------------------------------------------------------------------
# Phase 5, the carry: #9 and #8 with the long-context scan's carry
# ---------------------------------------------------------------------------

# a long-context tick's page table: 64 pages of 64 keys (4096), columns 0
# (the sink) and 53-63 (the window and the frontier) resident, 1-52 parked
LC_HOLES = range(1, 53)
LC_CARRY_SHAPES = [
    ("lc_decode", ([1], [4096]), [LC_HOLES], True),
    # a 64-token prefill page: one split, so the carry alone makes it
    # take the stats path and rpa_combine
    ("lc_prefill", ([64], [4096]), [LC_HOLES], True),
    # four decode rows with their own holes: several splits, some of them
    # holes only
    ("lc_ragged", ([1, 1, 1, 1], [4096, 3000, 2500, 1800]),
     [LC_HOLES, range(1, 40), range(2, 30, 2), ()], False)]


def q_positions(q_lens, kv_lens, T):
    """Every query row's absolute position (-1 past the real tokens)."""
    qpos = torch.full((T,), -1, dtype=torch.int64)
    t = 0
    for n, kv in zip(q_lens, kv_lens):
        qpos[t:t + n] = torch.arange(kv - n, kv)
        t += n
    return qpos.to("cuda")


def random_carry(q, Hkv, seed, qpos):
    """Stats of ``q`` over a random staged block of 256 parked keys (at
    positions 64..319) from the plain ``staged_attend_stats``: what a
    chunk dispatch hands the finish."""
    from deepspeed_tpu_torch.inference.paged import staged_attend_stats

    g = torch.Generator().manual_seed(seed)
    D = q.shape[-1]
    staged = torch.randn(256, 2 * Hkv, D, generator=g).to("cuda", q.dtype)
    kpos = torch.arange(64, 320, device="cuda")
    return staged_attend_stats(q, staged, kpos, qpos, sm_scale=D ** -0.5)


def phase_carry_kernels():
    """#9 and #8 with an incoming carry (B4b) against their plain versions
    at the long-context shapes, neutral and random carries, bf16 queries
    over bf16, int8 and e4m3 pages and fp32 queries over fp32, int8 and
    e4m3; the neutral carry bit-identical to no carry.  Times the random
    carry's bf16-query cases; returns the JSON rows of #9 and #8 at the
    decode shape (launches filled by phase 21)."""
    from deepspeed_tpu_torch.inference.paged import neutral_carry
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    bf16, f32 = torch.bfloat16, torch.float32
    i8, e4m3 = torch.int8, torch.float8_e4m3fn
    entries = {}
    worst = {"ragged_paged_attn": 0.0, "ragged_paged_attn_quant": 0.0}
    cases = [(shape, qd, pd) for shape in LC_CARRY_SHAPES
             for qd, pds in ((bf16, (bf16, i8, e4m3)), (f32, (f32, i8, e4m3)))
             for pd in pds]
    for i, ((name, (q_lens, kv_lens), holes, timed), qd, pd) in \
            enumerate(cases):
        q, pages, scales, meta = paged_case(SEED + 100 + i, q_lens, kv_lens,
                                            qdtype=qd, pdtype=pd,
                                            hole_cols=holes)
        T, H, D = q.shape
        Hkv = pages.shape[2] // 2
        sm = D ** -0.5
        quant = scales is not None
        fn = rpa.ragged_paged_attention_quant if quant \
            else rpa.ragged_paged_attention
        ref = (rpa.ref_paged_attention_quant if quant
               else rpa.ref_paged_attention)
        args = (q, pages, scales, *meta) if quant else (q, pages, *meta)
        kname = "ragged_paged_attn_quant" if quant else "ragged_paged_attn"
        plain_out = fn(*args, sm_scale=sm)
        qpos = q_positions(q_lens, kv_lens, T)
        for label, carry in (
                ("neutral", neutral_carry(T, H, D, device="cuda")),
                ("random", random_carry(q, Hkv, SEED + 200 + i, qpos))):
            out = fn(*args, sm_scale=sm, carry=carry)
            want = ref(*args, sm_scale=sm, carry=carry)
            torch.cuda.synchronize()
            of, wf = out.float(), want.float()
            err = (of - wf).abs()
            atol = FP32_ATOL if qd == f32 else PAGED_ATOL
            rtol = FP32_ATOL if qd == f32 else PAGED_RTOL
            limit = atol + rtol * wf.abs()
            tag = f"paged carry {name} {label} q {str(qd)[6:]} pages " \
                  f"{str(pd)[6:]}"
            assert torch.isfinite(of).all(), f"{tag}: non-finite"
            assert (err <= limit).all(), (
                f"{tag}: differs from plain by up to {err.max().item():.3e}")
            if label == "neutral":
                # the neutral carry folds exactly
                assert torch.equal(out, plain_out), (
                    f"{tag}: differs from the call without a carry")
            if qd == bf16:
                worst[kname] = max(worst[kname], err.max().item())
            line = (f"{kname}[{name}, {label} carry] pages {str(pd)[6:]} q "
                    f"{str(qd)[6:]} T={T} H={H} D={D} S={len(q_lens)}: "
                    f"max|o-plain|={err.max().item():.3e} "
                    f"({(err / limit).max().item():.1%} of the limit)")
            if label == "neutral":
                line += "; bit-identical to no carry"
            if timed and label == "random" and qd == bf16:
                ms = graph_ms(lambda: fn(*args, sm_scale=sm, carry=carry))
                bound, by = paged_bound(q_lens, kv_lens, meta[1].cpu(), H,
                                        Hkv, D, pages.shape[1], qd, pd,
                                        carry=True)
                S, pp = meta[1].shape
                splits = rpa.split_plan(T, S, H, Hkv, pp, pages.shape[1])[0]
                line += (f"; splits {splits} + rpa_combine; kernel "
                         f"{ms:.4f} ms on the device, bound {bound:.4f} ms "
                         f"({by}: resident pages + carry + q + o), "
                         f"{bound / ms:.1%} of bound")
                if name == "lc_decode":
                    plain_ms = time_ms(
                        lambda: ref(*args, sm_scale=sm, carry=carry),
                        reps=3, warmup=1)
                    line += f", plain {plain_ms:.3f} ms"
                    if pd in (bf16, i8):
                        entries[kname] = dict(
                            name=f"{kname}_carry", route="cuda",
                            source="deepspeed_tpu_torch/ops/csrc/"
                                   "ragged_paged_attn.cu",
                            replaces=(
                                "deepspeed_tpu/ops/ragged_paged_quant.py:51"
                                if quant else
                                "deepspeed_tpu/inference/paged.py:602"),
                            launches=0, max_abs_err=0.0, ms=ms,
                            plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                            library_ms=None)
            log(line)
        del q, pages, scales, meta, out, want, plain_out
    for kname, e in entries.items():
        e["max_abs_err"] = worst[kname]
    log("paged carry: no PyTorch call reads a page table, so library_ms "
        "is null")
    torch.cuda.empty_cache()
    return entries["ragged_paged_attn"], entries["ragged_paged_attn_quant"]


# ---------------------------------------------------------------------------
# Phase 6: the v2 slice at full width and depth
# ---------------------------------------------------------------------------

# eager and unpipelined: phase 14 reruns this traffic with CUDA graphs and
# the pipeline, against these runs' tokens
V2 = dict(max_seqs=16, max_seq_len=2048, prefill_chunk=512, page_size=64,
          decode_block_size=8, pipeline=False)


def v2_traffic(n=24):
    """Prompts uniform in 128..1536 tokens, max_new_tokens uniform in
    32..128, from numpy seed 0; every third request samples (t 0.8,
    top-k 50, top-p 0.9), the rest are greedy."""
    rng = np.random.default_rng(SEED)
    lens = rng.integers(128, 1537, size=n)
    news = rng.integers(32, 129, size=n)
    reqs = []
    for i in range(n):
        kw = dict(max_new_tokens=int(news[i]))
        if i % 3 == 2:
            kw.update(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
        reqs.append((rng.integers(0, 128256, size=int(lens[i])), kw))
    return reqs


def serve(engine, reqs):
    """Submit every request, step until drained; returns the outputs by
    submission order and the run's numbers (fused-tick and decode-block
    wall time, prompt and decode-block tokens; decode blocks, their
    blocking fetches, and their host and device-wait seconds).  A
    pipelined step that dispatches a block may return 0 and its tokens
    come at a later harvest, which may be a step that dispatches nothing:
    block tokens count at harvests, block time over every such step.
    A CUDA graph's capture (with its eager warm-up block) happens in the
    step of its first block: its seconds are kept apart from block time
    (``capture_s``)."""
    uids = [engine.put_request(p, **kw) for p, kw in reqs]
    st = engine.host_stats
    K = engine.decode_block_size
    fused_s = block_s = block_host_s = block_dev_s = capture_s = 0.0
    block_tokens = blocks = block_gets = 0
    outs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work():
        ticks, gets, secs = st.ticks, st.blocking_gets, dict(st.seconds)
        captured = st.graph_capture_s
        t = time.perf_counter()
        produced = engine.step()
        dt = time.perf_counter() - t
        dticks = st.ticks - ticks
        if dticks == K > 1 or (dticks == 0 and produced and
                               engine.pipeline):
            blocks += dticks == K
            capture_s += st.graph_capture_s - captured
            block_s += dt - (st.graph_capture_s - captured)
            block_tokens += produced
            block_gets += st.blocking_gets - gets
            dev = st.seconds["device"] - secs["device"]
            block_dev_s += dev
            block_host_s += sum(st.seconds.values()) - sum(
                secs.values()) - dev
        else:
            fused_s += dt
        outs.update(engine.get_outputs())
    wall = time.perf_counter() - t0
    for (p, kw), uid in zip(reqs, uids):
        got = outs[uid]
        assert got.shape == (len(p) + kw["max_new_tokens"],), (
            f"uid {uid}: {got.shape[0]} tokens, want "
            f"{len(p) + kw['max_new_tokens']}")
        assert np.array_equal(got[:len(p)], p)
    audit = engine.audit_kv_sharing()
    st = engine.serving_stages()
    # a prefix cache keeps its resident entries' pages, the tiers its
    # demoted ones; a run leaves nothing else behind
    held = st.get("prefix_cache", {})
    assert audit["referenced"] == held.get("resident_entries", 0), \
        "pages still held after the run"
    if engine.tiering is not None:
        assert engine.tiering.audit()["sessions"] == held.get(
            "spilled_entries", 0), "spilled payloads left after the run"
    return [outs[u] for u in uids], dict(
        wall_s=wall, fused_s=fused_s, block_s=block_s,
        block_tokens=block_tokens, blocks=blocks, block_gets=block_gets,
        capture_s=capture_s,
        block_hbf=block_host_s / max(block_host_s + block_dev_s, 1e-12),
        decode_tps=block_tokens / max(block_s, 1e-9),
        prompt_tokens=int(sum(len(p) for p, _ in reqs)))


def phase_v2():
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    cfg = get_config("llama3-8b")
    L = cfg.num_hidden_layers
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    torch.cuda.synchronize()
    log(f"v2: llama3-8b engine up in {time.perf_counter() - t0:.1f} s, "
        f"{engine.num_pages} pages, pool {engine.cache_bytes() / 2**30:.3f}"
        f" GiB, {torch.cuda.memory_allocated() / 2**30:.2f} GiB on the "
        "card")
    reqs = v2_traffic()
    module = engine.module

    def fresh(**kw):
        # another engine over the same weights: new pools and uids
        return RaggedInferenceEngineV2(module, device="cuda", **{**V2, **kw})

    flash_before = flash_fwd.launches
    rpa.ragged_paged_attention.launches = 0    # the main path starts here
    rpa.ragged_paged_attention_quant.launches = 0
    out1, run1 = serve(engine, reqs)
    launches = rpa.ragged_paged_attention.launches
    st = engine.serving_stages()
    blocks = (engine.host_stats.ticks - engine.host_stats.dispatches) // (
        V2["decode_block_size"] - 1)
    assert launches == L * engine.host_stats.ticks, (
        f"{launches} paged-kernel launches, want {L} x "
        f"{engine.host_stats.ticks} ticks")
    assert flash_fwd.launches == flash_before, "v2 launched the flash kernel"
    assert rpa.ragged_paged_attention_quant.launches == 0
    peak = torch.cuda.max_memory_allocated() / 2**30
    rq = st["requests"]
    log(f"v2 run 1: 24 requests in {run1['wall_s']:.2f} s; prefill "
        f"{run1['prompt_tokens'] / run1['fused_s']:.0f} prompt tokens/s in "
        f"fused ticks ({run1['fused_s']:.2f} s); decode "
        f"{run1['block_tokens'] / max(run1['block_s'], 1e-9):.1f} tokens/s "
        f"in decode blocks ({run1['block_tokens']} tokens, "
        f"{run1['block_s']:.2f} s); TTFT p50 {rq['ttft_ms_p50']} ms p99 "
        f"{rq['ttft_ms_p99']} ms; TPOT p50 {rq['tpot_ms_p50']} ms; ticks "
        f"{engine.host_stats.ticks}, dispatches "
        f"{engine.host_stats.dispatches} ({blocks} decode blocks); "
        f"host_bound_fraction {st['host_bound_fraction']}; peak memory "
        f"{peak:.2f} GiB, pool {engine.cache_bytes() / 2**30:.3f} GiB; "
        f"paged launches {launches}")
    log(f"v2 run 1 stages: { {k: v for k, v in st.items() if k != 'requests'} }")
    del engine
    torch.cuda.empty_cache()

    engine = fresh()
    out2, run2 = serve(engine, reqs)
    for a, b in zip(out1, out2):
        assert np.array_equal(a, b), "the second run's tokens differ"
    log(f"v2 run 2: identical tokens for all 24 requests, "
        f"{run2['wall_s']:.2f} s")
    del engine
    torch.cuda.empty_cache()

    # a quarter of full provisioning: 1 + 16 * 8 = 129 pages.  Admission
    # backpressure keeps the 24-request traffic from ever stalling every
    # live sequence at once (what eviction needs); 16 equal decode-heavy
    # requests outgrow the pool in lockstep and must evict.
    tight = 1 + V2["max_seqs"] * (V2["max_seq_len"] // V2["page_size"] // 4)
    rng = np.random.default_rng(SEED + 2)
    heavy = [(rng.integers(0, cfg.vocab_size, size=100),
              dict(max_new_tokens=500)) for _ in range(V2["max_seqs"])]
    evictions = []
    for name, traffic in (("24-request traffic", reqs),
                          ("16 x (100 + 500) tokens", heavy)):
        engine = fresh(num_pages=tight)
        _, run3 = serve(engine, traffic)
        evictions.append(engine.evictions)
        log(f"v2 tight pool ({tight} pages), {name}: {engine.evictions} "
            f"evictions, all {len(traffic)} finished in "
            f"{run3['wall_s']:.2f} s ({engine.host_stats.ticks} ticks), "
            "audit clean")
        del engine
        torch.cuda.empty_cache()
    assert evictions[-1] > 0, "the decode-heavy traffic never evicted"

    rpa.ragged_paged_attention_quant.launches = 0  # kernel #8's main path
    quant_runs = []
    for fmt in ("int8", "fp8"):
        engine = fresh(kv_cache_dtype=fmt)
        before = rpa.ragged_paged_attention.launches
        outq, runq = serve(engine, reqs[:8])
        assert rpa.ragged_paged_attention.launches == before
        kvq = engine.serving_stages()["kv_quant"]
        same = sum(np.array_equal(a, b) for a, b in zip(outq, out1[:8]))
        log(f"v2 {fmt} pool: 8 requests in {runq['wall_s']:.2f} s, "
            f"pool {kvq['pool_bytes'] / 2**30:.3f} GiB via "
            f"{kvq['dequant_path']}, {same}/8 outputs equal to the bf16 "
            "pool's, audit clean")
        quant_runs.append(engine.host_stats.ticks * L)
        del engine
        torch.cuda.empty_cache()
    quant_launches = rpa.ragged_paged_attention_quant.launches
    assert quant_launches == sum(quant_runs) > 0, (
        f"kernel #8 launched {quant_launches} times, want {sum(quant_runs)}")
    del module
    gc.collect()
    torch.cuda.empty_cache()
    return launches, quant_launches, out1, dict(run1, peak=peak)


# ---------------------------------------------------------------------------
# Phase 7: v2 on the card against v2 on the CPU
# ---------------------------------------------------------------------------

def phase_v2_cpu_parity(cfg, state, runs=(("none", None), ("int8", None))):
    """v2 on the card against v2 on the CPU, for each (KV pool format,
    weight format) of ``runs``; int8 weights quantized on the two must be
    byte-identical."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (37, 100, 300, 513)]
    kw = dict(max_seqs=4, max_seq_len=640, prefill_chunk=128, page_size=64,
              decode_block_size=4)
    for fmt, wq in runs:
        label = f"{fmt} pool" + ("" if wq is None else f", {wq} weights")
        toks, engines = {}, {}
        for dev in ("cuda", "cpu"):
            with torch.device("meta"):
                model = LlamaForCausalLM(cfg)
            eng = RaggedInferenceEngineV2(model, params=state, device=dev,
                                          kv_cache_dtype=fmt,
                                          quantize_weights=wq, **kw)
            outs = eng.generate_all(prompts, max_new_tokens=16)
            toks[dev] = [outs[u] for u in sorted(outs)]
            eng.audit_kv_sharing()
            engines[dev] = eng
        if wq is not None:
            card = dict(engines["cuda"].module.named_buffers())
            cpu = dict(engines["cpu"].module.named_buffers())
            assert card.keys() == cpu.keys() and len(card) > 0
            for name, b in card.items():
                assert torch.equal(b.cpu().view(torch.int8),
                                   cpu[name].view(torch.int8)), (
                    f"{name}: the card's quantized buffer differs")
            log(f"v2 parity, {wq} weights: {len(card)} buffers "
                f"({sum(b.numel() * b.element_size() for b in cpu.values())}"
                " bytes) quantized on the card and on the CPU are "
                "byte-identical")
        cpu_model = engines["cpu"].module
        del engines
        worst = math.inf
        for p, got, want in zip(prompts, toks["cuda"], toks["cpu"]):
            with torch.no_grad():
                logits = cpu_model(torch.from_numpy(want[None, :-1]))[0]
            top2 = logits[len(p) - 1:].topk(2, dim=-1).values
            margins = (top2[:, 0] - top2[:, 1]).numpy()
            worst = min(worst, float(margins.min()))
            diff = np.nonzero(got != want)[0]
            if diff.size:
                i = int(diff[0]) - len(p)
                log(f"v2 parity {label}: prompt {len(p)}: first differing "
                    f"token {i}, CPU top-2 margin {margins[i]:.3e}")
                assert margins[i] < MARGIN, (
                    f"card and CPU tokens differ at {i} with margin "
                    f"{margins[i]:.3e}")
        same = sum(np.array_equal(a, b)
                   for a, b in zip(toks["cuda"], toks["cpu"]))
        log(f"v2 parity, 2 layers fp32, {label}: {same}/4 requests "
            f"token-equal card vs CPU; smallest CPU top-2 margin "
            f"{worst:.3e}")
        del cpu_model
        gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 8: the training kernels against their plain versions
# ---------------------------------------------------------------------------

# bf16 gradients: P and dS round to bf16 from fp32 values that kernel and
# plain version sum in another order, and each rounds dq, dk, dv to bf16
# once (rtol: one bf16 ulp, 2^-8 relative, and some); atol sits an order
# under the gradients' median size (2e-2 to 8e-2 at these shapes);
# fp32: full fp32 products
BWD_ATOL, BWD_RTOL = 3e-3, 2e-2
BWD_FP32_TOL = 2e-4
OPT_RTOL, OPT_ATOL = 1e-6, 1e-7      # fp32 elementwise; FMA contraction


def bwd_bound(which, B, H, Hkv, S, Sk, D, causal, dtype):
    """Least time (ms) of one backward kernel and what bounds it: 6*D
    operations per valid (q head, key) pair for dQ (QK^T, dO V^T, dS K)
    and 8*D for dK/dV (K Q^T, V dO^T, P^T dO, dS^T Q); bytes: q, k, v,
    dO, lse and delta read once, the gradients it writes written once."""
    elem = torch.finfo(dtype).bits // 8
    ops = (6 if which == "dq" else 8) * D * B * H * pairs_of(S, Sk, causal)
    nbytes = elem * (2 * B * H * S * D + 2 * B * Hkv * Sk * D) + 8 * B * H * S
    nbytes += elem * (B * H * S * D if which == "dq" else 2 * B * Hkv * Sk * D)
    peak = PEAK_BF16 if dtype == torch.bfloat16 else PEAK_FP32
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def sdpa_backward(q, k, v, do):
    """(ms, backend name) of SDPA's causal backward alone, its graph kept
    alive, on the fastest of the flash, cuDNN and efficient backends that
    take these inputs, each pinned in turn.  A yardstick only: the port
    never calls SDPA."""
    from torch.nn import functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    times = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(
                    *leaves, is_causal=True, enable_gqa=True)
                times[backend.name] = time_ms(lambda: torch.autograd.grad(
                    out, leaves, do, retain_graph=True))
        except RuntimeError:
            continue
        del out, leaves
    assert times, "no SDPA backend takes these inputs"
    best = min(times, key=times.get)
    return times[best], f"{best}; " + ", ".join(
        f"{b} {t:.4f} ms" for b, t in times.items())


def phase_train_kernels():
    from deepspeed_tpu_torch.ops import flash_attention as fa

    bf16, f32 = torch.bfloat16, torch.float32
    shapes = [  # name, B, H, Hkv, S, Sk, D, causal, dtype
        ("train", 4, 32, 4, 2048, 2048, 64, True, bf16),
        ("d128_tail", 2, 32, 8, 1000, 1000, 128, True, bf16),
        ("sk_gt_s", 2, 32, 8, 600, 1000, 128, True, bf16),
        ("masked_rows", 2, 32, 8, 1000, 600, 128, True, bf16),
        ("fp32", 1, 8, 2, 300, 300, 128, True, f32),
        ("fp32_d64_cross", 1, 8, 2, 200, 260, 64, False, f32),
    ]
    entries = {}
    for i, (name, B, H, Hkv, S, Sk, D, causal, dtype) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 100 + i)
        q, k, v = _qkv(gen, B, H, Hkv, S, Sk, D, dtype)
        do = torch.randn(B, S, H, D, generator=gen, device="cuda",
                         dtype=dtype).transpose(1, 2)
        o, lse = fa.flash_fwd(q, k, v, causal=causal)
        # the forward at the same shape: the backward below takes its o and
        # lse on both sides, so a wrong forward would not show there
        fwd_err = check_fwd(f"fwd {name}", o, lse,
                            *fa.flash_fwd_reference(q, k, v, causal=causal),
                            dtype)
        got = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
        want = fa.flash_bwd_reference(q, k, v, o, lse, do, causal=causal)
        torch.cuda.synchronize()
        atol, rtol = (BWD_ATOL, BWD_RTOL) if dtype == bf16 else \
            (BWD_FP32_TOL, BWD_FP32_TOL)
        errs = {}
        for gname, a, b in zip(("dq", "dk", "dv"), got, want):
            af, bf = a.float(), b.float()
            err = (af - bf).abs()
            assert torch.isfinite(af).all(), f"bwd {name}: non-finite {gname}"
            assert (err <= atol + rtol * bf.abs()).all(), (
                f"bwd {name}: {gname} differs from plain by up to "
                f"{err.max().item():.3e}")
            # the least atol that would pass at this rtol
            need = (err - rtol * bf.abs()).clamp_min(0).max().item()
            errs[gname] = (err.max().item(), bf.abs().median().item(), need)
        if causal and Sk < S:
            assert (got[0][:, :, :S - Sk] == 0).all(), "masked rows' dq"
        line = (f"flash_bwd[{name}] B={B} H={H} Hkv={Hkv} S={S} Sk={Sk} "
                f"D={D} causal={causal} {dtype}: forward max|o-plain|="
                f"{fwd_err[0]:.3e} max|lse-plain|={fwd_err[1]:.3e}; " +
                ", ".join(f"max|{g}-plain|={e:.3e} (median |{g}| {m:.3e}, "
                          f"atol needed at rtol {rtol:g}: {n:.3e} of {atol:g})"
                          for g, (e, m, n) in errs.items()))
        if name == "train":
            # deterministic: no atomics, so a second call is bit-identical
            again = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
            assert all(torch.equal(a, b) for a, b in zip(got, again)), \
                "bwd train: two calls differ"
            line += "; a second call bit-identical"
            del again
            delta = fa.bwd_delta(do, o)
            ms = {"dq": time_ms(lambda: fa.flash_bwd_dq(
                      q, k, v, do, lse, delta, causal)),
                  "dkv": time_ms(lambda: fa.flash_bwd_dkv(
                      q, k, v, do, lse, delta, causal))}
            plain_ms = time_ms(lambda: fa.flash_bwd_reference(
                q, k, v, o, lse, do, causal=causal), reps=3, warmup=1)
            # yardstick: the SDPA backward alone (its graph kept alive),
            # on its fastest backend, named
            lib_ms, backend = sdpa_backward(q, k, v, do)
            for which, kname in (("dq", "flash_bwd_dq"),
                                 ("dkv", "flash_bwd_dkv")):
                bound, by = bwd_bound(which, B, H, Hkv, S, Sk, D, causal,
                                      dtype)
                err = errs["dq"][0] if which == "dq" else max(
                    errs["dk"][0], errs["dv"][0])
                entries[kname] = dict(
                    name=kname, route="cuda",
                    source="deepspeed_tpu_torch/ops/csrc/flash_bwd.cu",
                    replaces=("deepspeed_tpu/ops/flash_attention.py:364"
                              if which == "dq" else
                              "deepspeed_tpu/ops/flash_attention.py:419"),
                    launches=0, max_abs_err=err, ms=ms[which],
                    plain_ms=plain_ms, bound_ms=bound, bound_by=by,
                    library_ms=lib_ms)
                line += (f"; {kname} {ms[which]:.4f} ms, bound {bound:.4f} "
                         f"ms ({by}), {bound / ms[which]:.1%} of bound")
            line += (f"; plain (dq, dk, dv) {plain_ms:.3f} ms; SDPA "
                     f"backward ({backend}) {lib_ms:.4f} ms")
        log(line)
        del q, k, v, do, o, lse, got, want
    torch.cuda.empty_cache()
    entries.update(phase_opt_kernels())
    return entries


def phase_opt_kernels():
    """Fused Adam and Lion over one flat buffer of llama-1b's parameter
    count, against their plain versions; timed beside their byte bounds
    and, for Adam, ``torch.optim.AdamW(fused=True).step``."""
    from deepspeed_tpu_torch.models.llama import LlamaLMLoss, get_config
    from deepspeed_tpu_torch.ops import fused_adam as fo

    with torch.device("meta"):
        n = sum(p.numel() for p in LlamaLMLoss(get_config(
            "llama-1b")).parameters())
    gen = torch.Generator(device="cuda").manual_seed(SEED + 200)
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda") * 1e-2
    m = torch.randn(n, generator=gen, device="cuda") * 1e-3
    v = torch.rand(n, generator=gen, device="cuda") * 1e-4
    w = p.to(torch.bfloat16)
    sc = torch.tensor([3e-4, 0.19, 0.0975, 0.5, 0.0], device="cuda")
    entries = {}
    # the kernel updates the buffers themselves (the plain version a copy),
    # so that kernel, plain temporaries and copies fit the card together
    state = [p, m, v, w]
    for opt in ("adam", "adamw", "lion"):
        ref = [t.clone() for t in state]
        if opt == "lion":
            kw = dict(b1=0.9, b2=0.99, wd=0.1)
            fo.fused_lion(state[0], g, state[1], sc, state[3], **kw)
            fo.lion_update_reference(ref[0], g, ref[1], sc, ref[3], **kw)
            run = lambda: fo.fused_lion(state[0], g, state[1], sc,
                                        state[3], **kw)
            plain = lambda: fo.lion_update_reference(
                ref[0], g, ref[1], sc, ref[3], **kw)
            nbytes = n * (12 + 8 + 2)        # p, g, m in; p, m, w out
        else:
            kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1,
                      adam_w=opt == "adamw")
            fo.fused_adam(state[0], g, state[1], state[2], sc, state[3],
                          **kw)
            fo.adam_update_reference(ref[0], g, ref[1], ref[2], sc, ref[3],
                                     **kw)
            run = lambda: fo.fused_adam(state[0], g, state[1], state[2],
                                        sc, state[3], **kw)
            plain = lambda: fo.adam_update_reference(
                ref[0], g, ref[1], ref[2], sc, ref[3], **kw)
            nbytes = n * (16 + 12 + 2)       # p, g, m, v in; p, m, v, w out
        torch.cuda.synchronize()
        err = 0.0
        for a, b in zip(state[:3], ref[:3]):
            if opt == "lion" and a is state[2]:
                continue
            d = (a - b).abs()
            assert (d <= OPT_ATOL + OPT_RTOL * b.abs()).all(), (
                f"{opt}: differs from plain by up to {d.max().item():.3e}")
            err = max(err, d.max().item())
        assert torch.equal(state[3], state[0].to(torch.bfloat16))
        ms = time_ms(run, reps=10, warmup=2)
        plain_ms = time_ms(plain, reps=3, warmup=1)
        bound = nbytes / PEAK_BYTES * 1e3
        lib_ms = lib_copy_ms = None
        if opt == "adamw":
            param = torch.nn.Parameter(p.clone())
            param.grad = g
            topt = torch.optim.AdamW([param], lr=3e-4, betas=(0.9, 0.95),
                                     weight_decay=0.1, fused=True)
            lib_ms = time_ms(topt.step, reps=10, warmup=2)
            # the kernel's work: the step and the bf16 working copy

            def step_and_copy():
                topt.step()
                w.copy_(param.detach())
            lib_copy_ms = time_ms(step_and_copy, reps=10, warmup=2)
            del param, topt
        log(f"{opt} over {n} fp32 parameters (+ bf16 copy): max|kernel-"
            f"plain|={err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms,"
            f" bound {bound:.3f} ms (bytes), {bound / ms:.1%} of bound"
            + (f"; torch AdamW(fused=True).step {lib_ms:.3f} ms (no bf16 "
               f"copy), the step and the bf16 copy_ (the kernel's work) "
               f"{lib_copy_ms:.3f} ms, {bound / lib_copy_ms:.1%} of bound"
               if lib_ms is not None else ""))
        kname = "fused_lion" if opt == "lion" else "fused_adam"
        if opt != "adam":           # the slice runs AdamW and Lion
            entries[kname] = dict(
                name=kname, route="cuda",
                source="deepspeed_tpu_torch/ops/csrc/fused_adam.cu",
                replaces=("deepspeed_tpu/ops/fused_adam.py:75"
                          if opt == "lion" else
                          "deepspeed_tpu/ops/fused_adam.py:52"),
                launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=lib_ms)
        del ref
        torch.cuda.empty_cache()
    del p, g, m, v, w, state
    torch.cuda.empty_cache()
    return entries


# ---------------------------------------------------------------------------
# Phase 9: the training slice at full width and depth
# ---------------------------------------------------------------------------

def train_config(opt="AdamW", lr=3e-4, **kw):
    cfg = {"train_micro_batch_size_per_gpu": 4,
           "gradient_accumulation_steps": 2,
           "bf16": {"enabled": True},
           "optimizer": {"type": opt, "params": {
               "lr": lr, "weight_decay": 0.1, "fused": True,
               "betas": [0.9, 0.95]}},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_min_lr": lr / 10, "warmup_max_lr": lr,
               "warmup_num_steps": 3, "warmup_type": "linear"}},
           "gradient_clipping": 1.0, "steps_per_print": 1000}
    cfg.update(kw)
    return cfg


def phase_train():
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import (LlamaLMLoss,
                                                  flops_per_token,
                                                  get_config)
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fo

    cfg = get_config("llama-1b")
    L, S = cfg.num_hidden_layers, 2048
    batch = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                 size=(8, S))
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                fo.fused_adam, fo.fused_lion)
    for c in counters:                  # the main path's run starts here
        c.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaLMLoss(cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=train_config(),
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    log(f"train: llama-1b engine up in {time.perf_counter() - t0:.1f} s, "
        f"{engine.num_parameters / 1e9:.4f} B params, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    losses, step_s = [], []
    for step in range(10):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t = time.perf_counter()
        loss = float(engine.train_batch(batch=batch))
        step_s.append(time.perf_counter() - t)
        losses.append(loss)
        got = [c.launches - b for c, b in zip(counters, before)]
        want = [L * 2 * 2, L * 2, L * 2, 1, 0]
        assert got == want, f"step {step}: launches {got}, want {want}"
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(math.isfinite(x) for x in losses), losses
    assert losses[-1] < losses[0] - 0.5, f"loss did not fall: {losses}"
    steady = float(np.median(step_s[2:]))
    tokens = 8 * S
    tps = tokens / steady
    mfu = flops_per_token(cfg, S) * tps / PEAK_BF16
    log(f"train: 10 AdamW steps of {tokens} tokens: losses "
        f"{[round(x, 4) for x in losses]}; step {steady * 1e3:.1f} ms "
        f"(median of steps 3-10; first {step_s[0] * 1e3:.1f} ms), "
        f"{tps:.0f} tokens/s, MFU {mfu:.1%} (flops_per_token "
        f"{flops_per_token(cfg, S):.4e}); peak memory {peak:.2f} GiB; "
        f"grad norm {engine.get_global_grad_norm():.4f}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()

    with torch.device("meta"):
        model = LlamaLMLoss(cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=train_config("Lion", lr=3e-5),
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    lion = [float(engine.train_batch(batch=batch)) for _ in range(3)]
    assert all(math.isfinite(x) for x in lion), lion
    launches = {c.__name__: c.launches for c in counters}
    assert launches["fused_lion"] == 3 and launches["fused_adam"] == 10, \
        launches
    log(f"train: 3 Lion steps: losses {[round(x, 4) for x in lion]}; "
        f"launches over the phase {launches}")
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, {"AdamW": losses, "Lion": lion,
                      "step_ms": steady * 1e3, "peak_gib": peak}


# ---------------------------------------------------------------------------
# Phase 10: training on the card against the CPU; checkpoint resume
# ---------------------------------------------------------------------------

TRAIN_LOSS_RTOL = 1e-4   # fp32 both sides, summation order only
# params: x lr x steps.  Adam's direction is ~sign(g) where |g| is small,
# so an element whose tiny gradient the card and the CPU sum to different
# values moves apart by up to 2 lr in a step (0.037 x lr x steps observed)
TRAIN_PARAM_TOL = 0.1


def phase_train_cpu_parity():
    import shutil

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaLMLoss, get_config
    from deepspeed_tpu_torch.module_inject.flax_bridge import \
        flax_to_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama-1b", num_hidden_layers=2, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 3)
    tree = flax_tree(cfg, rng)
    state = {f"lm.{k}": v for k, v in flax_to_state_dict(tree).items()}
    batches = [rng.integers(0, cfg.vocab_size, size=(4, 128))
               for _ in range(5)]
    lr = 1e-3
    conf = {"train_micro_batch_size_per_gpu": 2,
            "gradient_accumulation_steps": 2, "gradient_clipping": 1.0,
            "optimizer": {"type": "AdamW", "params": {
                "lr": lr, "weight_decay": 0.1, "fused": True}},
            "steps_per_print": 1000}

    def make(dev):
        with torch.device("meta"):
            model = LlamaLMLoss(cfg)
        return deepspeed_tpu_torch.initialize(
            model=model, model_parameters=state, config=conf,
            device=dev)[0]

    losses, params = {}, {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        eng = make(dev)
        losses[dev] = [float(eng.train_batch(batch=b)) for b in batches[:3]]
        params[dev] = eng.state.params.cpu()
        log(f"train parity: 3 steps on {dev} in "
            f"{time.perf_counter() - t0:.1f} s: {losses[dev]}")
        if dev == "cuda":
            card = eng
        else:
            del eng
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                   losses["cpu"]))
    diff = (params["cuda"] - params["cpu"]).abs()
    perr = diff.max().item()
    frac = (diff > 1e-6).float().mean().item()
    log(f"train parity: 2 layers fp32, card vs CPU: losses max rel diff "
        f"{rel:.3e} (limit {TRAIN_LOSS_RTOL}), params max|diff| {perr:.3e} "
        f"(limit {TRAIN_PARAM_TOL * lr * 3:.1e}); {frac:.3e} of them more "
        "than 1e-6 apart")
    assert rel <= TRAIN_LOSS_RTOL and perr <= TRAIN_PARAM_TOL * lr * 3

    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    card.save_checkpoint(ckpt)
    cont = [float(card.train_batch(batch=b)) for b in batches[3:]]
    want = card.state.params.clone()
    del card
    gc.collect()
    fresh = make("cuda")
    path, _ = fresh.load_checkpoint(ckpt)
    assert path is not None and fresh.global_steps == 3
    again = [float(fresh.train_batch(batch=b)) for b in batches[3:]]
    same = torch.equal(fresh.state.params, want)
    log(f"train resume: losses {cont} then {again} after "
        f"load_checkpoint; params bit-identical: {same}")
    assert again == cont and same, "the resumed run differs"
    del fresh, want
    shutil.rmtree(ckpt, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 11: the quantization kernels against their plain versions
# ---------------------------------------------------------------------------

def quant_bound(n, gs, elem):
    """Least time (ms) of one quantize or dequantize of ``n`` elements of
    ``elem`` bytes in groups of ``gs``, and what bounds it.  Bytes: the
    values once, the int8 payload (tail padding included) once, fp32 scale
    and offset once; the same either way.  Operations: 7 a value for
    quantize (max, min, subtract, divide, round, two clamps) at the fp32
    rate, the larger of the two kernels' counts."""
    groups = -(-n // gs)
    nbytes = n * elem + groups * gs + 8 * groups
    t_bytes, t_ops = nbytes / PEAK_BYTES, 7 * n / PEAK_FP32
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def phase_quant_kernels():
    from deepspeed_tpu_torch.ops import quantization as qz

    bf16, f16, f32 = torch.bfloat16, torch.float16, torch.float32
    gate, embed, flat = (4096, 14336), (128256, 4096), (1 << 26,)
    # name, shape, group size, dtype, bits, symmetric, timed.  The ZeRO++
    # cases are a flat shard of 2^26 values at groups of 2048, as the
    # quantized all-gather and reduce-scatter quantize one
    cases = [("gate_proj_g128", gate, 128, bf16, 8, True, True),
             ("gate_proj_g2048", gate, 2048, bf16, 8, True, True),
             ("embedding_g128", embed, 128, bf16, 8, True, False),
             ("embedding_g2048", embed, 2048, bf16, 8, True, False),
             ("gate_proj_fp32_asym4", gate, 128, f32, 4, False, False)]
    cases += [(f"tail_{str(dt)[6:]}_{bits}b_{'sym' if sym else 'asym'}",
               (1000, 1001), 128, dt, bits, sym, False)
              for dt in (bf16, f32) for bits in (8, 4) for sym in (True,
                                                                   False)]
    # one element per access: n, then the group size, off the vector width
    cases += [("odd_n_bf16", (999, 1001), 128, bf16, 8, True, False),
              ("odd_group_fp32_asym", (300, 77), 100, f32, 8, False, False)]
    # the ring's other lane splits (4 and 8 lanes a group), fp16 input
    cases += [("gate_proj_g32", gate, 32, bf16, 8, True, False),
              ("gate_proj_g64_asym", gate, 64, bf16, 8, False, False),
              ("gate_proj_fp16", gate, 128, f16, 8, True, False),
              ("zero_fp32_g2048", flat, 2048, f32, 8, True, True),
              ("zero_bf16_4b_g2048", flat, 2048, bf16, 4, True, True)]
    entries = {}
    worst = {"quantize": 0.0, "dequantize": 0.0}
    for i, (name, shape, gs, dtype, bits, sym, timed) in enumerate(cases):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 300 + i)
        # rows of mixed magnitude, as trained weights have
        rows = shape[0] if len(shape) > 1 else 4096
        x = (torch.randn(rows, math.prod(shape) // rows, generator=gen,
                         device="cuda") *
             torch.rand(rows, 1, generator=gen, device="cuda") * 3
             ).to(dtype).reshape(shape)
        kw = dict(num_bits=bits, group_size=gs, symmetric=sym)
        got = qz.quantize(x, **kw)
        back = qz.dequantize(got)
        want = qz.quantize_reference(x, **kw)
        want_back = qz.dequantize_reference(want)
        torch.cuda.synchronize()
        word = torch.int16 if x.element_size() == 2 else torch.int32
        same = [torch.equal(got.values, want.values),
                torch.equal(got.scale.view(torch.int32),
                            want.scale.view(torch.int32)),
                torch.equal(got.offset.view(torch.int32),
                            want.offset.view(torch.int32)),
                torch.equal(back.view(word), want_back.view(word))]
        assert all(same), (f"quant[{name}]: payload, scale, offset, output "
                           f"bit-identical: {same}")
        worst["quantize"] = max(
            worst["quantize"],
            (got.values.int() - want.values.int()).abs().max().item(),
            (got.scale - want.scale).abs().max().item(),
            (got.offset - want.offset).abs().max().item())
        worst["dequantize"] = max(
            worst["dequantize"],
            (back.float() - want_back.float()).abs().max().item())
        n = x.numel()
        line = (f"quant[{name}] {list(shape)} groups of {gs} {dtype} "
                f"{bits}-bit {'symmetric' if sym else 'asymmetric'}: "
                "payload, scale, offset and dequantized output "
                "bit-identical to plain")
        if timed:
            bound, by = quant_bound(n, gs, x.element_size())
            # device time: 20 calls in a CUDA graph, replayed, so that the
            # wrapper's host time per call is not in it
            ms_q = graph_ms(lambda: qz.quantize(x, **kw))
            ms_d = graph_ms(lambda: qz.dequantize(got))
            host_q = time_ms(lambda: qz.quantize(x, **kw))
            host_d = time_ms(lambda: qz.dequantize(got))
            plain_q = time_ms(lambda: qz.quantize_reference(x, **kw),
                              reps=3, warmup=1)
            plain_d = time_ms(lambda: qz.dequantize_reference(got), reps=3,
                              warmup=1)
            line += (f"; device time quantize {ms_q:.4f} ms (plain "
                     f"{plain_q:.3f} ms), dequantize {ms_d:.4f} ms (plain "
                     f"{plain_d:.3f} ms), bound {bound:.4f} ms ({by}) each: "
                     f"{bound / ms_q:.1%} and {bound / ms_d:.1%} of bound; "
                     f"the wrapper in a host loop (what an uncaptured "
                     f"caller sees) {host_q:.4f} and {host_d:.4f} ms")
            for kname, ms, plain_ms, line_no in (
                    (f"quantize_int8_g{gs}", ms_q, plain_q, 41),
                    (f"dequantize_int8_g{gs}", ms_d, plain_d, 59)):
                if not name.startswith("gate_proj"):
                    continue    # the kernels line reports gate_proj
                entries[kname] = dict(
                    name=kname, route="cuda",
                    source="deepspeed_tpu_torch/ops/csrc/quantization.cu",
                    replaces=f"deepspeed_tpu/ops/quantization.py:{line_no}",
                    launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None)
        log(line)
        del x, got, back, want, want_back
        torch.cuda.empty_cache()
    for kname, e in entries.items():
        e["max_abs_err"] = worst[kname.split("_")[0]]
    log("quantization kernels: no single PyTorch call computes group-wise "
        "absmax quantization or its inverse, so library_ms is null")
    return entries


# ---------------------------------------------------------------------------
# Phase 12: int8 weight-only serving through v1 and v2
# ---------------------------------------------------------------------------

def resident_bytes(module) -> int:
    return sum(t.numel() * t.element_size()
               for t in [*module.parameters(), *module.buffers()])


def phase_int8_v1(bf16_greedy):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    cfg = get_config("llama3-8b")
    B, P, NEW = 4, 1000, 64
    n_weights = 7 * cfg.num_hidden_layers + 2
    qz.quantize.launches = qz.dequantize.launches = 0   # the path starts
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "max_out_tokens": 2048,
                       "quant": {"enabled": True, "qtype": "int8"}},
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    assert qz.quantize.launches == n_weights, qz.quantize.launches
    weights = resident_bytes(engine.module)
    log(f"int8 v1: llama3-8b up in {time.perf_counter() - t0:.3f} s; "
        f"{qz.quantize.launches} weights quantized (groups of 128); "
        f"resident weights {weights / 2**30:.3f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    torch.cuda.reset_peak_memory_stats()    # building held the bf16 weights
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(SEED))

    def run(new):
        before = (flash_fwd.launches, qz.dequantize.launches)
        t = time.perf_counter()
        out = engine.generate(prompts, max_new_tokens=new)
        dt = time.perf_counter() - t
        got = (flash_fwd.launches - before[0],
               qz.dequantize.launches - before[1])
        assert got == (cfg.num_hidden_layers, n_weights * new), (
            f"generate({new}) launched (flash, dequantize) {got}, want "
            f"{(cfg.num_hidden_layers, n_weights * new)}")
        assert out.shape == (B, P + new) and torch.equal(out[:, :P], prompts)
        assert ((out[:, P:] >= 0) & (out[:, P:] < cfg.vocab_size)).all()
        return out, dt

    logits = engine.forward(prompts[:, :16])
    assert logits.shape == (B, 16, cfg.vocab_size)
    assert torch.isfinite(logits).all(), "non-finite int8 logits"
    del logits
    greedy1, t1 = run(NEW)
    greedy2, t2 = run(NEW)
    _, tp1 = run(1)
    _, tp2 = run(1)
    assert torch.equal(greedy1, greedy2), "int8 greedy runs differ"
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = (greedy1[:, P:] == bf16_greedy[:, P:]).float().mean().item()
    log(f"int8 v1: generate {B}x{P}+{NEW}: {t1:.3f} s (first), {t2:.3f} s; "
        f"prefill (generate 1 token) {tp1 * 1e3:.1f} / {tp2 * 1e3:.1f} ms; "
        f"decode {B * (NEW - 1) / (t2 - tp2):.1f} tokens/s "
        f"({(t2 - tp2) / (NEW - 1) * 1e3:.2f} ms/step at batch {B}); peak "
        f"memory while serving {peak:.2f} GiB; greedy tokens identical "
        f"twice; {same:.1%} of them equal to the bf16 run's; launches "
        f"quantize {qz.quantize.launches}, dequantize "
        f"{qz.dequantize.launches}")
    launches = (qz.quantize.launches, qz.dequantize.launches)
    del engine, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_int8_v2(bf16_outs):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = get_config("llama3-8b")
    L = cfg.num_hidden_layers
    n_weights = 7 * L + 2
    qz.quantize.launches = qz.dequantize.launches = 0   # the path starts
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", quantize_weights="int8", **V2)
    torch.cuda.synchronize()
    assert qz.quantize.launches == n_weights, qz.quantize.launches
    module = engine.module
    weights = resident_bytes(module)
    log(f"int8 v2: llama3-8b engine up in {time.perf_counter() - t0:.3f} s;"
        f" {qz.quantize.launches} weights quantized (groups of 2048); "
        f"resident weights {weights / 2**30:.3f} GiB, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB on the card")
    torch.cuda.reset_peak_memory_stats()
    reqs = v2_traffic()
    outs, ticks, runs = [], 0, []
    for run in (1, 2):
        if run == 2:    # a second engine over the same quantized weights
            engine = RaggedInferenceEngineV2(module, device="cuda", **V2)
        before = (qz.dequantize.launches, rpa.ragged_paged_attention.launches)
        out, r = serve(engine, reqs)
        t = engine.host_stats.ticks
        got = (qz.dequantize.launches - before[0],
               rpa.ragged_paged_attention.launches - before[1])
        assert got == (n_weights * t, L * t), (
            f"run {run}: (dequantize, paged) launches {got}, want "
            f"{(n_weights * t, L * t)}")
        ticks += t
        outs.append(out)
        runs.append(r)
        st = engine.serving_stages()
        rq = st["requests"]
        log(f"int8 v2 run {run}: 24 requests in {r['wall_s']:.2f} s; prefill "
            f"{r['prompt_tokens'] / r['fused_s']:.0f} prompt tokens/s in "
            f"fused ticks ({r['fused_s']:.2f} s); decode "
            f"{r['block_tokens'] / max(r['block_s'], 1e-9):.1f} tokens/s in "
            f"decode blocks ({r['block_tokens']} tokens, {r['block_s']:.2f} "
            f"s); TTFT p50 {rq['ttft_ms_p50']} ms p99 {rq['ttft_ms_p99']} ms;"
            f" TPOT p50 {rq['tpot_ms_p50']} ms; ticks {t}; "
            f"host_bound_fraction {st['host_bound_fraction']}; audit clean")
        del engine
    for a, b in zip(*outs):
        assert np.array_equal(a, b), "the second int8 run's tokens differ"
    peak = torch.cuda.max_memory_allocated() / 2**30
    same = sum(np.array_equal(a, b) for a, b in zip(outs[0], bf16_outs))
    log(f"int8 v2: identical tokens for all 24 requests twice; {same}/24 "
        f"equal to the bf16 run's; peak memory while serving {peak:.2f} "
        f"GiB; launches over the phase: quantize {qz.quantize.launches}, "
        f"dequantize {qz.dequantize.launches} ({n_weights} x {ticks} ticks)")
    launches = (qz.quantize.launches, qz.dequantize.launches)
    del module, model
    gc.collect()
    torch.cuda.empty_cache()
    return launches, outs[0], dict(runs[0], peak=peak)


def phase_int8_cpu_parity():
    """Phase 12(c), the card's half: one llama3-8b layer at full width and
    vocabulary in fp32 through v2 with int8 weights.  The CPU's half comes
    from the :class:`CPUSide` worker, and :func:`parity_compare` holds the
    two together in phase 22."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = parity_half("int8", "cuda")
    card["module"] = None          # the int8 rule needs no card forward
    gc.collect()
    torch.cuda.empty_cache()
    return card


# ---------------------------------------------------------------------------
# Phase 13: ZeRO stages 1-3 over NCCL at full width and depth
# ---------------------------------------------------------------------------

STAGE_LOSS_RTOL = 2e-3   # the reference's tests/unit/test_engine.py:55
# the layers of phases 13's and 17's checkpoint legs, at full width
CKPT_LAYERS = 2


def zero_run(cfg, config, batch, steps):
    """``steps`` train_batch calls on a fresh engine: losses, step ms,
    peak GiB of the init and of the steps, and each step's
    fused-optimizer launches and collectives (by the engine's log names)
    checked exactly against the plan, every one of them through the
    process group (``comm.backend_calls``), none a local copy."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import LlamaLMLoss
    from deepspeed_tpu_torch.ops import fused_adam as fo

    opt = fo.fused_lion if config["optimizer"]["type"] == "Lion" \
        else fo.fused_adam
    opt.launches = 0                    # the main path's run starts here
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.device("meta"):
        model = LlamaLMLoss(cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    peaks = [torch.cuda.max_memory_allocated() / 2**30]
    torch.cuda.reset_peak_memory_stats()
    want = engine.plan.step_collectives(engine.gas)
    losses, step_ms = [], []
    for step in range(steps):
        before, launched = comm.comms_logger.counts(), opt.launches
        through = dict(comm.backend_calls)
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        after = comm.comms_logger.counts()
        got = {k: after[k] - before.get(k, 0) for k in after
               if after[k] != before.get(k, 0)}
        assert got == want, f"step {step}: collectives {got}, plan {want}"
        nccl = {k: v - through.get(k, 0) for k, v in
                comm.backend_calls.items() if v != through.get(k, 0)}
        assert nccl == want, \
            f"step {step}: through the process group {nccl}, plan {want}"
        assert opt.launches - launched == 1, \
            f"step {step}: {opt.launches - launched} {opt.__name__} launches"
    peaks.append(torch.cuda.max_memory_allocated() / 2**30)
    return engine, model, losses, step_ms, peaks, want


def phase_zero(stage0):
    """ZeRO stages 1-3 through ``initialize`` over an NCCL process group,
    at ``llama-1b``'s full width and depth on phase 9's seed and batch,
    against phase 9's stage-0 losses; a stage-3 engine's partitioned
    checkpoint (CKPT_LAYERS layers) resumes bit-identically."""
    import shutil

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.llama import get_config

    # one rank: NCCL puts one rank on each card, and the run needs one
    comm.init_distributed(dist_backend="nccl")
    log(f"zero: NCCL process group up, world size "
        f"{comm.get_process_count()} ({torch.cuda.device_count()} card(s) "
        f"visible), backend {comm.get_backend_name()}")
    assert comm.get_backend_name() == "nccl"
    cfg = get_config("llama-1b")
    batch = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                 size=(8, 2048))
    zero = {"comms_logger": {"enabled": True}}
    log(f"zero: stage 0 (phase 9): losses "
        f"{[round(x, 4) for x in stage0['AdamW'][:3]]}, step "
        f"{stage0['step_ms']:.1f} ms, peak {stage0['peak_gib']:.2f} GiB")
    for stage in (1, 2, 3):
        conf = train_config(zero_optimization={"stage": stage}, **zero)
        engine, model, losses, step_ms, peaks, want = zero_run(
            cfg, conf, batch, 3)
        gap = max(abs(a - b) / abs(b) for a, b in
                  zip(losses, stage0["AdamW"][:3]))
        log(f"zero: stage {stage}: losses {[round(x, 4) for x in losses]}, "
            f"largest gap to stage 0 {gap:.3e} (limit {STAGE_LOSS_RTOL}); "
            f"step ms {[round(x, 1) for x in step_ms]}; peak {peaks[0]:.2f} "
            f"GiB in the init, {peaks[1]:.2f} GiB in the steps; buffers "
            f"{engine.buffer_numels()}; per step: 1 fused_adam launch, "
            f"collectives {want}, all of them through NCCL")
        assert gap <= STAGE_LOSS_RTOL, (stage, losses, stage0["AdamW"])
        del engine, model

    # a stage-3 engine's partitioned checkpoint after a step, at
    # CKPT_LAYERS of the 22 layers: the leg writes (fsynced) and reads
    # back every byte of it, which the disk's rate sets
    ccfg = get_config("llama-1b", num_hidden_layers=CKPT_LAYERS)
    engine, model, *_ = zero_run(ccfg, conf, batch, 1)
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_zero_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t = time.perf_counter()
    engine.save_checkpoint(ckpt)
    save_s = time.perf_counter() - t
    cont = [float(engine.train_batch(batch=batch)) for _ in range(2)]
    want_p = engine.state.params.clone()
    del engine, model
    fresh, model, _, _, _, _ = zero_run(ccfg, conf, batch, 0)
    t = time.perf_counter()
    path, _ = fresh.load_checkpoint(ckpt)
    load_s = time.perf_counter() - t
    again = [float(fresh.train_batch(batch=batch)) for _ in range(2)]
    same = torch.equal(fresh.state.params, want_p)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(ckpt) for f in fs) / 2**30
    log(f"zero: stage-3 checkpoint of {ccfg.num_hidden_layers} layers "
        f"({size:.2f} GiB): saved in {save_s:.1f} s, loaded (verified) in "
        f"{load_s:.1f} s; losses {cont} then {again}; master "
        f"bit-identical: {same}")
    assert path is not None and again == cont and same, \
        "the resumed stage-3 run differs"
    del fresh, model, want_p
    shutil.rmtree(ckpt, ignore_errors=True)

    engine, model, lion, _, _, want = zero_run(
        cfg, train_config("Lion", lr=3e-5, zero_optimization={"stage": 2},
                          **zero), batch, 2)
    gap = max(abs(a - b) / abs(b) for a, b in zip(lion, stage0["Lion"]))
    log(f"zero: stage 2 Lion: losses {[round(x, 4) for x in lion]}, gap "
        f"{gap:.3e}; per step 1 fused_lion launch, collectives {want}, "
        f"all of them through NCCL")
    assert gap <= STAGE_LOSS_RTOL, (lion, stage0["Lion"])
    del engine, model
    comm.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 14: CUDA graphs and the pipelined host path
# ---------------------------------------------------------------------------

def v2_graph_run(label, module, want, counters, eager, traffic, **kw):
    """Serve ``traffic`` on a fresh engine over ``module`` (phase 6's
    settings and ``kw``): every request's tokens equal ``want`` (the
    eager unpipelined run's), and each ``(counter, per tick)`` of
    ``counters`` equals ``per x (eager ticks + 2 K x captures)``: the
    counters tick at warm-ups and captures only.  Logs the run beside
    ``eager``'s numbers; returns the run's, with TTFT p50/p99 and the
    launches each counter saw."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2

    engine = RaggedInferenceEngineV2(module, device="cuda",
                                     **{**V2, **kw})
    before = [c.launches for c, _ in counters]
    out, r = serve(engine, traffic)
    for i, (a, b) in enumerate(zip(out, want)):
        assert np.array_equal(a, b), (
            f"{label}: request {i}'s tokens differ from the eager "
            "unpipelined run's")
    st = engine.serving_stages()
    cap = st.get("graph_captures", 0)
    rep = st.get("graph_replays", 0)
    K = engine.decode_block_size
    eager_ticks = engine.host_stats.ticks - K * rep
    device, launched = {}, {}
    for (c, per), b in zip(counters, before):
        got, want_n = c.launches - b, per * (eager_ticks + 2 * K * cap)
        assert got == want_n, (
            f"{label}: {c.__name__} counted {got} launches, want "
            f"{per} x ({eager_ticks} eager ticks + 2 x {K} x {cap} "
            "captures)")
        # derived, not traced: the counters never see a replay
        device[c.__name__] = per * (eager_ticks + K * (cap + rep))
        launched[c.__name__] = got
    log(f"graphs {label}: {len(traffic)} requests in "
        f"{r['wall_s']:.2f} s, tokens equal to the eager unpipelined "
        f"run's; decode "
        f"{r['decode_tps']:.1f} tokens/s in decode blocks "
        f"({r['block_tokens']} tokens, {r['block_s']:.2f} s, the "
        f"capture's {r['capture_s']:.3f} s apart; eager "
        f"{eager['decode_tps']:.1f}); {r['blocks']} blocks, blocking "
        f"gets per block {r['block_gets'] / max(r['blocks'], 1):.3f} "
        f"(eager {eager['block_gets'] / max(eager['blocks'], 1):.3f}); "
        f"host_bound_fraction in blocks {r['block_hbf']:.4f} (eager "
        f"{eager['block_hbf']:.4f}), overall "
        f"{st['host_bound_fraction']}; TTFT p50 "
        f"{st['requests']['ttft_ms_p50']} ms p99 "
        f"{st['requests']['ttft_ms_p99']} ms; prefill "
        f"{r['prompt_tokens'] / r['fused_s']:.0f} prompt tokens/s; "
        f"captures {cap} ({st.get('graph_capture_s', 0.0):.3f} s), "
        f"replays {rep}, harvests {engine.host_stats.harvests}, "
        f"dispatches {engine.host_stats.dispatches}; device launches "
        f"derived from the replays, per tick x (eager ticks + K x "
        f"(captures + replays)): {device}; pipeline_window "
        f"{st.get('pipeline_window')}")
    del engine
    torch.cuda.empty_cache()
    return dict(r, ttft_p50=st["requests"]["ttft_ms_p50"],
                ttft_p99=st["requests"]["ttft_ms_p99"],
                hbf=st["host_bound_fraction"], launched=launched,
                device=device)


def phase_graphs(bf16_outs, v2_eager, int8_outs, int8_eager, v1_greedy,
                 v1_eager):
    """Phases 6 and 12's v2 traffic and phase 3's v1 prompts again, with
    ``enable_cuda_graph`` and (v2) the pipeline: every request's tokens
    equal the eager unpipelined runs'; the kernels' Python counters tick
    at warm-ups and captures only, so each equals its launches per tick
    x (eager ticks + 2 K x captures); the device's launches, (eager
    ticks + K x (captures + replays)) times a tick's count, are derived
    from the engine's counters, not traced.  v1 then serves prompts of
    three lengths in turn, each a recapture."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    cfg = get_config("llama3-8b")
    L, K = cfg.num_hidden_layers, V2["decode_block_size"]
    n_weights = 7 * L + 2
    reqs = v2_traffic()

    # bf16: the module of phase 6, made again from its seed
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    module = engine.module
    del engine
    graph = {"config": {"enable_cuda_graph": True}}
    paged = [(rpa.ragged_paged_attention, L)]
    v2_graph_run("bf16 v2, pipeline on", module, bf16_outs, paged,
                 v2_eager, reqs, pipeline=True, **graph)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"graphs bf16 v2: peak memory {peak:.2f} GiB with graphs and the "
        f"pipeline, {v2_eager['peak']:.2f} GiB eager (phase 6)")
    v2_graph_run("bf16 v2, pipeline off", module, bf16_outs, paged,
                 v2_eager, reqs, **graph)
    v2_graph_run("bf16 v2, pipeline alone (no graphs)", module, bf16_outs,
                 paged, v2_eager, reqs, pipeline=True)
    # kernel #8: phase 6's int8 KV pool over its 8 requests, eager and
    # unpipelined first, then through graphs and the pipeline
    engine = RaggedInferenceEngineV2(module, device="cuda",
                                     kv_cache_dtype="int8", **V2)
    want8, eager8 = serve(engine, reqs[:8])
    del engine
    v2_graph_run("bf16 v2, int8 KV pool, pipeline on", module, want8,
                 [(rpa.ragged_paged_attention_quant, L)], eager8, reqs[:8],
                 kv_cache_dtype="int8", pipeline=True, **graph)
    del module, model
    gc.collect()
    torch.cuda.empty_cache()

    # int8 weights: phase 12's quantized module, made again from its seed
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", quantize_weights="int8", **V2)
    module = engine.module
    del engine
    torch.cuda.reset_peak_memory_stats()    # building held the bf16 weights
    v2_graph_run("int8 v2, pipeline on", module, int8_outs,
                 paged + [(qz.dequantize, n_weights)], int8_eager, reqs,
                 pipeline=True, **graph)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"graphs int8 v2: peak memory while serving {peak:.2f} GiB with "
        f"graphs and the pipeline, {int8_eager['peak']:.2f} GiB eager "
        "(phase 12)")
    del module, model
    gc.collect()
    torch.cuda.empty_cache()

    # v1: phase 3's engine and prompts, the decode step replayed
    B, P, NEW = v1_greedy.shape[0], 1000, 64
    torch.cuda.reset_peak_memory_stats()
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "max_out_tokens": 2048,
                       "enable_cuda_graph": True},
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(SEED))

    def run(**kw):
        before = flash_fwd.launches
        t = time.perf_counter()
        out = engine.generate(prompts, **kw)
        dt = time.perf_counter() - t
        assert flash_fwd.launches - before == L, "prefill not one flash/layer"
        return out, dt

    greedy1, t1 = run(max_new_tokens=NEW)
    greedy2, t2 = run(max_new_tokens=NEW)
    assert torch.equal(greedy1, v1_greedy) and torch.equal(greedy2,
                                                           v1_greedy), \
        "v1 tokens through graphs differ from phase 3's eager run"
    _, tp1 = run(max_new_tokens=1)
    _, tp2 = run(max_new_tokens=1)
    sampled = dict(max_new_tokens=NEW, do_sample=True, temperature=0.8,
                   top_k=50, top_p=0.9,
                   generator=torch.Generator(device="cuda").manual_seed(SEED))
    if hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        out, ts = run(**sampled)
        assert torch.equal(out, v1_eager["sampled"]), (
            "sampled v1 tokens through graphs differ from phase 3's")
        note = f"sampled equal to phase 3's ({ts:.3f} s)"
    else:
        try:
            run(**sampled)
        except NotImplementedError as e:
            note = f"sampled raises ({e})"
        else:
            raise AssertionError("a sampled graph without generator "
                                 "registration did not raise")
    st = engine.serving_stages()
    peak = torch.cuda.max_memory_allocated() / 2**30
    tps = B * (NEW - 1) / (t2 - tp2)
    log(f"graphs v1: generate {B}x{P}+{NEW}: {t1:.3f} s (first, with the "
        f"capture), {t2:.3f} s; greedy tokens equal to phase 3's twice; "
        f"{note}; prefill {tp1 * 1e3:.1f} / {tp2 * 1e3:.1f} ms; decode "
        f"{tps:.1f} tokens/s ({(t2 - tp2) / (NEW - 1) * 1e3:.2f} ms/step; "
        f"eager {v1_eager['decode_tps']:.1f} in phase 3); captures "
        f"{st['graph_captures']} ({st['graph_capture_s']:.3f} s), replays "
        f"{st['graph_replays']}; peak memory {peak:.2f} GiB "
        f"({v1_eager['peak']:.2f} eager)")

    # prompts of other lengths: each new cache length frees the engine's
    # one decode state and captures again; tokens against an eager
    # engine over the same weights, peaks measured call by call
    eager = deepspeed_tpu_torch.init_inference(
        engine.module, config={"dtype": "bfloat16", "max_out_tokens": 2048})
    gen = torch.Generator().manual_seed(SEED + 1)
    rows = []
    for Pm in (500, 1500, 1000):
        pm = torch.randint(0, cfg.vocab_size, (B, Pm), generator=gen)
        torch.cuda.reset_peak_memory_stats()
        want = eager.generate(pm, max_new_tokens=NEW)
        peak_e = torch.cuda.max_memory_allocated() / 2**30
        c0, s0 = st["graph_captures"], st["graph_capture_s"]
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        got = engine.generate(pm, max_new_tokens=NEW)
        dt = time.perf_counter() - t
        peak_g = torch.cuda.max_memory_allocated() / 2**30
        assert torch.equal(got, want), (
            f"v1 tokens through graphs at prompt {Pm} differ from eager")
        st = engine.serving_stages()
        assert st["graph_captures"] == c0 + 1, "a new length must recapture"
        rows.append(f"{Pm}: {dt:.3f} s, recapture "
                    f"{st['graph_capture_s'] - s0:.3f} s, peak "
                    f"{peak_g:.2f} GiB (eager {peak_e:.2f}), held after "
                    f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    log(f"graphs v1: prompt lengths {B}x(500, 1500, 1000)+{NEW} in turn, "
        "tokens equal to an eager engine's, one decode state kept: "
        + "; ".join(rows))
    del engine, eager, model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phases 15-18: GPT-2, the JAX package's benchmark model
# ---------------------------------------------------------------------------

GPT2_HEAD_DIM = 64
# phase 18: the gradients of one fp32 step on the card against the CPU's,
# per tensor, within this share of the tensor's largest magnitude (fp32
# both sides: summation order only)
GPT2_GRAD_RTOL = 1e-4


def gpt2_qkv(gen, B, H, S, D=GPT2_HEAD_DIM, dtype=torch.bfloat16):
    """q, k and v as GPT-2's attention hands them to the kernels: strided
    ``[B, H, S, D]`` views into one ``[B, S, 3E]`` ``c_attn`` output (a
    row stride of 3E, no copy), one KV head per query head."""
    E = H * D
    qkv = torch.randn(B, S, 3 * E, generator=gen, device="cuda",
                      dtype=dtype)
    q, k, v = (t.view(B, S, H, D).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    assert q.stride() == (S * 3 * E, D, 3 * E, 1), q.stride()
    return q, k, v


def adam_entry(name, n, lr=1e-4, wd=0.01):
    """Fused AdamW over ``n`` fp32 parameters (+ a bf16 working copy)
    against its plain version, timed beside its byte bound and
    ``torch.optim.AdamW(fused=True).step``."""
    from deepspeed_tpu_torch.ops import fused_adam as fo

    gen = torch.Generator(device="cuda").manual_seed(SEED + 600)
    p = torch.randn(n, generator=gen, device="cuda")
    g = torch.randn(n, generator=gen, device="cuda") * 1e-2
    m = torch.randn(n, generator=gen, device="cuda") * 1e-3
    v = torch.rand(n, generator=gen, device="cuda") * 1e-4
    w = p.to(torch.bfloat16)
    sc = torch.tensor([lr, 0.19, 0.0975, 0.5, 0.0], device="cuda")
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=wd, adam_w=True)
    ref = [t.clone() for t in (p, m, v, w)]
    fo.fused_adam(p, g, m, v, sc, w, **kw)
    fo.adam_update_reference(ref[0], g, ref[1], ref[2], sc, ref[3], **kw)
    torch.cuda.synchronize()
    err = 0.0
    for a, b in zip((p, m, v), ref[:3]):
        d = (a - b).abs()
        assert (d <= OPT_ATOL + OPT_RTOL * b.abs()).all(), (
            f"{name}: differs from plain by up to {d.max().item():.3e}")
        err = max(err, d.max().item())
    assert torch.equal(w, p.to(torch.bfloat16))
    ms = time_ms(lambda: fo.fused_adam(p, g, m, v, sc, w, **kw), reps=10,
                 warmup=2)
    plain_ms = time_ms(lambda: fo.adam_update_reference(
        ref[0], g, ref[1], ref[2], sc, ref[3], **kw), reps=3, warmup=1)
    del ref
    param = torch.nn.Parameter(p.clone())
    param.grad = g
    topt = torch.optim.AdamW([param], lr=lr, weight_decay=wd, fused=True)
    lib_ms = time_ms(topt.step, reps=10, warmup=2)
    bound = n * (16 + 12 + 2) / PEAK_BYTES * 1e3
    log(f"{name}: fused AdamW over {n} fp32 parameters (+ bf16 copy): "
        f"max|kernel-plain|={err:.3e}; kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms, bound {bound:.3f} ms (bytes), {bound / ms:.1%} "
        f"of bound; torch AdamW(fused=True).step {lib_ms:.3f} ms")
    del p, g, m, v, w, param, topt
    torch.cuda.empty_cache()
    return dict(name=name, route="cuda",
                source="deepspeed_tpu_torch/ops/csrc/fused_adam.cu",
                replaces="deepspeed_tpu/ops/fused_adam.py:52", launches=0,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", library_ms=lib_ms)


def phase_gpt2_kernels():
    """Kernels #1-#3, #4, #6 and #7 at the shapes GPT-2's paths give them,
    against their plain versions at the limits of phases 2, 8 and 11."""
    from torch.nn import functional as F

    from deepspeed_tpu_torch.models.gpt2 import GPT2LMLoss, get_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import quantization as qz

    bf16 = torch.bfloat16
    D = GPT2_HEAD_DIM
    src_f = "deepspeed_tpu_torch/ops/csrc/flash_fwd.cu"
    src_b = "deepspeed_tpu_torch/ops/csrc/flash_bwd.cu"
    shapes = [  # kernel line suffix, B, H, S; H KV heads too
        ("gpt2_125m_prefill", 64, 12, 128),       # v1 at bench.py:485-500
        ("gpt2_125m_train", 12, 12, 1024),        # config 1
        ("gpt2_1.3b_train", 4, 32, 1024),         # config 2
    ]
    entries = {}
    for i, (name, B, H, S) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 500 + i)
        q, k, v = gpt2_qkv(gen, B, H, S)
        o, lse = fa.flash_fwd(q, k, v, causal=True)
        ro, rlse = fa.flash_fwd_reference(q, k, v, causal=True)
        torch.cuda.synchronize()
        err, lerr = check_fwd(f"gpt2 fwd {name}", o, lse, ro, rlse, bf16)
        ms = time_ms(lambda: fa.flash_fwd(q, k, v, causal=True))
        dev_ms = graph_ms(lambda: fa.flash_fwd(q, k, v, causal=True))
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True))
        plain_ms = time_ms(lambda: fa.flash_fwd_reference(q, k, v,
                                                          causal=True),
                           reps=3, warmup=1)
        bound, by = attention_bound(B, H, H, S, S, D, True, bf16)
        tflop = 4 * B * H * D * pairs_of(S, S, True) / 1e12
        entries[f"flash_fwd_{name}"] = dict(
            name=f"flash_fwd_{name}", route="cuda", source=src_f,
            replaces="deepspeed_tpu/ops/flash_attention.py:225", launches=0,
            max_abs_err=err, ms=dev_ms, plain_ms=plain_ms, bound_ms=bound,
            bound_by=by, library_ms=lib_ms)
        line = (f"gpt2 flash_fwd[{name}] B={B} H={H} Hkv={H} S={S} D={D} "
                f"causal, q/k/v strided views of [B, S, 3E]: max|o-plain|="
                f"{err:.3e} max|lse-plain|={lerr:.3e}; device time "
                f"{dev_ms:.4f} ms ({tflop / dev_ms * 1e3:.1f} TFLOP/s; graph "
                f"of 20 calls), host loop {ms:.4f} ms, plain {plain_ms:.3f} "
                f"ms, SDPA {lib_ms:.4f} ms, bound {bound:.4f} ms ({by}), "
                f"{bound / dev_ms:.1%} of bound")
        if name.endswith("_train"):
            do = torch.randn(B, S, H, D, generator=gen, device="cuda",
                             dtype=bf16).transpose(1, 2)
            got = fa.flash_bwd(q, k, v, o, lse, do, causal=True)
            want = fa.flash_bwd_reference(q, k, v, o, lse, do, causal=True)
            torch.cuda.synchronize()
            errs = {}
            for gname, a, b in zip(("dq", "dk", "dv"), got, want):
                af, bf = a.float(), b.float()
                e = (af - bf).abs()
                assert torch.isfinite(af).all(), f"gpt2 bwd {name}: {gname}"
                assert (e <= BWD_ATOL + BWD_RTOL * bf.abs()).all(), (
                    f"gpt2 bwd {name}: {gname} differs from plain by up to "
                    f"{e.max().item():.3e}")
                errs[gname] = e.max().item()
            delta = fa.bwd_delta(do, o)
            ms_b = {"dq": time_ms(lambda: fa.flash_bwd_dq(
                        q, k, v, do, lse, delta, True)),
                    "dkv": time_ms(lambda: fa.flash_bwd_dkv(
                        q, k, v, do, lse, delta, True))}
            plain_b = time_ms(lambda: fa.flash_bwd_reference(
                q, k, v, o, lse, do, causal=True), reps=3, warmup=1)
            lib_b, backend = sdpa_backward(q, k, v, do)
            line += (f"; backward max|dq-plain|={errs['dq']:.3e} "
                     f"max|dk-plain|={errs['dk']:.3e} max|dv-plain|="
                     f"{errs['dv']:.3e}; plain {plain_b:.3f} ms; SDPA "
                     f"backward ({backend}) {lib_b:.4f} ms")
            for which, kname, line_no in (("dq", "flash_bwd_dq", 364),
                                          ("dkv", "flash_bwd_dkv", 419)):
                bound, by = bwd_bound(which, B, H, H, S, S, D, True, bf16)
                e = errs["dq"] if which == "dq" else max(errs["dk"],
                                                         errs["dv"])
                entries[f"{kname}_{name}"] = dict(
                    name=f"{kname}_{name}", route="cuda", source=src_b,
                    replaces=f"deepspeed_tpu/ops/flash_attention.py:"
                             f"{line_no}",
                    launches=0, max_abs_err=e, ms=ms_b[which],
                    plain_ms=plain_b, bound_ms=bound, bound_by=by,
                    library_ms=lib_b)
                line += (f"; {kname} {ms_b[which]:.4f} ms, bound "
                         f"{bound:.4f} ms ({by}), {bound / ms_b[which]:.1%} "
                         "of bound")
            del do, got, want, delta
        log(line)
        del q, k, v, o, lse, ro, rlse
        torch.cuda.empty_cache()
    log("gpt2 kernels: these shapes run the D=64 builds of flash_fwd_hopper, "
        "dq_hopper and dkv_hopper, which phase 1 held to no spill, no local "
        "memory and no wgmma serialization; GPT-2 adds no build")

    # #4 over each configuration's parameters (config 2: one rank's shard
    # at ZeRO 2 on one card is all of them)
    for preset in ("gpt2-125m", "gpt2-1.3b"):
        with torch.device("meta"):
            n = sum(p.numel() for p in GPT2LMLoss(get_config(
                preset)).parameters())
        name = f"fused_adam_{preset.replace('-', '_')}"
        entries[name] = adam_entry(name, n)

    # #6 and #7 at gpt2-125m's int8 serving shapes, groups of 128: c_fc
    # [768, 3072] (flax's [in, out]) and the tied table [50257, 768]
    for i, (name, shape) in enumerate((("c_fc", (768, 3072)),
                                       ("wte", (50257, 768)))):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 700 + i)
        x = (torch.randn(shape, generator=gen, device="cuda") * 0.02).to(bf16)
        got = qz.quantize(x, group_size=128)
        back = qz.dequantize(got)
        want = qz.quantize_reference(x, group_size=128)
        want_back = qz.dequantize_reference(want)
        torch.cuda.synchronize()
        assert torch.equal(got.values, want.values) and torch.equal(
            got.scale, want.scale) and torch.equal(got.offset, want.offset)
        assert torch.equal(back.view(torch.int16),
                           want_back.view(torch.int16))
        bound, by = quant_bound(x.numel(), 128, 2)
        ms_q = graph_ms(lambda: qz.quantize(x, group_size=128))
        ms_d = graph_ms(lambda: qz.dequantize(got))
        plain_q = time_ms(lambda: qz.quantize_reference(x, group_size=128),
                          reps=3, warmup=1)
        plain_d = time_ms(lambda: qz.dequantize_reference(got), reps=3,
                          warmup=1)
        log(f"gpt2 quant[{name}] {list(shape)} groups of 128 bf16: payload, "
            f"scale, offset and dequantized output bit-identical to plain; "
            f"device time quantize {ms_q:.4f} ms (plain {plain_q:.3f} ms), "
            f"dequantize {ms_d:.4f} ms (plain {plain_d:.3f} ms), bound "
            f"{bound:.4f} ms ({by}) each: {bound / ms_q:.1%} and "
            f"{bound / ms_d:.1%} of bound")
        for kname, ms, plain_ms, line_no in (
                (f"quantize_int8_g128_gpt2_{name}", ms_q, plain_q, 41),
                (f"dequantize_int8_g128_gpt2_{name}", ms_d, plain_d, 59)):
            entries[kname] = dict(
                name=kname, route="cuda",
                source="deepspeed_tpu_torch/ops/csrc/quantization.cu",
                replaces=f"deepspeed_tpu/ops/quantization.py:{line_no}",
                launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by=by, library_ms=None)
        del x, got, back, want, want_back
        torch.cuda.empty_cache()
    return entries


def phase_gpt2_serve():
    """v1 serving of gpt2-125m at the reference's inference shape, eager
    and graphed; gpt2-1.3b; gpt2-125m with int8 weights.  Returns the
    launches of #1 over the gpt2-125m bf16 run and of #6/#7 over the int8
    run."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2Model, get_config
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    def build(cfg, **config):
        with torch.device("meta"):
            model = GPT2Model(cfg)
        return deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "bfloat16", "max_out_tokens": 1024,
                           **config},
            generator=torch.Generator(device="cuda").manual_seed(SEED))

    def run(engine, prompts, L, **kw):
        before = flash_fwd.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = engine.generate(prompts, **kw)
        dt = time.perf_counter() - t
        n = flash_fwd.launches - before
        assert n == L, f"generate launched the flash kernel {n} times, " \
            f"want {L}"
        B, P = prompts.shape
        assert out.shape == (B, P + kw["max_new_tokens"]), out.shape
        assert torch.equal(out[:, :P], prompts)
        assert ((out[:, P:] >= 0) & (out[:, P:] < 50257)).all()
        return out, dt

    def serve(cfg, B, P, NEW):
        """Eager greedy twice, prefill alone twice, sampled, async, then
        the same engine's module graphed: greedy twice and sampled."""
        L = cfg.n_layer
        prompts = torch.randint(0, cfg.vocab_size, (B, P),
                                generator=torch.Generator().manual_seed(SEED))
        torch.cuda.reset_peak_memory_stats()
        engine = build(cfg)
        greedy, t1 = run(engine, prompts, L, max_new_tokens=NEW)
        again, t2 = run(engine, prompts, L, max_new_tokens=NEW)
        assert torch.equal(greedy, again), "greedy runs differ"
        _, tp1 = run(engine, prompts, L, max_new_tokens=1)
        _, tp2 = run(engine, prompts, L, max_new_tokens=1)
        samp = dict(max_new_tokens=NEW, do_sample=True, temperature=0.8,
                    top_k=50, top_p=0.9)
        sampled, ts = run(engine, prompts, L, generator=torch.Generator(
            device="cuda").manual_seed(SEED), **samp)
        before = flash_fwd.launches
        pending = engine.generate_async(prompts, max_new_tokens=NEW)
        assert torch.equal(pending.result(), greedy), "async differs"
        assert flash_fwd.launches - before == L
        stages = engine.serving_stages()
        peak = torch.cuda.max_memory_allocated() / 2**30
        graphed = deepspeed_tpu_torch.init_inference(
            engine.module, config={"dtype": "bfloat16",
                                   "max_out_tokens": 1024,
                                   "enable_cuda_graph": True})
        g1, tg1 = run(graphed, prompts, L, max_new_tokens=NEW)
        g2, tg2 = run(graphed, prompts, L, max_new_tokens=NEW)
        assert torch.equal(g1, greedy) and torch.equal(g2, greedy), \
            "graphed greedy tokens differ from eager"
        note = "sampled graphs need CUDAGraph.register_generator_state"
        if hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
            gs, _ = run(graphed, prompts, L, generator=torch.Generator(
                device="cuda").manual_seed(SEED), **samp)
            assert torch.equal(gs, sampled), "graphed sampled tokens differ"
            note = "sampled equal to eager"
        gstages = graphed.serving_stages()
        peak_g = torch.cuda.max_memory_allocated() / 2**30
        tps, gtps = (B * (NEW - 1) / (t2 - tp2), B * (NEW - 1) / (tg2 - tp2))
        log(f"gpt2 v1 {B}x{P}+{NEW} (n_layer {L}, n_head {cfg.n_head}, "
            f"n_embd {cfg.n_embd}): eager {t1:.3f} s (first) / {t2:.3f} s, "
            f"prefill (generate 1 token) {tp1 * 1e3:.1f} / {tp2 * 1e3:.1f} "
            f"ms, decode {tps:.1f} tokens/s "
            f"({(t2 - tp2) / (NEW - 1) * 1e3:.3f} ms/step), sampled "
            f"{ts:.3f} s, host_bound_fraction "
            f"{stages['host_bound_fraction']}, peak {peak:.2f} GiB; graphed "
            f"{tg1:.3f} s (first, with the capture) / {tg2:.3f} s, decode "
            f"{gtps:.1f} tokens/s ({(tg2 - tp2) / (NEW - 1) * 1e3:.3f} "
            f"ms/step), host_bound_fraction {gstages['host_bound_fraction']}"
            f", captures {gstages['graph_captures']} "
            f"({gstages['graph_capture_s']:.3f} s), peak {peak_g:.2f} GiB; "
            f"greedy tokens identical eager twice, async and graphed twice; "
            f"{note}; flash once per layer per generate")
        module = engine.module
        del engine, graphed
        return module, greedy

    # gpt2-125m at bench.py:485-500's shape; the main path's run starts
    flash_fwd.launches = 0
    cfg = get_config("gpt2-125m", n_positions=1024,
                     use_flash_attention=True, remat=False)
    module, bf16_greedy = serve(cfg, 64, 128, 128)
    fwd_launches = flash_fwd.launches
    del module
    gc.collect()
    torch.cuda.empty_cache()

    # gpt2-1.3b: 900 + 64 stays inside n_positions
    module, _ = serve(get_config("gpt2-1.3b", n_positions=1024,
                                 use_flash_attention=True, remat=False),
                      4, 900, 64)
    del module
    gc.collect()
    torch.cuda.empty_cache()

    # gpt2-125m, int8 weights at groups of 128: 48 Linear weights, wte and
    # wpe quantized once each at build; per forward each dequantized once
    # and the tied table twice (the lookup and the head)
    n_leaves = 4 * cfg.n_layer + 2
    per_forward = n_leaves + 1
    B, P, NEW = 64, 128, 128
    qz.quantize.launches = qz.dequantize.launches = 0   # the path starts
    engine = build(cfg, quant={"enabled": True, "qtype": "int8"})
    torch.cuda.synchronize()
    assert qz.quantize.launches == n_leaves, qz.quantize.launches
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(SEED))
    before = qz.dequantize.launches
    out, t1 = run(engine, prompts, cfg.n_layer, max_new_tokens=NEW)
    got = qz.dequantize.launches - before
    assert got == per_forward * NEW, (
        f"int8 generate launched dequantize {got} times, want "
        f"{per_forward} x {NEW} forwards")
    again, t2 = run(engine, prompts, cfg.n_layer, max_new_tokens=NEW)
    assert torch.equal(out, again), "int8 greedy runs differ"
    same = (out[:, P:] == bf16_greedy[:, P:]).float().mean().item()
    log(f"gpt2 int8 v1 {B}x{P}+{NEW}: {qz.quantize.launches} weights "
        f"quantized at build; {per_forward} dequantize launches per forward "
        f"({n_leaves} leaves, the tied table twice), {got} per generate; "
        f"{t1:.3f} / {t2:.3f} s; greedy tokens identical twice, {same:.1%} "
        f"of them equal to the bf16 run's")
    q_launches = (qz.quantize.launches, qz.dequantize.launches)
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    return fwd_launches, q_launches


def gpt2_train_config(opt, micro, stage):
    """bench.py's configs 1 and 2 (lr 1e-4, weight decay 0.01, one micro
    batch a step), with ``fused`` set: the port, as the JAX package, runs
    the fused kernel only when asked."""
    return {"train_batch_size": micro, "train_micro_batch_size_per_gpu": micro,
            "gradient_accumulation_steps": 1, "bf16": {"enabled": True},
            "zero_optimization": {"stage": stage},
            "optimizer": {"type": opt, "params": {
                "lr": 1e-4, "weight_decay": 0.01, "fused": True}},
            "steps_per_print": 1000000}


def gpt2_train_run(cfg, config, batch, steps, want, label):
    """``steps`` train_batch calls on a fresh engine, launches held per
    step to ``want`` (flash fwd, dQ, dK/dV, fused Adam); returns the
    engine, its model, the losses, the median step ms and the peak GiB of
    the steps."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMLoss
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fo

    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                fo.fused_adam)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = GPT2LMLoss(cfg)
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    losses, step_ms = [], []
    for step in range(steps):
        before = [c.launches for c in counters]
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        step_ms.append((time.perf_counter() - t) * 1e3)
        got = [c.launches - b for c, b in zip(counters, before)]
        assert got == want, f"{label} step {step}: launches {got}, want " \
            f"{want}"
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert all(math.isfinite(x) for x in losses), (label, losses)
    log(f"gpt2 train {label}: engine up in {init_s:.1f} s, "
        f"{engine.num_parameters / 1e9:.4f} B params")
    return engine, model, losses, step_ms, peak


def phase_gpt2_train():
    """bench.py's config 1 (gpt2-125m, ZeRO 0) and config 2 (gpt2-1.3b,
    ZeRO 2 over one NCCL rank, dots_saveable) at full width and depth;
    config 2 under the "full" and "none" policies for a step each, and
    its ZeRO-2 checkpoint (CKPT_LAYERS layers) resumed bit-identically.
    Returns the launches of the main runs by kernel line."""
    import shutil

    from deepspeed_tpu_torch import comm
    from deepspeed_tpu_torch.models.gpt2 import flops_per_token, get_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fo

    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv,
                "fused_adam": fo.fused_adam}
    S = 1024
    launches = {}

    def report(label, cfg, micro, losses, step_ms, peak):
        steady = float(np.median(step_ms[1:]))
        tps = micro * S / (steady / 1e3)
        fpt = flops_per_token(cfg, S)
        log(f"gpt2 train {label}: losses {[round(x, 4) for x in losses]}; "
            f"step {steady:.1f} ms (median after the first, "
            f"{step_ms[0]:.1f} ms), {tps:.0f} tokens/s, MFU "
            f"{fpt * tps / PEAK_BF16:.1%} (flops_per_token {fpt:.4e} at "
            f"989 TFLOP/s); peak {peak:.2f} GiB in the steps")

    # config 1: gpt2-125m, ZeRO 0, AdamW, micro 12, remat off
    cfg = get_config("gpt2-125m", n_positions=1024, remat=False,
                     remat_policy="none", use_flash_attention=True)
    L, micro = cfg.n_layer, 12
    batch = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                 size=(micro, S))
    for c in counters.values():         # the main path's run starts here
        c.launches = 0
    engine, model, losses, step_ms, peak = gpt2_train_run(
        cfg, gpt2_train_config("AdamW", micro, 0), batch, 10,
        [L, L, L, 1], "config 1 (gpt2-125m, ZeRO 0, AdamW)")
    launches["gpt2_125m_train"] = {k: c.launches
                                   for k, c in counters.items()}
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    report("config 1", cfg, micro, losses, step_ms, peak)
    del engine, model

    # config 2: gpt2-1.3b, ZeRO 2 over one NCCL rank, FusedAdam, micro 4,
    # dots_saveable: the flash forward runs again in each block's recompute
    comm.init_distributed(dist_backend="nccl")
    assert comm.get_backend_name() == "nccl"
    cfg = get_config("gpt2-1.3b", n_positions=1024, remat=True,
                     remat_policy="dots_saveable", use_flash_attention=True)
    L, micro = cfg.n_layer, 4
    batch = np.random.default_rng(SEED + 1).integers(0, cfg.vocab_size,
                                                     size=(micro, S))
    conf = gpt2_train_config("FusedAdam", micro, 2)
    for c in counters.values():         # the main path's run starts here
        c.launches = 0
    engine, model, losses, step_ms, peak = gpt2_train_run(
        cfg, conf, batch, 5, [2 * L, L, L, 1],
        "config 2 (gpt2-1.3b, ZeRO 2, FusedAdam, dots_saveable)")
    launches["gpt2_1.3b_train"] = {k: c.launches
                                   for k, c in counters.items()}
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    report("config 2", cfg, micro, losses, step_ms, peak)
    first = (losses[0], step_ms, peak)
    del engine, model

    # the ZeRO-2 checkpoint of config 2 after a step, at CKPT_LAYERS of
    # its 24 layers: save, 2 steps, load, the same 2 steps again
    ccfg = get_config("gpt2-1.3b", n_layer=CKPT_LAYERS, n_positions=1024,
                      remat=True, remat_policy="dots_saveable",
                      use_flash_attention=True)
    CL = ccfg.n_layer
    engine, model, *_ = gpt2_train_run(
        ccfg, conf, batch, 1, [2 * CL, CL, CL, 1],
        f"config 2 at {CL} layers")
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_gpt2_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t = time.perf_counter()
    engine.save_checkpoint(ckpt)
    save_s = time.perf_counter() - t
    cont = [float(engine.train_batch(batch=batch)) for _ in range(2)]
    want_p = engine.state.params.clone()
    t = time.perf_counter()
    path, _ = engine.load_checkpoint(ckpt)
    load_s = time.perf_counter() - t
    again = [float(engine.train_batch(batch=batch)) for _ in range(2)]
    same = torch.equal(engine.state.params, want_p)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(ckpt) for f in fs) / 2**30
    log(f"gpt2 train config 2: ZeRO-2 checkpoint of {CL} layers "
        f"({size:.2f} GiB) saved in "
        f"{save_s:.1f} s, loaded in {load_s:.1f} s; losses {cont} then "
        f"{again}; master bit-identical: {same}")
    assert path is not None and again == cont and same, \
        "the resumed config-2 run differs"
    shutil.rmtree(ckpt, ignore_errors=True)
    del engine, model, want_p

    # one step under "full" and "none": the dots_saveable peak between
    peaks = {}
    for policy, want in (("full", [2 * L, L, L, 1]), ("none", [L, L, L, 1])):
        pcfg = get_config("gpt2-1.3b", n_positions=1024,
                          remat=policy != "none", remat_policy=policy,
                          use_flash_attention=True)
        engine, model, pl, pms, peaks[policy] = gpt2_train_run(
            pcfg, conf, batch, 1, want, f"config 2 under {policy}")
        gap = abs(pl[0] - first[0]) / abs(first[0])
        log(f"gpt2 train config 2 under {policy}: loss {pl[0]:.6f} (gap "
            f"{gap:.3e} to dots_saveable's, limit {STAGE_LOSS_RTOL}); step "
            f"{pms[0]:.1f} ms; peak {peaks[policy]:.2f} GiB")
        assert gap <= STAGE_LOSS_RTOL, (policy, pl, first[0])
        del engine, model
    log(f"gpt2 train config 2 peaks: full {peaks['full']:.2f} GiB < "
        f"dots_saveable {first[2]:.2f} GiB < none {peaks['none']:.2f} GiB")
    assert peaks["full"] < first[2] < peaks["none"], (peaks, first[2])
    comm.destroy_process_group()
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def gpt2_flax_tree(cfg, rng):
    """A random flax-layout GPT2LMLoss param tree (unrolled layers) in
    numpy, at the flax initialisers' scales; LayerNorm scales and biases
    off their init so that every leaf matters."""
    E, V = cfg.n_embd, cfg.vocab_size

    def dense(n_in, n_out):
        w = rng.standard_normal((n_in, n_out), dtype=np.float32)
        return {"kernel": w * np.float32(1 / math.sqrt(n_in)),
                "bias": 0.02 * rng.standard_normal(n_out, dtype=np.float32)}

    def norm():
        return {"scale": 1 + 0.1 * rng.standard_normal(E, dtype=np.float32),
                "bias": 0.1 * rng.standard_normal(E, dtype=np.float32)}

    def embed(n):
        return {"embedding": rng.standard_normal((n, E), dtype=np.float32)
                * np.float32(1 / math.sqrt(E))}

    tree = {"wte": embed(V), "wpe": embed(cfg.n_positions), "ln_f": norm()}
    for i in range(cfg.n_layer):
        tree[f"h_{i}"] = {
            "ln_1": norm(), "ln_2": norm(),
            "attn": {"c_attn": dense(E, 3 * E), "c_proj": dense(E, E)},
            "mlp": {"c_fc": dense(E, 4 * E), "c_proj": dense(4 * E, E)}}
    return {"params": {"transformer": tree}}


def phase_gpt2_cpu_parity():
    """gpt2-125m at full width with 2 layers in fp32 (TF32 off), one
    flax-layout tree through the bridge: prefill logits through v1, and
    one training step's loss and gradients, on the card against the
    port on the CPU."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.gpt2 import (GPT2LMLoss, GPT2Model,
                                                 get_config)
    from deepspeed_tpu_torch.module_inject.flax_bridge import \
        flax_to_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("gpt2-125m", n_layer=2, dtype=torch.float32,
                     param_dtype=torch.float32, remat=False,
                     use_flash_attention=True)
    rng = np.random.default_rng(SEED + 5)
    state = flax_to_state_dict(gpt2_flax_tree(cfg, rng))
    ids = rng.integers(0, cfg.vocab_size, size=(2, 128))
    model_state = {k[len("transformer."):]: v for k, v in state.items()}
    logits, loss, grads = {}, {}, {}
    for dev in ("cuda", "cpu"):
        with torch.device("meta"):
            model = GPT2Model(cfg)
        eng = deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "float32", "max_out_tokens": 256},
            params=model_state, device=dev)
        logits[dev] = eng.forward(ids).cpu()
        del eng, model
        lm = GPT2LMLoss(cfg)
        lm.load_state_dict(state)
        lm.to(dev)
        out = lm(torch.from_numpy(ids).to(dev))
        out.backward()
        loss[dev] = out.item()
        grads[dev] = {n: p.grad.cpu() for n, p in lm.named_parameters()}
        del lm, out
    gc.collect()
    torch.cuda.empty_cache()
    gpu, cpu = logits["cuda"], logits["cpu"]
    assert gpu.shape == (2, 128, cfg.vocab_size) and torch.isfinite(gpu).all()
    err = (gpu - cpu).abs().max().item()
    rel = abs(loss["cuda"] - loss["cpu"]) / abs(loss["cpu"])
    worst = max(((grads["cuda"][n] - g).abs().max() / g.abs().max()).item()
                for n, g in grads["cpu"].items())
    log(f"gpt2 parity: 2-layer fp32 at full width, card vs CPU: prefill "
        f"logits max|diff| {err:.3e} (logit std {cpu.std().item():.3f}, "
        f"tolerance {LOGITS_ATOL}); loss {loss['cuda']:.6f} vs "
        f"{loss['cpu']:.6f} (rel {rel:.3e}, limit {TRAIN_LOSS_RTOL}); "
        f"gradients: largest max|diff| / max|grad| over "
        f"{len(grads['cpu'])} tensors {worst:.3e} (limit {GPT2_GRAD_RTOL})")
    assert err <= LOGITS_ATOL, f"card and CPU logits differ by {err:.3e}"
    assert rel <= TRAIN_LOSS_RTOL, (loss, rel)
    assert worst <= GPT2_GRAD_RTOL, f"gradients differ by {worst:.3e}"


# ---------------------------------------------------------------------------
# Phase 19: KV tiering and the prefix cache on the v2 engine
# ---------------------------------------------------------------------------

# phases 19 and 21 serve llama3-8b at full width and this many of its 32
# layers: their legs check what the tiers move and when, which is the
# same at any depth, while a page's bytes (and the disk's share of the
# run) grow with it
TIERED_LAYERS = 8
# the tiering leg's tiers: phase 6's decode-heavy traffic spills two
# sequences of 8 pages a run, so a host tier of 8 pages (16 MiB pinned)
# sends the older spill on to the NVMe tier (128 pages, 256 MiB on
# disk); the spill files go under the git-ignored build/, removed
# afterwards
TIER = dict(host_pages=8, nvme_pages=128)
TIER_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_kvtier")
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)


def hold_restores(engine):
    """Hold every restore and prefix revival of ``engine``: the pages read
    back from the pool after the write equal, byte for byte, the bytes
    the tiers took at spill (the store also verifies every page against
    its spill-time digest).  Counts the pages held and the live tokens
    restores brought back without a re-prefill."""
    t = engine.tiering
    kept, keys = {}, []
    held = {"pages": 0, "tokens": 0}
    spill, restore = t.spill, t.restore
    scatter, restore_req = engine._scatter_pages, engine._restore

    def spill_(key, buf, n):
        spill(key, buf, n)
        kept[key] = buf.copy()

    def restore_(key):
        buf = restore(key)
        keys.append(key)
        return buf

    def scatter_(pages, buf):
        scatter(pages, buf)
        n = len(pages)
        want = kept.pop(keys.pop()).reshape(n, t.page_stride)
        idx = torch.tensor(pages, device=engine.device)
        back = torch.cat([v.index_select(0, idx) for v in engine._page_views],
                         dim=1).cpu().numpy()
        assert np.array_equal(back, want[:, :t.used_bytes]), (
            f"restored pages {pages} differ from the spilled bytes")
        held["pages"] += n

    def restore_req_(req):
        live = req.spilled["live_tokens"]
        restore_req(req)
        if req.spilled is None and req.slot >= 0:
            held["tokens"] += live

    t.spill, t.restore = spill_, restore_
    engine._scatter_pages, engine._restore = scatter_, restore_req_
    return held


def count_reprefill(engine):
    """Count the context tokens ``engine``'s evictions send back to
    prefill."""
    evict = engine._evict
    got = {"tokens": 0}

    def evict_(r):
        evict(r)
        got["tokens"] += int(r.ctx.size)

    engine._evict = evict_
    return got


def prefix_traffic(vocab, two_tenants=False, n=24):
    """24 requests on one 1024-token prefix, each with 64..512 suffix
    tokens of its own and 32..128 new tokens (numpy seed 3); every third
    samples; request 19's prompt is the prefix alone.  ``two_tenants``:
    requests 8..15 carry a second 1024-token prefix instead."""
    rng = np.random.default_rng(SEED + 3)
    first, second = (rng.integers(0, vocab, size=1024) for _ in range(2))
    sfx = rng.integers(64, 513, size=n)
    news = rng.integers(32, 129, size=n)
    reqs = []
    for i in range(n):
        prefix = second if two_tenants and 8 <= i < 16 else first
        prompt = (prefix if i == 19 else np.concatenate(
            [prefix, rng.integers(0, vocab, size=int(sfx[i]))]))
        kw = dict(max_new_tokens=int(news[i]))
        if i % 3 == 2:
            kw.update(SAMPLED)
        reqs.append((prompt, kw))
    return reqs


def phase_tiering():
    """Phase 19: KV tiering (A9.2) and the prefix cache (A9.3) on
    ``llama3-8b`` at full width and TIERED_LAYERS layers, bf16, with CUDA
    graphs and the pipeline as in phase 14.  Returns the launches of #9
    and #8 in the phase's tiering and prefix runs."""
    import shutil

    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = get_config("llama3-8b", num_hidden_layers=TIERED_LAYERS)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    module = engine.module
    del engine
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    tiering = dict(TIER, nvme_dir=TIER_DIR)
    graph = {"enable_cuda_graph": True}

    def run(batches, **kw):
        """Serve ``batches`` in turn on one engine (graphs on); the run's
        numbers summed over them, the engine's counters and stats."""
        engine = RaggedInferenceEngineV2(
            module, device="cuda", config=graph, **{**V2, **kw})
        held = hold_restores(engine) if engine.tiering is not None else None
        evicted = count_reprefill(engine)
        kernels = (rpa.ragged_paged_attention, rpa.ragged_paged_attention_quant)
        before = [k.launches for k in kernels]
        outs, tot = [], {}
        for traffic in batches:
            out, r = serve(engine, traffic)
            outs += out
            for k, v in r.items():
                tot[k] = tot.get(k, 0) + v
        tot["decode_tps"] = tot["block_tokens"] / max(tot["block_s"], 1e-9)
        st = engine.serving_stages()
        res = dict(tot, outs=outs, st=st, held=held,
                   launches=[k.launches - b for k, b in zip(kernels, before)],
                   reprefill=evicted["tokens"], spills=engine.spills,
                   restores=engine.restores, evictions=engine.evictions,
                   ticks=engine.host_stats.ticks,
                   backend=(engine.tiering.aio_backend
                            if engine.tiering is not None else None))
        engine.close()
        del engine
        torch.cuda.empty_cache()
        return res

    def same(a, b):
        return sum(np.array_equal(x, y) for x, y in zip(a, b))

    def check_tiers(label, r, nvme=True):
        kt = r["st"]["kv_tiering"]
        assert r["spills"] > 0, f"{label}: nothing spilled"
        if nvme:
            assert kt["demotions"] > 0 and kt["nvme_spills"] > 0, (
                f"{label}: the host tier never overflowed to NVMe")
        assert kt["pages_verified"] == kt["pages_restored"] == \
            r["held"]["pages"] > 0, (label, kt, r["held"])
        assert kt["nvme_offline"] == 0 and kt["nvme_failures"] == 0, (
            f"{label}: the NVMe tier failed: {kt}")
        assert kt["quarantined"] == 0, label
        return kt

    def per_page(kt, stage, pages):
        return 1e3 * kt.get(f"{stage}_s", 0.0) / max(kt[pages], 1)

    # -- the tiering leg: phase 6's tight pool and decode-heavy traffic
    tight = 1 + V2["max_seqs"] * (V2["max_seq_len"] // V2["page_size"] // 4)
    rng = np.random.default_rng(SEED + 2)
    heavy = [(rng.integers(0, cfg.vocab_size, size=100),
              dict(max_new_tokens=500)) for _ in range(V2["max_seqs"])]
    # launches of #9 and #8 in the phase's tiering and prefix runs (the
    # evicting and cache-off runs beside them are not counted)
    launched = [0, 0]
    evict = run([heavy], num_pages=tight, pipeline=True)
    assert evict["evictions"] > 0, "the evicting run never evicted"
    for fmt in ("none", "int8"):
        on = run([heavy], num_pages=tight, pipeline=True,
                 kv_cache_dtype=fmt, kv_tiering=tiering)
        off = run([heavy], num_pages=tight, pipeline=False,
                  kv_cache_dtype=fmt, kv_tiering=tiering)
        assert same(on["outs"], off["outs"]) == len(heavy), (
            f"tiering, {fmt} pool: pipeline on and off give other tokens")
        assert (on["spills"], on["restores"]) == (off["spills"],
                                                  off["restores"])
        kts = [check_tiers(f"tiering, {fmt} pool, pipeline {p}", r)
               for p, r in (("on", on), ("off", off))]
        kt = kts[0]
        # the evicting run serves a bf16 pool: tokens compare with bf16's
        share = (f"{same(on['outs'], evict['outs'])}/16 outputs equal to "
                 "the evicting run's; " if fmt == "none" else "")
        log(f"tiering, {fmt} pool ({tight} pages; host {TIER['host_pages']} "
            f"+ NVMe {TIER['nvme_pages']} pages of "
            f"{on['st']['kv_tiering']['bytes_spilled'] // max(kt['pages_spilled'], 1) / 2**20:.3f}"
            f" MiB; O_DIRECT asked: no; aio backend {on['backend']}), "
            f"16 x (100 + 500) with graphs: pipeline on and off give the "
            f"same tokens; spills {on['spills']}, restores "
            f"{on['restores']}, evictions {on['evictions']} (the evicting "
            f"run: evictions {evict['evictions']}, spills "
            f"{evict['spills']}); re-prefilled tokens avoided "
            f"{on['held']['tokens']} (the evicting run re-prefilled "
            f"{evict['reprefill']}); {kt['pages_restored']} pages "
            f"restored, every one digest-verified and read back equal to "
            f"its spilled bytes; demotions {kt['demotions']}, NVMe spills "
            f"{kt['nvme_spills']}, prefetch hits {kt['prefetch_hits']} "
            f"misses {kt['prefetch_misses']}; ms a page: pinned buffers "
            f"{per_page(kt, 'spill_alloc', 'pages_spilled'):.3f} at spill "
            f"and {per_page(kt, 'restore_alloc', 'pages_restored'):.3f} at "
            f"restore, device->host copy "
            f"{per_page(kt, 'd2h', 'pages_spilled'):.3f}, host->device "
            f"{per_page(kt, 'h2d', 'pages_restored'):.3f}, host-tier copy "
            f"{per_page(kt, 'restore_copy', 'pages_restored'):.3f}, digest "
            f"verify {per_page(kt, 'restore_verify', 'pages_verified'):.3f}"
            f", NVMe read {per_page(kt, 'restore_read', 'pages_restored'):.3f}"
            f"; wall {on['wall_s']:.2f} s (evicting {evict['wall_s']:.2f} s),"
            f" decode {on['decode_tps']:.1f} tokens/s in blocks (evicting "
            f"{evict['decode_tps']:.1f}); {share}"
            f"{on['ticks']} ticks (evicting {evict['ticks']}); "
            f"pipeline off: wall {off['wall_s']:.2f} s, decode "
            f"{off['decode_tps']:.1f} tokens/s; kv_tiering stats {kt}")
        # the kernel of this pool, launched under spilled and restored
        # pages; never the other pool's
        mine = 0 if fmt == "none" else 1
        for r in (on, off):
            assert r["launches"][mine] > 0 and r["launches"][1 - mine] == 0
            launched[mine] += r["launches"][mine]

    # -- the prefix leg: the system prompt is warm (request 0 served
    # first), then the other 23 arrive; the same schedule cache off
    reqs = prefix_traffic(cfg.vocab_size)
    batches = [reqs[:1], reqs[1:]]
    cold = run(batches, pipeline=True)
    on = run(batches, pipeline=True, prefix_cache=True)
    off = run(batches, pipeline=False, prefix_cache=True)
    assert same(on["outs"], off["outs"]) == len(reqs), \
        "prefix cache: pipeline on and off give other tokens"
    pcs = [r["st"]["prefix_cache"] for r in (on, off)]
    assert pcs[0] == pcs[1], pcs
    pc, rq, rq0 = pcs[0], on["st"]["requests"], cold["st"]["requests"]
    assert pc["hit_requests"] > 0 and pc["cow_copies"] >= 1, pc
    for r in (on, off):
        assert r["launches"][0] > 0, "#9 never ran over shared pages"
        launched[0] += r["launches"][0]
    log(f"prefix cache, 24 requests on a 1024-token prefix (request 0 "
        f"first, then 23; graphs): pipeline on and off give the same "
        f"tokens; hits {pc['hit_requests']}/{pc['hit_requests'] + pc['miss_requests']}"
        f" (hit rate {pc['hit_rate']}), hit pages {pc['hit_pages']}, COW "
        f"copies {pc['cow_copies']}; prefill tokens computed "
        f"{rq['prefill_computed_tokens']} + cached "
        f"{rq['prefill_cached_tokens']} (cache off: computed "
        f"{rq0['prefill_computed_tokens']}); TTFT p50 {rq['ttft_ms_p50']} "
        f"ms p99 {rq['ttft_ms_p99']} ms (cache off: p50 "
        f"{rq0['ttft_ms_p50']} p99 {rq0['ttft_ms_p99']}); wall "
        f"{on['wall_s']:.2f} s (cache off {cold['wall_s']:.2f} s); "
        f"{same(on['outs'], cold['outs'])}/24 outputs equal to cache-off's")

    # -- demotion and revival: a second tenant's prefix (requests 8..15)
    # takes the pool while the first prefix is cold; under pressure its
    # index pages demote into the tiers and revive for requests 16..23
    small = 1 + 64
    r2 = run([prefix_traffic(cfg.vocab_size, two_tenants=True)],
             num_pages=small, pipeline=True, prefix_cache=True,
             kv_tiering=tiering)
    pc, kt = r2["st"]["prefix_cache"], r2["st"]["kv_tiering"]
    assert pc["demotions"] > 0 and pc["revivals"] > 0, pc
    assert kt["pages_verified"] == kt["pages_restored"] == \
        r2["held"]["pages"] > 0, (kt, r2["held"])
    assert kt["nvme_offline"] == 0 and kt["nvme_failures"] == 0, kt
    log(f"prefix cache + tiering, two tenants in {small} pages: demotions "
        f"{pc['demotions']}, revivals {pc['revivals']}, drops "
        f"{pc['drops']}, hits {pc['hit_requests']}, spills {r2['spills']}, "
        f"evictions {r2['evictions']}; {kt['pages_restored']} pages "
        f"restored, each read back equal to its spilled bytes; wall "
        f"{r2['wall_s']:.2f} s; {r2['ticks']} ticks")
    assert r2["launches"][0] > 0
    launched[0] += r2["launches"][0]
    shutil.rmtree(TIER_DIR, ignore_errors=True)
    log(f"phase 19 launches in its tiering and prefix runs: "
        f"ragged_paged_attn {launched[0]} (bf16 pools), "
        f"ragged_paged_attn_quant {launched[1]} (int8 pools); counted at "
        "eager ticks, warm-ups and captures, as in phase 14")
    del module, model
    gc.collect()
    torch.cuda.empty_cache()
    return launched


# ---------------------------------------------------------------------------
# Phase 20: speculative decoding on the v2 engine
# ---------------------------------------------------------------------------

SPEC_K = 4
# phase 20 serves llama3-8b at full width and this many of its 32 layers,
# with a draft of this many of TinyLlama's 22, for the smoke's time: its
# runs hold tokens, launches and the pipeline, which are the same at any
# depth
SPEC_LAYERS = 8
# the draft of draft mode: TinyLlama's shape with Llama 3's vocabulary
DRAFT_PRESET = dict(vocab_size=128256, rope_theta=500000.0,
                    max_position_embeddings=8192)


def spec_launches(engine, L, Ld, k):
    """The paged kernel's launches over ``engine``'s life, for a target
    of ``L`` layers and a draft of ``Ld`` (0 for n-gram drafting), as
    ``(python, device)``: a fused or plain decode tick launches L, a
    speculative tick L + k x Ld (k draft steps), a draft catch-up chunk
    Ld.  The Python counters tick at eager ticks and at a capture's
    warm-up and capture, never at a replay; the device's launches are
    derived from the replays, not traced.  By block: the captured keys
    are ``(spec, sampled)``, and a capturing engine replays every block
    it dispatches."""
    st, g, K = engine.host_stats, engine._graphs, engine.decode_block_size
    spec, plain = L + k * Ld, L
    cap = {b: sum(key[0] == b for key in g.graphs) for b in (False, True)}
    rep = {True: st.spec_dispatches if g.capturing else 0}
    rep[False] = st.graph_replays - rep[True]
    spec_eager = K * (st.spec_dispatches - rep[True])
    plain_eager = st.ticks - K * st.spec_dispatches - K * rep[False]
    catchup = Ld * engine.draft_catchup_chunks
    python = (plain * (plain_eager + 2 * K * cap[False]) +
              spec * (spec_eager + 2 * K * cap[True]) + catchup)
    device = (plain * (plain_eager + K * (cap[False] + rep[False])) +
              spec * (spec_eager + K * (cap[True] + rep[True])) + catchup)
    return python, device


def first_divergence(got, want):
    """(request, token) of the first position where two runs' outputs
    differ, or None."""
    for i, (a, b) in enumerate(zip(got, want)):
        diff = np.nonzero(a != b)[0]
        if diff.size:
            return i, int(diff[0])
    return None


def phase_spec():
    """Phase 20: speculative decoding (A9.4) on ``llama3-8b`` at full
    width and SPEC_LAYERS layers, bf16, phase 6's engine (``V2``) with
    CUDA graphs and the pipeline, n-gram (k 4) and draft mode (TinyLlama's
    shape with Llama 3's vocabulary, SPEC_LAYERS layers, D 64); then 2
    layers at full width in fp32 against speculation off.  Returns the
    launches of #9 (bf16 pools) and #8 (the int8 pool) in the phase's
    speculative runs."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = get_config("llama3-8b", num_hidden_layers=SPEC_LAYERS)
    dcfg = get_config("llama-1b", num_hidden_layers=SPEC_LAYERS,
                      **DRAFT_PRESET)
    L, Ld = cfg.num_hidden_layers, dcfg.num_hidden_layers
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    module = engine.module
    del engine
    with torch.device("meta"):
        draft = LlamaForCausalLM(dcfg)
    t0 = time.perf_counter()
    engine = RaggedInferenceEngineV2(
        module, device="cuda", speculation={"mode": "draft", "k": SPEC_K},
        draft_model=draft,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 20),
        **V2)
    draft = engine._draft_module
    log(f"spec: draft model (llama-1b shape, vocab {dcfg.vocab_size}, "
        f"{Ld} layers, D {dcfg.head_dim}) up in "
        f"{time.perf_counter() - t0:.1f} s, draft pool "
        f"{sum(p.nbytes() for p in engine._draft_cache) / 2**30:.3f} GiB")
    del engine
    torch.cuda.empty_cache()
    graph = {"enable_cuda_graph": True}
    # phase 6's prompts and budgets, every request greedy; and sampled at
    # t 0.8, top-p 0.95
    greedy = [(p, dict(max_new_tokens=kw["max_new_tokens"]))
              for p, kw in v2_traffic()]
    sampled = [(p, dict(kw, do_sample=True, temperature=0.8, top_p=0.95))
               for p, kw in greedy]
    launched = [0, 0]

    def run(label, traffic, mode="ngram", count=True, **kw):
        """One engine over ``traffic``; checks the paged kernels' Python
        counts against the ticks, prints the run's numbers."""
        spec = {"mode": mode, "k": SPEC_K}
        if mode == "draft":
            kw["draft_model"] = draft
        fmt = kw.get("kv_cache_dtype", "none")
        kernel = (rpa.ragged_paged_attention_quant if fmt != "none"
                  else rpa.ragged_paged_attention)
        other = (rpa.ragged_paged_attention if fmt != "none"
                 else rpa.ragged_paged_attention_quant)
        engine = RaggedInferenceEngineV2(module, device="cuda",
                                         speculation=spec, **{**V2, **kw})
        before, before_other = kernel.launches, other.launches
        torch.cuda.reset_peak_memory_stats()
        out, r = serve(engine, traffic)
        peak = torch.cuda.max_memory_allocated() / 2**30
        st = engine.serving_stages()
        hs = engine.host_stats
        python, device = spec_launches(engine, L,
                                       Ld if mode == "draft" else 0, SPEC_K)
        got = kernel.launches - before
        assert got == python, (
            f"spec {label}: {kernel.__name__} counted {got} launches, want "
            f"{python} from the ticks, captures and catch-ups")
        assert other.launches == before_other, f"spec {label}: {other}"
        if count:
            launched[fmt != "none"] += got
        sp = st["speculation"]
        assert sp["spec_dispatches"] > 0 and sp["proposed"] > 0
        if engine.pipeline:
            assert hs.blocking_gets < hs.dispatches, (
                f"spec {label}: a pipelined run fetched {hs.blocking_gets} "
                f"times over {hs.dispatches} dispatches")
        g = engine._graphs
        log(f"spec {label}: {len(traffic)} requests in {r['wall_s']:.2f} s; "
            f"acceptance {sp['acceptance_rate']} ({sp['accepted']}/"
            f"{sp['proposed']}), mean accepted length "
            f"{sp['mean_accepted_len']}, {sp['effective_tokens_per_dispatch']}"
            f" tokens a speculative block; spec dispatches "
            f"{sp['spec_dispatches']} of {hs.dispatches}, blocking fetches "
            f"{hs.blocking_gets}; decode {r['decode_tps']:.1f} tokens/s in "
            f"blocks ({r['block_tokens']} tokens, {r['block_s']:.2f} s, "
            f"{r['blocks']} blocks); verify {sp['verify_ms']} ms and "
            f"draft catch-up {sp['draft_ms']} ms a speculative dispatch "
            f"(host clock); captured (spec, sampled) {sorted(g.graphs)} "
            f"({st.get('graph_capture_s', 0.0):.3f} s), replays "
            f"{hs.graph_replays};"
            f" peak {peak:.2f} GiB; {kernel.__name__} launches {got} "
            f"(device, derived from the replays: {device}); catch-up chunks "
            f"{engine.draft_catchup_chunks}")
        del engine
        torch.cuda.empty_cache()
        return out, dict(r, peak=peak, spec=sp)

    # -- n-gram drafting, greedy: spec off first, in this call
    engine = RaggedInferenceEngineV2(module, device="cuda", config=graph,
                                     **{**V2, "pipeline": True})
    off, roff = serve(engine, greedy)
    del engine
    torch.cuda.empty_cache()
    log(f"spec off, greedy traffic, graphs and the pipeline: decode "
        f"{roff['decode_tps']:.1f} tokens/s in blocks ({roff['blocks']} "
        f"blocks, {roff['block_tokens']} tokens)")
    on1, r1 = run("ngram greedy, graphs + pipeline", greedy, config=graph,
                  pipeline=True)
    on2, _ = run("ngram greedy, graphs + pipeline (again)", greedy,
                 config=graph, pipeline=True, count=False)
    assert all(np.array_equal(a, b) for a, b in zip(on1, on2)), \
        "two ngram runs differ"
    on3, _ = run("ngram greedy, graphs, pipeline off", greedy, config=graph,
                 count=False)
    assert all(np.array_equal(a, b) for a, b in zip(on1, on3)), \
        "ngram tokens with the pipeline off differ"
    on4, _ = run("ngram greedy, eager, pipeline off", greedy, count=False)
    assert all(np.array_equal(a, b) for a, b in zip(on1, on4)), \
        "ngram tokens through graphs differ from the eager run's"
    same = sum(np.array_equal(a, b) for a, b in zip(on1, off))
    log(f"spec ngram greedy: identical twice, pipeline on and off, graphs "
        f"and eager; {same}/24 outputs equal speculation off's in bf16 at "
        f"{L} layers (first divergence (request, token): "
        f"{first_divergence(on1, off)}; the verify GEMMs run at M = "
        f"{V2['max_seqs'] * (SPEC_K + 1)} where the plain block's run at "
        f"M = {V2['max_seqs']}: other kernels, other roundings); decode "
        f"{r1['decode_tps']:.1f} tokens/s against {roff['decode_tps']:.1f} "
        "off")
    s1, _ = run("ngram sampled", sampled, config=graph, pipeline=True)
    s2, _ = run("ngram sampled (again)", sampled, config=graph,
                pipeline=True, count=False)
    assert all(np.array_equal(a, b) for a, b in zip(s1, s2)), \
        "two sampled ngram runs differ"
    run("ngram greedy, int8 KV pool", greedy[:8], config=graph,
        pipeline=True, kv_cache_dtype="int8")
    # -- draft mode
    d1, rd = run("draft greedy, graphs + pipeline", greedy, mode="draft",
                 config=graph, pipeline=True)
    d2, _ = run("draft greedy, graphs + pipeline (again)", greedy,
                mode="draft", config=graph, pipeline=True, count=False)
    assert all(np.array_equal(a, b) for a, b in zip(d1, d2)), \
        "two draft runs differ"
    d3, _ = run("draft greedy, graphs, pipeline off", greedy, mode="draft",
                config=graph, count=False)
    assert all(np.array_equal(a, b) for a, b in zip(d1, d3)), \
        "draft tokens with the pipeline off differ"
    log(f"spec draft greedy: identical twice, pipeline on and off; "
        f"{sum(np.array_equal(a, b) for a, b in zip(d1, off))}/24 equal "
        f"speculation off's; decode {rd['decode_tps']:.1f} tokens/s against "
        f"{roff['decode_tps']:.1f} off")
    del module, model, draft
    gc.collect()
    torch.cuda.empty_cache()
    phase_spec_fp32()
    log(f"phase 20 launches in its counted speculative runs: "
        f"ragged_paged_attn {launched[0]} (bf16 pools, target and draft), "
        f"ragged_paged_attn_quant {launched[1]} (int8 pool)")
    assert launched[0] > 0 and launched[1] > 0
    return launched


NEW_FP32 = 161


def phase_spec_fp32():
    """2 layers at full width in fp32 (TF32 off), random seeded weights
    made on the card: greedy speculation (n-gram, a 2-layer draft of the
    draft's shape, and self-draft) against speculation off on the card,
    by phase 7's margin rule; self-draft accepts at least 95% of its
    proposals."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3-8b", num_hidden_layers=2, dtype=torch.float32)
    dcfg = get_config("llama-1b", num_hidden_layers=2, dtype=torch.float32,
                      **DRAFT_PRESET)
    rng = np.random.default_rng(SEED + 20)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (37, 100, 300, 513)]
    # 160 tokens after the first: the budget clamp of each request's last
    # tick (proposals counted, fewer accepted) weighs little
    kw = dict(max_seqs=4, max_seq_len=704, prefill_chunk=128, page_size=64,
              decode_block_size=4)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    off_eng = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED + 20),
        device="cuda", **kw)
    outs = off_eng.generate_all(prompts, max_new_tokens=NEW_FP32)
    want = [outs[u] for u in sorted(outs)]
    module = off_eng.module
    del off_eng
    margins = []
    with torch.no_grad():
        for p, w in zip(prompts, want):
            logits = module(torch.from_numpy(w[None, :-1]).cuda())[0]
            top2 = logits[len(p) - 1:].topk(2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
    for mode, label in (("ngram", "ngram"), ("draft", "draft"),
                        ("draft", "self-draft")):
        extra = {}
        if label == "draft":
            with torch.device("meta"):
                extra = dict(draft_model=LlamaForCausalLM(dcfg))
            extra["generator"] = torch.Generator(
                device="cuda").manual_seed(SEED + 21)
        elif label == "self-draft":
            extra = dict(draft_model=module)
        eng = RaggedInferenceEngineV2(
            module, device="cuda", speculation={"mode": mode, "k": SPEC_K},
            **kw, **extra)
        outs = eng.generate_all(prompts, max_new_tokens=NEW_FP32)
        got = [outs[u] for u in sorted(outs)]
        eng.audit_kv_sharing()
        sp = eng.serving_stages()["speculation"]
        for p, g, w, m in zip(prompts, got, want, margins):
            diff = np.nonzero(g != w)[0]
            if diff.size:
                i = int(diff[0]) - len(p)
                log(f"spec fp32 {label}: prompt {len(p)}: first differing "
                    f"token {i}, spec-off top-2 margin {m[i]:.3e}")
                assert m[i] < MARGIN, (
                    f"spec fp32 {label}: tokens differ from speculation "
                    f"off at {i} with margin {m[i]:.3e}")
        same = sum(np.array_equal(a, b) for a, b in zip(got, want))
        log(f"spec fp32, 2 layers, {label}: {same}/4 requests token-equal "
            f"to speculation off; acceptance {sp['acceptance_rate']} "
            f"({sp['accepted']}/{sp['proposed']}), mean accepted length "
            f"{sp['mean_accepted_len']}; smallest spec-off top-2 margin "
            f"{min(float(m.min()) for m in margins):.3e}")
        if label == "self-draft":
            assert sp["acceptance_rate"] >= 0.95, (
                f"self-draft accepted {sp['acceptance_rate']:.1%} of its "
                "proposals")
        del eng, extra
        gc.collect()
        torch.cuda.empty_cache()
    del module, model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 21: long context (A9.5) on the v2 engine
# ---------------------------------------------------------------------------

# the reference's knobs: a resident need of sink 1 + window 8 + group 4 +
# the frontier 1 = 14 pages.  A 4064 + 32 request is 64 pages (4096
# tokens, 128 MiB of bf16 KV over TIERED_LAYERS = 8 layers) on a 17-page
# pool (16 usable, 32 MiB): 4x over it.  The tiers: 24 host pages
# (pinned) and 64 NVMe pages under the git-ignored build/, removed
# afterwards, so most page-ins come from NVMe.  One middle group is 4
# pages x 8 layers x 256 KiB = 8 MiB.
LC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                      "smoke_lc")
LC_TIER = dict(long_context=True, sink_pages=1, window_pages=8,
               chunk_pages=4, host_pages=24, nvme_pages=64, nvme_dir=LC_DIR)
LC_ENGINE = dict(max_seqs=8, max_seq_len=4096, prefill_chunk=512,
                 page_size=64, decode_block_size=8,
                 config={"enable_cuda_graph": True})
LC_POOL, LC_CONTROL_POOL = 17, 70
LC_PROMPT, LC_NEW = 4064, 32


def probe_lc(engine):
    """Record every long-context tick of ``engine``: the context it
    attends (kv_len), whether it decodes, its wall seconds, its page-in
    wait and verify seconds (the tier store's ``pagein_wait`` and
    ``pagein_verify``), its staged-stats dispatches, the device's peak
    bytes during it and the residency after it."""
    drv, tm = engine._lc, engine.tiering.timers.seconds
    rec, tick = [], drv.tick

    def tick_(r):
        decode = r.prefill_done >= r.ctx_len
        kv = r.length if decode else min(r.prefill_done + engine.page_size,
                                          r.ctx_len)
        w0, v0 = tm.get("pagein_wait", 0.0), tm.get("pagein_verify", 0.0)
        d0 = drv.staged_dispatches
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        n = tick(r)
        torch.cuda.synchronize()
        rec.append(dict(kv=kv, decode=decode, s=time.perf_counter() - t,
                        wait=tm.get("pagein_wait", 0.0) - w0,
                        verify=tm.get("pagein_verify", 0.0) - v0,
                        staged=drv.staged_dispatches - d0,
                        peak=torch.cuda.max_memory_allocated(),
                        **drv.residency(r)))
        return n

    drv.tick = tick_
    return rec


def first_logits(engine):
    """The logits each request's first token was sampled from (by uid)."""
    got, sample = {}, engine._sample

    def sample_(sel, samplers):
        for r, j, wants in samplers:
            if wants and not r.generated:
                got[r.uid] = sel[j].float().cpu()
        return sample(sel, samplers)

    engine._sample = sample_
    return got


def lc_serve(engine, prompt, new, later=()):
    """Serve ``prompt`` (+ ``new`` greedy tokens); submit ``later``'s
    requests once its prompt is prefilled.  Returns the outputs in
    submission order, the wall seconds from submission to the first
    token and from there to the end (less any CUDA-graph capture), and
    the logits of the first token."""
    logits = first_logits(engine)
    uid = engine.put_request(prompt, max_new_tokens=new)
    uids, outs = [uid], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    t1 = None
    while engine.has_work():
        engine.step()
        if t1 is None and uid in logits:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            cap = engine.host_stats.graph_capture_s
            uids += [engine.put_request(p, **kw) for p, kw in later]
        outs.update(engine.get_outputs())
        engine.audit_kv_sharing()
    t2 = time.perf_counter()
    assert engine.tiering is None or engine.tiering.audit()["sessions"] == 0
    for u, (p, kw) in zip(uids, [(prompt, dict(max_new_tokens=new))] +
                          list(later)):
        assert outs[u].shape == (len(p) + kw["max_new_tokens"],)
    cap = engine.host_stats.graph_capture_s - cap
    return [outs[u] for u in uids], t1 - t0, t2 - t1 - cap, logits[uid]


def lc_engine(module, fmt="none", **kw):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2

    return RaggedInferenceEngineV2(module, device="cuda", kv_cache_dtype=fmt,
                                   **{**LC_ENGINE, **kw})


def phase_lc():
    """Phase 21: long context (A9.5) on ``llama3-8b`` at full width and
    TIERED_LAYERS layers, bf16, CUDA graphs on: one 4064 + 32 request on
    a 17-page pool (4x over it) against the same request fully resident,
    over a bf16 and an int8 pool; the request beside 4 normal requests,
    pipeline on and off; then 2 layers in fp32 against their resident
    control by phase 7's margin rule.  Returns the launches of #9 (bf16
    pool) and #8 (int8 pool) in the long-context runs."""
    import shutil

    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    cfg = get_config("llama3-8b", num_hidden_layers=TIERED_LAYERS)
    L = cfg.num_hidden_layers
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    module = lc_engine(
        model, num_pages=LC_CONTROL_POOL,
        generator=torch.Generator(device="cuda").manual_seed(SEED)).module
    rng = np.random.default_rng(SEED + 21)
    prompt = rng.integers(0, cfg.vocab_size, size=LC_PROMPT)
    launches = {}
    lc_outs = {}
    for fmt, fn in (("none", rpa.ragged_paged_attention),
                    ("int8", rpa.ragged_paged_attention_quant)):
        ctl = lc_engine(module, fmt, num_pages=LC_CONTROL_POOL)
        (want,), c_pre, c_dec, c_logits = lc_serve(ctl, prompt, LC_NEW)
        del ctl
        eng = lc_engine(module, fmt, num_pages=LC_POOL, kv_tiering=LC_TIER)
        rec = probe_lc(eng)
        fn.launches = 0                 # the main path starts here
        (got,), pre, dec, logits = lc_serve(eng, prompt, LC_NEW)
        launches[fmt] = fn.launches
        drv = eng._lc
        assert drv.ticks == eng.host_stats.ticks == len(rec)
        assert fn.launches == L * drv.ticks, (
            f"{fn.launches} launches of the paged kernel, want {L} x "
            f"{drv.ticks} long-context ticks")
        st = eng.serving_stages()["kv_tiering"]
        assert st["pageins"] > 0 and drv.parks > 0
        assert st["pages_verified"] == st["pagein_pages"], (
            f"{st['pages_verified']} pages verified of "
            f"{st['pagein_pages']} paged in")
        assert st["quarantined"] == 0 and st["nvme_failures"] == 0
        eng.close()
        del eng
        lc_outs[fmt] = got
        new = slice(LC_PROMPT, None)
        same = int((got[new] == want[new]).sum())
        div = first_divergence([got[new]], [want[new]])
        dlogit = (logits - c_logits).abs().max().item()
        tick_ms = np.asarray([x["s"] for x in rec]) * 1e3
        wait = np.asarray([x["wait"] for x in rec if x["staged"]]) * 1e3
        verify = np.asarray([x["verify"] for x in rec if x["staged"]]) * 1e3
        staged = [x["staged"] for x in rec]
        at = {n: max(x["peak"] for x in rec if n - 64 < x["kv"] <= n)
              for n in (2048, 4096)}
        last = rec[-1]
        total = last["resident_pages"] + last["parked_pages"]
        dec_n = sum(1 for x in rec if x["decode"])
        log(f"[{smi}] lc {fmt} pool: {LC_PROMPT} + {LC_NEW} tokens on "
            f"{LC_POOL} pages, {same}/{LC_NEW} new tokens equal to the "
            f"resident control ({LC_CONTROL_POOL} pages), first divergence "
            f"{None if div is None else div[1]}; max |dlogit| of the first "
            f"sampled position {dlogit:.4e}; {drv.ticks} ticks "
            f"({dec_n} decode), {drv.parks} groups parked; page-ins "
            f"{st['pageins']}, pages {st['pagein_pages']}, bytes "
            f"{st['pagein_bytes']}, prefetch hits "
            f"{st['pagein_prefetch_hits']} misses "
            f"{st['pagein_prefetch_misses']}, every page digest-verified "
            f"({st['pages_verified']}); pagein_wait ms/tick p50 "
            f"{np.percentile(wait, 50):.2f} p99 {np.percentile(wait, 99):.2f}"
            f", pagein_verify p50 {np.percentile(verify, 50):.2f} p99 "
            f"{np.percentile(verify, 99):.2f}; staged-stats dispatches a "
            f"tick mean {np.mean(staged):.1f} max {max(staged)}; tick ms "
            f"p50 {np.percentile(tick_ms, 50):.1f} max {tick_ms.max():.1f}"
            f"; decode {(LC_NEW - 1) / dec:.2f} tokens/s against the "
            f"control's {(LC_NEW - 1) / c_dec:.2f} (graphs, pipeline, its "
            f"capture left out); "
            f"prefill {pre:.2f} s against {c_pre:.2f} s; residency "
            f"{last['resident_pages']}/{total} pages "
            f"({last['resident_pages'] / total:.3f}); peak "
            f"{at[2048] / 2**30:.3f} GiB at 2048 tokens of context, "
            f"{at[4096] / 2**30:.3f} GiB at 4096; {fn.__name__} launches "
            f"{fn.launches} = {L} x {drv.ticks} ticks")
        assert abs(at[4096] - at[2048]) <= 0.5 * 2**30, (
            "device memory grew with the parked middle")
        gc.collect()
        torch.cuda.empty_cache()

    # mixed traffic: the request, and 4 normal requests submitted once its
    # prompt is in; the normal ones take the fused tick while it is live
    # and decode blocks after, pipeline on and off the same
    mixed = [(rng.integers(0, cfg.vocab_size, size=int(n)),
              dict(max_new_tokens=int(m)))
             for n, m in zip(rng.integers(128, 513, size=4),
                             rng.integers(32, 65, size=4))]
    runs = {}
    for pipeline in (True, False):
        eng = lc_engine(module, num_pages=LC_POOL + 4 * 9,
                        kv_tiering=LC_TIER, pipeline=pipeline)
        during = []
        for name in ("_pipeline_start", "_step_block"):
            orig = getattr(eng, name)

            def wrap(*a, _orig=orig, _eng=eng, **k):
                during.append(any(s is not None and s.lc and not s.done
                                  for s in _eng.slots))
                return _orig(*a, **k)

            setattr(eng, name, wrap)
        outs, pre, dec, _ = lc_serve(eng, prompt, LC_NEW, later=mixed)
        assert during and not any(during), (
            f"decode blocks: {len(during)}, {sum(during)} while the "
            "long-context request was live")
        assert np.array_equal(outs[0], lc_outs["none"]), (
            "the long-context request's tokens changed beside traffic")
        runs[pipeline] = outs
        log(f"[{smi}] lc mixed traffic, pipeline {pipeline}: the request "
            f"and 4 normal ones in {pre + dec:.2f} s (graph capture left "
            f"out); decode blocks started {len(during)} times, never while "
            f"it was live; its tokens equal to its solo run's")
        eng.close()
        del eng
    for a, b in zip(runs[True], runs[False]):
        assert np.array_equal(a, b), "pipeline on and off differ"
    log("lc mixed traffic: pipeline on and off give the same tokens for "
        "all 5 requests")
    del model, module
    gc.collect()
    torch.cuda.empty_cache()
    phase_lc_fp32(smi)
    shutil.rmtree(LC_DIR, ignore_errors=True)
    return launches["none"], launches["int8"]


def phase_lc_fp32(smi):
    """2 layers at full width in fp32 (TF32 off), random seeded weights
    made on the card: a 1024 + 32 long-context request on the 17-page
    pool against the fully resident control, by phase 7's margin rule."""
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3-8b", num_hidden_layers=2, dtype=torch.float32)
    rng = np.random.default_rng(SEED + 22)
    prompt = rng.integers(0, cfg.vocab_size, size=1024)
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    ctl = lc_engine(
        model, num_pages=LC_CONTROL_POOL,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 22))
    (want,), *_ = lc_serve(ctl, prompt, LC_NEW)
    module = ctl.module
    del ctl
    eng = lc_engine(module, num_pages=LC_POOL, kv_tiering=LC_TIER)
    (got,), *_ = lc_serve(eng, prompt, LC_NEW)
    parks, pageins = eng._lc.parks, eng.tiering.counters["pageins"]
    eng.close()
    del eng
    assert parks > 0 and pageins > 0
    with torch.no_grad():
        logits = module(torch.from_numpy(want[None, :-1]).cuda())[0]
    top2 = logits[len(prompt) - 1:].topk(2, dim=-1).values
    margins = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    diff = np.nonzero(got != want)[0]
    if diff.size:
        i = int(diff[0]) - len(prompt)
        log(f"[{smi}] lc fp32: first differing token {i}, control top-2 "
            f"margin {margins[i]:.3e}")
        assert margins[i] < MARGIN, (
            f"lc fp32: tokens differ from the control at {i} with margin "
            f"{margins[i]:.3e}")
    log(f"[{smi}] lc fp32, 2 layers: 1024 + {LC_NEW} on {LC_POOL} pages, "
        f"{int((got == want).sum()) - 1024}/{LC_NEW} new tokens equal to "
        f"the resident control; {parks} groups parked, {pageins} page-ins; "
        f"smallest control top-2 margin {float(margins.min()):.3e}")
    del module, model, logits
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 22: fp8, fp6 and w8a8 weights (K1, K2, the W8A8 GEMM) through v2, v1
# ---------------------------------------------------------------------------

WQ_FORMATS = ("fp8", "fp6", "w8a8")
# llama3-8b's Linears as flax kernels [in, out]: the kernels' shapes; the
# W8A8 GEMM also at k_proj, whose 8 channel tiles split K the most
WQ_WEIGHTS = {"gate_proj": (4096, 14336), "down_proj": (14336, 4096),
              "lm_head": (4096, 128256)}
W8A8_WEIGHTS = {**WQ_WEIGHTS, "k_proj": (4096, 1024)}
W8A8_ROWS = (1, 16, 17, 80, 512)


def bits_equal(a, b) -> bool:
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.contiguous().view(word), b.contiguous().view(word)))


def wq_counters(fmt, L, native):
    """(wrapper, launches a forward or model tick) of a format's per-use
    kernels: every quantized weight once (7 a layer, the embedding and the
    head); native w8a8 runs the W8A8 Linear's row pre-pass and GEMM once
    a Linear and #7 on the int8 embedding, v1's w8a8 expands its Linears
    through K1 instead."""
    from deepspeed_tpu_torch.ops import quantization as qz

    n = 7 * L + 2
    if fmt == "fp8":
        return [(qz.dequant_scaled, n)]
    if fmt == "fp6":
        return [(qz.dequantize_fp6, n)]
    if native:
        return [(qz.w8a8_quant_rows, n - 1), (qz.w8a8_gemm, n - 1),
                (qz.dequantize, 1)]
    return [(qz.dequant_scaled, n - 1), (qz.dequantize, 1)]


def wq_entry(name, ms, plain_ms, nbytes, line, ops=0,
             source="weight_formats.cu"):
    """A kernels-line entry bounded by ``nbytes`` at the card's memory
    rate or ``ops`` int8 operations at its int8 rate, the larger."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, ops / PEAK_INT8
    return dict(name=name, route="cuda",
                source=f"deepspeed_tpu_torch/ops/csrc/{source}",
                replaces=line, launches=0, max_abs_err=0.0, ms=ms,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops) * 1e3,
                bound_by="bytes" if t_bytes >= t_ops else "operations",
                library_ms=None)


def phase_wq_kernels():
    """K1, K2 and the W8A8 GEMM against their plain versions, bit for
    bit (bf16): K1 over e4m3 (one scale) and int8 (a scale a row) and K2
    at groups of 128 and 2048 at gate_proj, down_proj and lm_head; the
    W8A8 Linear (the row pre-pass ``w8a8_quant_rows``, then the GEMM
    ``w8a8_gemm``) at those and k_proj at 1, 16, 17,
    80 and 512 rows, with a zero row, and the pre-pass's rows and scales
    themselves.  Times each at gate_proj (device time, graph-replayed)
    beside its bound and its plain version; the W8A8 GEMM at 16 and 512
    rows beside ``torch._int_mm`` (the product alone) and bf16
    ``F.linear``, and at 16 rows at k_proj and lm_head."""
    from deepspeed_tpu_torch.ops import quantization as qz

    bf16 = torch.bfloat16
    entries = {}
    worst = dict.fromkeys(("dequant_scaled", "dequant_fp6",
                           "w8a8_quant_rows", "w8a8_gemm"), 0.0)

    def err(name, a, b):
        worst[name] = max(worst[name], (a.float() - b.float()).abs().max()
                          .item())

    for i, (wname, (K, N)) in enumerate(W8A8_WEIGHTS.items()):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2200 + i)
        # nn.Linear's [out, in], rows of mixed magnitude
        w = (torch.randn(N, K, generator=gen, device="cuda") *
             torch.rand(N, 1, generator=gen, device="cuda") * 0.05).to(bf16)
        v, s = qz.quantize_per_channel(w)
        parts = [w8a8_checks(wname, w, v, s, gen, entries, err)]
        if wname in WQ_WEIGHTS:
            parts.insert(0, wq_dequant_checks(wname, w, v, s, entries, err))
        line = f"wq[{wname}] [{K}, {N}] bf16: " + "; ".join(parts)
        log(line)
        del w, v, s
        torch.cuda.empty_cache()
    for e in entries.values():
        e["max_abs_err"] = worst[[k for k in worst
                                  if e["name"].startswith(k)][0]]
    log("weight-format kernels: no single PyTorch call computes a scaled "
        "dequant, fp6 decode, per-row int8 quantization or the W8A8 Linear "
        "(torch._int_mm is its int8 product alone, timed beside it; "
        "torch._scaled_mm quantizes differently), so library_ms is null")
    return entries


def wq_dequant_checks(wname, w, v, s, entries, err):
    """K1 and K2 at one weight, bit for bit; timed at gate_proj."""
    from deepspeed_tpu_torch.ops import quantization as qz

    bf16 = torch.bfloat16
    kernel = w.t().contiguous()
    n = w.numel()
    timed = wname == "gate_proj"
    ft = qz.quantize_fp8(kernel)
    got = qz.dequantize_fp8(ft)
    want = qz.dequant_scaled_reference(ft.values, ft.scale, bf16)
    assert bits_equal(got, want), f"K1 e4m3 at {wname}"
    err("dequant_scaled", got, want)
    got = qz.dequant_scaled(v, s, bf16)
    want = qz.dequant_scaled_reference(v, s, bf16)
    assert bits_equal(got, want), f"K1 int8 per row at {wname}"
    err("dequant_scaled", got, want)
    line = "K1 over e4m3 and int8 a scale a row bit-identical to plain"
    del got, want
    if timed:
        ms = graph_ms(lambda: qz.dequantize_fp8(ft))
        plain = time_ms(lambda: qz.dequant_scaled_reference(
            ft.values, ft.scale, bf16), reps=3, warmup=1)
        ms_row = graph_ms(lambda: qz.dequant_scaled(v, s, bf16))
        entries["dequant_scaled"] = wq_entry(
            "dequant_scaled", ms, plain, 3 * n + 4,
            "deepspeed_tpu/ops/quantization.py:175")
        e = entries["dequant_scaled"]
        line += (f"; K1 e4m3 {ms:.4f} ms (bound {e['bound_ms']:.4f}, "
                 f"{e['bound_ms'] / ms:.1%}; plain {plain:.3f}), int8 "
                 f"a scale a row {ms_row:.4f} ms")
    del ft
    for gs in (128, 2048):
        t6 = qz.quantize_fp6(kernel, gs)
        got = qz.dequantize_fp6(t6)
        want = qz.dequantize_fp6_reference(t6)
        assert t6.group_size == gs and bits_equal(got, want), (
            f"K2 at {wname}, groups of {gs}")
        err("dequant_fp6", got, want)
        del got, want
        line += f"; K2 groups of {gs} bit-identical"
        if timed:
            ms = graph_ms(lambda: qz.dequantize_fp6(t6))
            plain = time_ms(lambda: qz.dequantize_fp6_reference(t6),
                            reps=3, warmup=1)
            nbytes = t6.values.numel() + 4 * t6.scale.numel() + 2 * n
            e = wq_entry(f"dequant_fp6_g{gs}", ms, plain, nbytes,
                         "deepspeed_tpu/ops/quantization.py:274")
            entries[e["name"]] = e
            line += (f" ({ms:.4f} ms, bound {e['bound_ms']:.4f}, "
                     f"{e['bound_ms'] / ms:.1%}; plain {plain:.3f})")
        del t6
    return line


def w8a8_checks(wname, w, v, s, gen, entries, err):
    """The W8A8 GEMM at one weight and every row count of W8A8_ROWS, bit
    for bit against ``w8a8_linear_reference``; timed at gate_proj (16
    and 512 rows) and at 16 rows at k_proj and lm_head."""
    from torch.nn import functional as F

    from deepspeed_tpu_torch.ops import quantization as qz

    N, K = v.shape
    line = "W8A8 Linear (pre-pass and GEMM) bit-identical at M"
    for M in W8A8_ROWS:
        x = torch.randn(M, K, generator=gen, device="cuda").to(torch.bfloat16)
        x[0] = 0
        lin = qz.w8a8_linear(x, v, s)
        want = qz.w8a8_linear_reference(x, v, s)
        assert bits_equal(lin, want), f"W8A8 GEMM at {wname}, M {M}"
        err("w8a8_gemm", lin, want)
        xq, sx = qz.w8a8_quant_rows(x)
        rq, rs = qz.w8a8_quant_rows_reference(x)
        assert torch.equal(xq, rq) and bits_equal(sx, rs), (
            f"the row pre-pass at {wname}, M {M}")
        err("w8a8_quant_rows", xq, rq)
        line += f" {M}"
        del lin, want, xq, sx, rq, rs
        timed = (wname == "gate_proj" and M in (16, 512)) or (
            wname in ("k_proj", "lm_head") and M == 16)
        if not timed:
            continue
        plan = qz.w8a8_plan(M, N, K, torch.cuda.get_device_properties(
            0).multi_processor_count)
        ms = graph_ms(lambda: qz.w8a8_linear(x, v, s))
        xz = torch.zeros(max(M, 17), K, dtype=torch.int8, device="cuda")
        ms_mm = graph_ms(lambda: torch._int_mm(xz, v.t()))
        del xz
        ms_bf = graph_ms(lambda: F.linear(x, w))
        # the int8 weight, x and y in bf16 and the scales, or the int8
        # product's operations
        e = wq_entry("w8a8_gemm", ms, None,
                     N * K + 2 * M * K + 2 * M * N + 4 * N,
                     "deepspeed_tpu/inference/quantization.py:180",
                     ops=2 * M * N * K, source="w8a8_gemm.cu")
        line += (f" [{plan.tn}-token tiles, {plan.blocks} blocks: "
                 f"{ms:.4f} ms (both launches), bound "
                 f"{e['bound_ms']:.4f} ({e['bound_by']}), "
                 f"{e['bound_ms'] / ms:.1%}; _int_mm alone {ms_mm:.4f} ms; "
                 f"bf16 F.linear {ms_bf:.4f} ms]")
        if wname == "gate_proj" and M == 16:     # a decode tick's shape
            e["plain_ms"] = time_ms(lambda: qz.w8a8_linear_reference(
                x, v, s), reps=3, warmup=1)
            entries["w8a8_gemm"] = e
        if wname == "gate_proj" and M == 512:    # a prefill chunk's rows
            ms_rows = graph_ms(lambda: qz.w8a8_quant_rows(x))
            plain = time_ms(lambda: qz.w8a8_quant_rows_reference(x),
                            reps=3, warmup=1)
            r = wq_entry("w8a8_quant_rows", ms_rows, plain,
                         3 * M * K + 4 * M,
                         "deepspeed_tpu/inference/quantization.py:194",
                         source="w8a8_gemm.cu")
            entries["w8a8_quant_rows"] = r
            line += (f" [the pre-pass alone {ms_rows:.4f} ms, bound "
                     f"{r['bound_ms']:.4f}, {r['bound_ms'] / ms_rows:.1%}]")
        del x
    return line


def phase_wq_v2(bf16_outs=None):
    """v2 on llama3-8b at full width and depth with fp8, fp6 and w8a8
    weights: phase 6's 24 requests, graphed and pipelined twice (the same
    tokens), w8a8 once more with the pipeline off (the same tokens); the
    counters of each format's kernels, #9 and #7 held exactly to the ticks
    and captures as in phase 14.  Returns the counters' launches."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = get_config("llama3-8b")
    L, K = cfg.num_hidden_layers, V2["decode_block_size"]
    reqs = v2_traffic()
    graph = {"config": {"enable_cuda_graph": True}}
    for fmt in WQ_FORMATS:
        counters = wq_counters(fmt, L, native=True) + [
            (rpa.ragged_paged_attention, L)]
        q_before = qz.quantize.launches
        t0 = time.perf_counter()
        with torch.device("meta"):
            model = LlamaForCausalLM(cfg)
        engine = RaggedInferenceEngineV2(
            model, generator=torch.Generator(device="cuda").manual_seed(SEED),
            device="cuda", quantize_weights=fmt, **V2)
        torch.cuda.synchronize()
        module = engine.module
        del engine
        weights = resident_bytes(module)
        log(f"{fmt} v2: llama3-8b engine up in {time.perf_counter() - t0:.3f}"
            f" s; resident weights {weights / 2**30:.3f} GiB; #6 launched "
            f"{qz.quantize.launches - q_before} times at build")
        torch.cuda.reset_peak_memory_stats()   # building held bf16 weights
        runs = [("pipeline on", dict(pipeline=True, **graph))] * 2
        if fmt == "w8a8":
            runs.append(("pipeline off", graph))
        outs = []
        for label, kw in runs:
            engine = RaggedInferenceEngineV2(module, device="cuda",
                                             **{**V2, **kw})
            before = [c.launches for c, _ in counters]
            out, r = serve(engine, reqs)
            st = engine.serving_stages()
            cap = st.get("graph_captures", 0)
            rep = st.get("graph_replays", 0)
            eager_ticks = engine.host_stats.ticks - K * rep
            device = {}
            for (c, per), b in zip(counters, before):
                got, want = c.launches - b, per * (eager_ticks + 2 * K * cap)
                assert got == want, (
                    f"{fmt} v2 {label}: {c.__name__} counted {got} "
                    f"launches, want {per} x ({eager_ticks} eager ticks + "
                    f"2 x {K} x {cap} captures)")
                device[c.__name__] = per * (eager_ticks + K * (cap + rep))
            rq = st["requests"]
            log(f"{fmt} v2 {label}: 24 requests in {r['wall_s']:.2f} s; "
                f"decode {r['decode_tps']:.1f} tokens/s in decode blocks "
                f"({r['block_tokens']} tokens, {r['block_s']:.2f} s, the "
                f"capture's {r['capture_s']:.3f} s apart); prefill "
                f"{r['prompt_tokens'] / r['fused_s']:.0f} prompt tokens/s; "
                f"TTFT p50 {rq['ttft_ms_p50']} ms p99 {rq['ttft_ms_p99']} "
                f"ms; host_bound_fraction in blocks {r['block_hbf']:.4f}; "
                f"captures {cap}, replays {rep}, eager ticks {eager_ticks}; "
                f"device launches derived from the replays: {device}")
            outs.append(out)
            del engine
            torch.cuda.empty_cache()
        for i, other in enumerate(outs[1:], 1):
            for a, b in zip(outs[0], other):
                assert np.array_equal(a, b), (
                    f"{fmt} v2: {runs[i][0]} run {i + 1}'s tokens differ "
                    "from the first run's")
        peak = torch.cuda.max_memory_allocated() / 2**30
        same = ("n/a" if bf16_outs is None else
                f"{sum(np.array_equal(a, b) for a, b in zip(outs[0], bf16_outs))}/24")
        log(f"{fmt} v2: identical tokens in all {len(outs)} runs"
            f"{' (pipeline on and off)' if fmt == 'w8a8' else ''}; {same} "
            f"requests equal to the bf16 run's; peak memory while serving "
            f"{peak:.2f} GiB")
        del module, model
        gc.collect()
        torch.cuda.empty_cache()


def phase_wq_v1():
    """v1 on llama3-8b at full width and depth, each format (groups of
    128), 4 x 1000 + 16 greedy twice: the same tokens, #1 once a layer a
    ``generate``, the format's kernels exactly per forward."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    cfg = get_config("llama3-8b")
    L = cfg.num_hidden_layers
    B, P, NEW = 4, 1000, 16
    prompts = torch.randint(0, cfg.vocab_size, (B, P),
                            generator=torch.Generator().manual_seed(SEED))
    for fmt in WQ_FORMATS:
        counters = wq_counters(fmt, L, native=False)
        t0 = time.perf_counter()
        with torch.device("meta"):
            model = LlamaForCausalLM(cfg)
        engine = deepspeed_tpu_torch.init_inference(
            model, config={"dtype": "bfloat16", "max_out_tokens": 2048,
                           "quant": {"enabled": True, "qtype": fmt}},
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
        up = time.perf_counter() - t0
        outs, secs = [], []
        for _ in range(2):
            before = [flash_fwd.launches] + [c.launches for c, _ in counters]
            t = time.perf_counter()
            out = engine.generate(prompts, max_new_tokens=NEW)
            secs.append(time.perf_counter() - t)
            got = [flash_fwd.launches - before[0]] + [
                c.launches - b for (c, _), b in zip(counters, before[1:])]
            want = [L] + [per * NEW for _, per in counters]
            assert got == want, (f"{fmt} v1 generate launched (flash, "
                                 f"format kernels) {got}, want {want}")
            assert out.shape == (B, P + NEW)
            outs.append(out)
        assert torch.equal(*outs), f"{fmt} v1 greedy runs differ"
        log(f"{fmt} v1: up in {up:.3f} s (resident weights "
            f"{resident_bytes(engine.module) / 2**30:.3f} GiB); generate "
            f"{B}x{P}+{NEW} {secs[0]:.3f} / {secs[1]:.3f} s, greedy tokens "
            f"identical twice; per generate flash {L}, "
            + ", ".join(f"{c.__name__} {per * NEW}" for c, per in counters))
        del engine, model, outs
        gc.collect()
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# The one-layer parity checks of phases 12 and 22, card against CPU
# ---------------------------------------------------------------------------
# Each runs one llama3-8b layer at full hidden and MLP width in fp32
# through v2 with quantized weights, on the card and on the CPU through
# the plain versions: the quantized buffers byte-identical, the greedy
# tokens equal by phase 7's margin rule.  On the CPU every tick
# dequantizes every weight, both tables included, which takes minutes at
# llama3-8b's vocabulary; so a worker process (``--cpu-side``, no card
# visible, CPU_SIDE_THREADS of the host's cores) computes the CPU halves
# while the card runs the phases after phase 12, and the checks compare
# once both halves are in.  Its files go to build/smoke_cpu, removed
# afterwards.
CPU_SIDE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "build", "smoke_cpu")
CPU_SIDE_THREADS = 4
CPU_SIDE_WAIT_S = 900
CPU_SIDES = []          # the workers started, stopped when the run ends
PARITY_JOBS = ("int8",) + WQ_FORMATS


def parity_job(name):
    """(config, flax tree seed, prompts, v2 kwargs, new tokens) of the
    parity check of weight format ``name``: phase 12's int8 at the full
    vocabulary, 4 requests; phase 22's fp8, fp6 and w8a8 at a vocabulary
    of 8192 (the CPU's plain fp6 decode of the full tables each tick
    would take many minutes; phase 22's kernel checks hold the full
    ``lm_head`` bit-identical), 2 requests."""
    from deepspeed_tpu_torch.models.llama import get_config

    if name not in PARITY_JOBS:
        raise ValueError(f"no parity check {name!r}: {PARITY_JOBS}")
    if name == "int8":
        cfg = get_config("llama3-8b", num_hidden_layers=1,
                         dtype=torch.float32)
        rng = np.random.default_rng(SEED + 1)
        sizes, seed, new = (37, 100, 300, 513), SEED + 4, 16
        kw = dict(max_seqs=4, max_seq_len=640, prefill_chunk=128,
                  page_size=64, decode_block_size=4)
    else:
        cfg = get_config("llama3-8b", num_hidden_layers=1, vocab_size=8192,
                         dtype=torch.float32)
        rng = np.random.default_rng(SEED + 23)
        sizes, seed, new = (37, 100), SEED + 22, 4
        # both prompts in one prefill tick, then one decode block
        kw = dict(max_seqs=2, max_seq_len=256, prefill_chunk=256,
                  page_size=64, decode_block_size=4)
    prompts = [rng.integers(0, cfg.vocab_size, size=n) for n in sizes]
    return cfg, seed, prompts, kw, new


def parity_half(name, device):
    """One side of parity check ``name``: v2 on ``device`` with weight
    format ``name``.  Returns the greedy tokens, the sha256 of each
    buffer's bytes, their byte count and the module."""
    import hashlib

    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM
    from deepspeed_tpu_torch.module_inject.flax_bridge import \
        flax_to_state_dict

    cfg, seed, prompts, kw, new = parity_job(name)
    state = flax_to_state_dict(flax_tree(cfg, np.random.default_rng(seed)))
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    eng = RaggedInferenceEngineV2(model, params=state, device=device,
                                  quantize_weights=name, **kw)
    del state
    outs = eng.generate_all(prompts, max_new_tokens=new)
    eng.audit_kv_sharing()
    digests, nbytes = {}, 0
    for bname, b in eng.module.named_buffers():
        raw = b.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
        digests[bname] = hashlib.sha256(raw.numpy()).hexdigest()
        nbytes += raw.numel()
    return dict(tokens=[torch.from_numpy(outs[u]) for u in sorted(outs)],
                digests=digests, nbytes=nbytes, module=eng.module)


def cpu_side_worker(names) -> int:
    """``--cpu-side``: the CPU halves of parity checks ``names``, each with
    the CPU's logits over its own tokens from the last prompt position
    on, saved to CPU_SIDE_DIR/<name>.pt as it completes."""
    torch.set_num_threads(CPU_SIDE_THREADS)
    for name in names:
        t = time.perf_counter()
        half = parity_half(name, "cpu")
        prompts = parity_job(name)[2]
        with torch.no_grad():
            half["logits"] = [
                half["module"](toks[None, :-1].long())[0][len(p) - 1:]
                for p, toks in zip(prompts, half["tokens"])]
        del half["module"]
        half["seconds"] = time.perf_counter() - t
        tmp = os.path.join(CPU_SIDE_DIR, f"{name}.tmp")
        torch.save(half, tmp)
        os.replace(tmp, os.path.join(CPU_SIDE_DIR, f"{name}.pt"))
        log(f"cpu side: {name} in {half['seconds']:.1f} s")
        gc.collect()
    return 0


class CPUSide:
    """The worker process of the parity checks' CPU halves: started with
    the jobs it runs, stopped (and its files removed) by :meth:`close`."""

    def __init__(self, names):
        import shutil

        shutil.rmtree(CPU_SIDE_DIR, ignore_errors=True)
        os.makedirs(CPU_SIDE_DIR)
        self.log_path = os.path.join(CPU_SIDE_DIR, "worker.log")
        env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
                   OMP_NUM_THREADS=str(CPU_SIDE_THREADS))
        here = os.path.dirname(os.path.abspath(__file__))
        with open(self.log_path, "w") as out:
            self.proc = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--cpu-side",
                 ",".join(names)], stdout=out, stderr=subprocess.STDOUT,
                env=env, cwd=here)
        CPU_SIDES.append(self)

    def result(self, name):
        """The CPU half of ``name`` and the seconds this call waited for
        it; raises if the worker died or took over CPU_SIDE_WAIT_S."""
        path = os.path.join(CPU_SIDE_DIR, f"{name}.pt")
        t = time.perf_counter()
        while not os.path.exists(path):
            if self.proc.poll() is not None and not os.path.exists(path):
                with open(self.log_path) as f:
                    tail = f.read()[-4000:]
                raise RuntimeError(f"the CPU-side worker exited with code "
                                   f"{self.proc.returncode} before {name}:"
                                   f"\n{tail}")
            assert time.perf_counter() - t < CPU_SIDE_WAIT_S, (
                f"the CPU half of {name} took over {CPU_SIDE_WAIT_S} s")
            time.sleep(0.5)
        return torch.load(path), time.perf_counter() - t

    def close(self):
        import shutil

        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        shutil.rmtree(CPU_SIDE_DIR, ignore_errors=True)


def w8a8_layers_bit_equal(module, ids):
    """Every W8A8 Linear of ``module`` (on the card) over ``ids``: its
    output bit-identical to the plain version's on the CPU over the same
    input activations and buffers.  Tells a rounding flip (inputs one ulp
    apart upstream) from a fault in the W8A8 path.  Returns the card's
    logits and the number of layers held."""
    from deepspeed_tpu_torch.inference.quantization import W8A8Linear
    from deepspeed_tpu_torch.ops import quantization as qz

    seen = []

    def hook(mod, args, out):
        seen.append((mod, args[0].detach(), out.detach()))

    handles = [m.register_forward_hook(hook) for m in module.modules()
               if isinstance(m, W8A8Linear)]
    try:
        with torch.no_grad():
            logits = module(ids.cuda())[0].cpu()
    finally:
        for h in handles:
            h.remove()
    for mod, x, y in seen:
        want = qz.w8a8_linear(x.cpu(), mod.values.cpu(), mod.scale.cpu())
        if mod.bias is not None:
            want = want + mod.bias.cpu()
        assert bits_equal(y.cpu(), want), (
            f"a W8A8 Linear {tuple(mod.values.shape)} on the card differs "
            "from its plain version on the same inputs")
    return logits, len(seen)


def parity_compare(name, card, cpu_side):
    """Parity check ``name``: the card's half against the worker's.  The
    buffers byte-identical; a token may differ only where the CPU's top-2
    margin is under MARGIN (phase 7).  w8a8 runs natively, a function that
    is not continuous in its activations, so there a token may also
    differ at or after a rounding flip: the first position where the two
    devices' logits over the CPU's tokens differ beyond LOGITS_ATOL.  On
    w8a8 every W8A8 Linear is also held bit-identical to its plain
    version on the card's own inputs, and at least one request must show
    no flip at all (a wrong W8A8 path differs from the first token)."""
    cpu, waited = cpu_side.result(name)
    prompts = parity_job(name)[2]
    assert card["digests"].keys() == cpu["digests"].keys() and card["digests"]
    for bname, d in card["digests"].items():
        assert d == cpu["digests"][bname], (
            f"{name}: {bname} quantized on the card differs from the CPU's")
    worst, clean, held, notes = math.inf, 0, 0, []
    for p, got, want, lc in zip(prompts, card["tokens"], cpu["tokens"],
                                cpu["logits"]):
        got, want = got.numpy(), want.numpy()
        top2 = lc.topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).numpy()
        worst = min(worst, float(margins.min()))
        flips = np.zeros(0, dtype=np.int64)
        if name == "w8a8":
            lg, n = w8a8_layers_bit_equal(
                card["module"], torch.from_numpy(want[None, :-1]).long())
            held += n
            flips = np.nonzero(((lg[len(p) - 1:] - lc).abs().amax(-1) >
                                LOGITS_ATOL).numpy())[0]
            clean += flips.size == 0
        diff = np.nonzero(got != want)[0]
        if not diff.size:
            continue
        i = int(diff[0]) - len(p)
        flip = flips.size > 0 and flips[0] <= i
        notes.append(f"prompt {len(p)}: first differing token {i}, CPU "
                     f"margin {margins[i]:.3e}" +
                     (f", a rounding flip at {flips[0]}" if flip else ""))
        assert margins[i] < MARGIN or flip, (
            f"{name}: card and CPU tokens differ at {i} with margin "
            f"{margins[i]:.3e} and no rounding flip before it")
    if name == "w8a8":
        assert clean >= 1, (
            "w8a8: every request's card logits left the CPU's beyond "
            f"{LOGITS_ATOL}: the comparison saw no unflipped request")
    same = sum(np.array_equal(a.numpy(), b.numpy())
               for a, b in zip(card["tokens"], cpu["tokens"]))
    cfg = parity_job(name)[0]
    log(f"parity, 1 layer fp32, vocabulary {cfg.vocab_size}, {name} "
        f"weights: {len(card['digests'])} buffers ({cpu['nbytes']} bytes) "
        f"byte-identical card vs CPU; {same}/{len(prompts)} requests "
        f"token-equal; smallest CPU top-2 margin {worst:.3e}"
        + (f"; {held} W8A8 Linear calls bit-identical to plain on the "
           f"card's inputs, {clean}/{len(prompts)} requests with no "
           "rounding flip" if name == "w8a8" else "")
        + ("; " + "; ".join(notes) if notes else "")
        + f" (CPU half {cpu['seconds']:.1f} s in the worker; waited "
          f"{waited:.1f} s for it)")


def phase_wq_cpu_parity(cpu_side, card_halves):
    """Phase 22's card halves of the fp8, fp6 and w8a8 parity checks, then
    every parity check in ``card_halves`` (phase 12's too) against the
    worker's CPU halves."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for fmt in WQ_FORMATS:
        card_halves[fmt] = parity_half(fmt, "cuda")
        if fmt != "w8a8":       # only the flip rule runs the card's module
            card_halves[fmt]["module"] = None
        gc.collect()
    for name in PARITY_JOBS:
        if name in card_halves:
            parity_compare(name, card_halves.pop(name), cpu_side)
    gc.collect()
    torch.cuda.empty_cache()


def phase_wq(cpu_side, card_halves, bf16_outs=None):
    """Phase 22: the kernels, then v2, v1 and the fp32 layer against the
    CPU (with phase 12's parity check, whose card half is in
    ``card_halves``).  Returns the kernel-line entries with the counters'
    launches over v2's and v1's main-path runs.  ``bf16_outs``: phase 6's
    tokens, for an informational count of equal requests."""
    from deepspeed_tpu_torch.ops import quantization as qz

    gc.collect()            # what earlier phases left for the collector
    torch.cuda.empty_cache()
    entries = phase_wq_kernels()
    counters = (qz.dequant_scaled, qz.dequantize_fp6, qz.w8a8_quant_rows,
                qz.w8a8_gemm)
    for c in counters:                  # the main path starts here
        c.launches = 0
    phase_wq_v2(bf16_outs)
    # v2 quantizes fp6 in groups of 2048, v1 in groups of 128: K2's two
    # entries take the launches of their own engine's runs
    entries["dequant_fp6_g2048"]["launches"] = qz.dequantize_fp6.launches
    phase_wq_v1()
    entries["dequant_fp6_g128"]["launches"] = (
        qz.dequantize_fp6.launches -
        entries["dequant_fp6_g2048"]["launches"])
    for name, c in (("dequant_scaled", qz.dequant_scaled),
                    ("w8a8_quant_rows", qz.w8a8_quant_rows),
                    ("w8a8_gemm", qz.w8a8_gemm)):
        entries[name]["launches"] = c.launches
        assert c.launches > 0, f"the main path never launched {name}"
    log("phase 22 launches over v2's and v1's runs: "
        f"{ {c.__name__: c.launches for c in counters} } (K2: groups of "
        f"2048 in v2 {entries['dequant_fp6_g2048']['launches']}, groups of "
        f"128 in v1 {entries['dequant_fp6_g128']['launches']})")
    phase_wq_cpu_parity(cpu_side, card_halves)
    return list(entries.values())


# ---------------------------------------------------------------------------
# Phase 23: disaggregated serving on v2 behind the router (A9.7, A10a)
# ---------------------------------------------------------------------------

DISAGG_SHORT, DISAGG_LONG, DISAGG_NEW = 32, 1024, 64
# graphed and pipelined, V2's shapes; the replicas' tiers hold every long
# session of a leg (8 x 17 pages) with room to spare
DISAGG = dict(V2, pipeline=True, config={"enable_cuda_graph": True})
DISAGG_TIER = {"host_pages": 192}


def disagg_traffic(vocab, seed):
    """8 short (32-token) and 8 long (1024-token) greedy prompts,
    alternating, each + 64 new tokens."""
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=DISAGG_LONG if i % 2 else
                          DISAGG_SHORT), DISAGG_NEW) for i in range(16)]


def drive_engine(engine, reqs):
    """One engine over ``reqs`` from the caller's loop: outputs in order,
    each request's submit -> first harvested token seconds, and the
    decode rate (tokens after each first, over first token to last
    finish; and each request's own, its tokens after the first over its
    first token to its finish, p50)."""
    t0 = time.perf_counter()
    uids = [engine.put_request(p, max_new_tokens=n) for p, n in reqs]
    first, done, outs = {}, {}, {}
    while engine.has_work():
        engine.step()
        now = time.perf_counter() - t0
        for uid, toks, _, _ in engine.stream_deltas():
            if toks:
                first.setdefault(uid, now)
        for uid, toks in engine.get_outputs():
            outs[uid], done[uid] = toks, now
    return disagg_result(reqs, [outs[u] for u in uids],
                         [first[u] for u in uids], [done[u] for u in uids])


def drive_router(router, reqs):
    """:func:`drive_engine` through a router: first tokens and finishes
    from its event stream, each request finishing exactly once."""
    router.collect_events = True
    t0 = time.perf_counter()
    rids = [router.submit(p, max_new_tokens=n) for p, n in reqs]
    first, done, outs = {}, {}, {}
    while router.outstanding or router.queued:
        router.pump()
        router.join()
        now = time.perf_counter() - t0
        for kind, rid, payload in router.poll_events():
            assert kind in ("tokens", "finish"), (
                f"disagg: router event {kind} for request {rid}")
            first.setdefault(rid, now)
            if kind == "finish":
                assert rid not in outs, f"disagg: {rid} finished twice"
                outs[rid], done[rid] = np.asarray(payload), now
    router.collect_events = False
    router.get_outputs()            # the finishes came as events
    return disagg_result(reqs, [outs[r] for r in rids],
                         [first[r] for r in rids], [done[r] for r in rids])


def disagg_result(reqs, outs, first, done):
    for (p, n), got in zip(reqs, outs):
        assert got.shape == (len(p) + n,) and np.array_equal(got[:len(p)], p)
    gen = sum(n - 1 for _, n in reqs)
    ms = np.asarray(first) * 1e3
    short = [m for m, (p, _) in zip(ms, reqs) if len(p) == DISAGG_SHORT]
    long_ = [m for m, (p, _) in zip(ms, reqs) if len(p) == DISAGG_LONG]
    own = [(n - 1) / max(d - f, 1e-9) for (_, n), f, d in
           zip(reqs, first, done)]
    return outs, dict(
        ttft_short=(np.percentile(short, 50), np.percentile(short, 99)),
        ttft_long=(np.percentile(long_, 50), np.percentile(long_, 99)),
        decode_tps=gen / max(max(done) - min(first), 1e-9),
        decode_tps_req=np.percentile(own, 50))


def leg_counts(engines):
    """Per engine: (model ticks, graph replays, graph captures)."""
    return [(e.host_stats.ticks, e.host_stats.graph_replays,
             e.host_stats.graph_captures) for e in engines]


def check_leg(label, engines, before, launched, L):
    """#9's Python count over a leg against every engine's ticks, captures
    and replays as in phase 14 (an eager tick launches L, a capture its
    warm-up and captured block, 2 x K x L; a replay none in Python);
    every pool all free and audited.  Returns each engine's device
    launches, derived from its replays."""
    K = DISAGG["decode_block_size"]
    python, device = 0, []
    for e, (t0, r0, c0), (t1, r1, c1) in zip(engines, before,
                                             leg_counts(engines)):
        eager = (t1 - t0) - K * (r1 - r0)
        python += L * (eager + 2 * K * (c1 - c0))
        device.append(L * (eager + K * ((c1 - c0) + (r1 - r0))))
        e.audit_kv_sharing()
        assert e.allocator.free_pages == e.num_pages - 1, (
            f"disagg {label}: pages left in use")
    assert launched == python, (
        f"disagg {label}: ragged_paged_attention counted {launched} "
        f"launches, want {python} from the replicas' ticks and captures")
    return device


def check_replicas(label, router, rs):
    """No replica died, was re-routed from or left ``healthy``: the
    router catches a replica's exception (a CUDA fault, a failed
    capture) and re-sends its greedy requests to a survivor, so a leg's
    tokens alone would not show it."""
    s = router.stats()
    bad = {k: s[k] for k in ("replica_deaths", "rerouted",
                             "failed_replica_death", "hedges") if s[k]}
    bad.update({h.name: s[f"state_{h.name}"] for h in rs.handles
                if not h.alive or s[f"state_{h.name}"] != "healthy"})
    assert not bad, f"disagg {label}: a replica failed: {bad}"


def phase_disagg():
    """Phase 23: disaggregated serving (A9.7 + A10a) on ``llama3-8b`` at
    full width and depth, bf16, CUDA graphs and the pipeline on, a pinned
    host tier.  One module serves a fused control engine and a prefill
    and a decode replica behind the port's ``Router`` (``set_roles``):
    16 greedy requests (8 x 32 and 8 x 1024 tokens, + 64 each), cold
    and again warm; a leg with one ``handoff.import`` bitflip; 8
    requests with the roles off, both replicas decoding from their
    threads; 4 requests over SSE through ``FrontDoorServer`` on
    ``127.0.0.1:0``.  Then 2 layers at full width in fp32, the 1P1D
    router against the fused control by phase 7's margin rule.  Returns
    #9's launches over the router legs."""
    import asyncio

    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.resilience import faults
    from deepspeed_tpu_torch.serving import (FrontDoorServer, ReplicaSet,
                                             Router)
    from deepspeed_tpu_torch.serving.client import sse_generate

    t_phase = time.perf_counter()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_config("llama3-8b")
    L = cfg.num_hidden_layers
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    module = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2).module
    torch.cuda.reset_peak_memory_stats()
    reqs = disagg_traffic(cfg.vocab_size, SEED + 23)
    n_long = sum(len(p) == DISAGG_LONG for p, _ in reqs)
    control = RaggedInferenceEngineV2(module, device="cuda", **DISAGG)
    want, rc = drive_engine(control, reqs)
    # again with its graph captured: the warm legs compare steady states
    caps = control.host_stats.graph_captures
    want_w, rcw = drive_engine(control, reqs)
    assert control.host_stats.graph_captures == caps
    control.audit_kv_sharing()
    del control
    # the replicas share the module: weights on the card once, a pool
    # and a tier store each
    rs = ReplicaSet(lambda i: RaggedInferenceEngineV2(
        module, device="cuda", kv_tiering=DISAGG_TIER, **DISAGG), 2)
    router = Router(rs, policy="least_tokens")
    router.set_roles({"r0": "prefill", "r1": "decode"})
    pre, dec = (h.engine for h in rs.handles)
    engines = (pre, dec)
    try:
        # -- the clean leg: every long request hands its KV off
        rpa.ragged_paged_attention.launches = 0     # the main path
        before = leg_counts(engines)
        restore_s = dec.host_stats.seconds["restore"]
        busy0 = [dict(e.host_stats.seconds) for e in engines]
        got, rr = drive_router(router, reqs)
        # each replica's host-clock seconds by stage over the leg: what
        # one replica's step holds up the router's round with
        busy = [{k: round(v - b[k], 3)
                 for k, v in e.host_stats.seconds.items() if v - b[k] > 0.001}
                for e, b in zip(engines, busy0)]
        dev = check_leg("clean", engines, before,
                        rpa.ragged_paged_attention.launches, L)
        check_replicas("clean", router, rs)
        stats = router.stats()
        assert pre.handoffs == stats["handoffs"] == stats[
            "handoff_kv"] == n_long, stats
        assert pre.handoff_folds == 0 and stats["handoff_reprefill"] == 0
        ts = dec.tiering.stats()
        assert dec.restores == dec.tiering.counters["imports"] == n_long
        assert ts["pages_verified"] == ts["pages_restored"] > 0, ts
        assert ts["quarantined"] == 0
        assert dec.host_stats.graph_replays > 0 and dev[1] > 0
        assert dev[0] > 0, "the prefill replica never launched #9"
        stalls = [r["handoff_stall_ms"] for r in
                  dec.request_latency.completed() if r["handoffs"]]
        assert len(stalls) == n_long
        per_page = ((dec.host_stats.seconds["restore"] - restore_s) * 1e3
                    / ts["pages_restored"])
        same = sum(np.array_equal(a, b) for a, b in zip(got, want))
        log(f"[{smi}] disagg 1P1D: 16 requests (8 x {DISAGG_SHORT} + 8 x "
            f"{DISAGG_LONG}, + {DISAGG_NEW}); handoffs {pre.handoffs} (KV "
            f"{stats['handoff_kv']}, folds {pre.handoff_folds}), restores "
            f"{dec.restores}, pages {ts['pages_restored']} every one "
            f"digest-verified ({ts['pages_verified']}); TTFT short p50 "
            f"{rr['ttft_short'][0]:.1f} p99 {rr['ttft_short'][1]:.1f} ms, "
            f"long p50 {rr['ttft_long'][0]:.1f} p99 {rr['ttft_long'][1]:.1f}"
            f" ms (fused control: short {rc['ttft_short'][0]:.1f} / "
            f"{rc['ttft_short'][1]:.1f}, long {rc['ttft_long'][0]:.1f} / "
            f"{rc['ttft_long'][1]:.1f}); handoff_stall_ms p50 "
            f"{np.percentile(stalls, 50):.2f} p99 "
            f"{np.percentile(stalls, 99):.2f}; restore {per_page:.3f} ms a "
            f"page; decode {rr['decode_tps']:.1f} tokens/s against the "
            f"control's {rc['decode_tps']:.1f} (a request's own, p50: "
            f"{rr['decode_tps_req']:.1f} against {rc['decode_tps_req']:.1f});"
            f" #9 launches {dev} by "
            f"replica (device, from the replays), graph replays "
            f"{[e.host_stats.graph_replays for e in engines]}; host "
            f"seconds by stage (prefill, decode) {busy}, capture "
            f"{[round(e.host_stats.graph_capture_s, 3) for e in engines]} s")
        log(f"[{smi}] disagg 1P1D bf16: {same}/16 outputs equal to the "
            f"fused control's (reported, not gated: other batches, other "
            f"GEMM shapes); first divergence (request, token) "
            f"{first_divergence(got, want)}")
        launched = rpa.ragged_paged_attention.launches
        # -- the same traffic again, every graph it needs captured: the
        # steady state beside the control's warm run
        before = leg_counts(engines)
        h0, k0, f0 = pre.handoffs, stats["handoff_kv"], pre.handoff_folds
        pages0 = ts["pages_restored"]
        restore_s = dec.host_stats.seconds["restore"]
        n_done = len(dec.request_latency.completed())
        got_w, rw = drive_router(router, reqs)
        launched0 = rpa.ragged_paged_attention.launches
        dev_w = check_leg("warm", engines, before, launched0 - launched, L)
        launched = launched0
        check_replicas("warm", router, rs)
        stats = router.stats()
        assert pre.handoffs - h0 == stats["handoff_kv"] - k0 == n_long
        assert pre.handoff_folds == f0 and stats["handoff_reprefill"] == 0
        assert [c for _, _, c in before] == [
            c for _, _, c in leg_counts(engines)], "disagg warm: a capture"
        ts = dec.tiering.stats()
        assert ts["pages_verified"] == ts["pages_restored"] > pages0
        assert ts["quarantined"] == 0
        stalls_w = [r["handoff_stall_ms"] for r in
                    dec.request_latency.completed()[n_done:] if r["handoffs"]]
        assert len(stalls_w) == n_long
        per_page_w = ((dec.host_stats.seconds["restore"] - restore_s) * 1e3
                      / (ts["pages_restored"] - pages0))
        log(f"[{smi}] disagg 1P1D warm (no capture in the leg): TTFT short "
            f"p50 {rw['ttft_short'][0]:.1f} p99 {rw['ttft_short'][1]:.1f} "
            f"ms, long p50 {rw['ttft_long'][0]:.1f} p99 "
            f"{rw['ttft_long'][1]:.1f} ms (fused control warm: short "
            f"{rcw['ttft_short'][0]:.1f} / {rcw['ttft_short'][1]:.1f}, long "
            f"{rcw['ttft_long'][0]:.1f} / {rcw['ttft_long'][1]:.1f}); "
            f"handoff_stall_ms p50 {np.percentile(stalls_w, 50):.2f} p99 "
            f"{np.percentile(stalls_w, 99):.2f}; restore {per_page_w:.3f} ms "
            f"a page; decode {rw['decode_tps']:.1f} tokens/s against the "
            f"control's warm {rcw['decode_tps']:.1f} (a request's own, p50: "
            f"{rw['decode_tps_req']:.1f} against {rcw['decode_tps_req']:.1f})"
            f"; #9 launches {dev_w} by "
            f"replica (device); outputs equal to the cold leg's "
            f"{sum(np.array_equal(a, b) for a, b in zip(got_w, got))}/16, "
            f"the control's warm to its cold "
            f"{sum(np.array_equal(a, b) for a, b in zip(want_w, want))}/16")
        # -- one handoff.import bitflip: quarantined, re-prefilled
        before = leg_counts(engines)
        q0 = dec.tiering.counters["quarantined"]
        e0 = sum(r["errors"] for r in dec.request_latency.completed())
        with faults.FaultInjector(seed=SEED + 23) as inj:
            inj.bitflip("handoff.import", bits=1, count=1)
            bad, _ = drive_router(router, reqs)
        launched0 = rpa.ragged_paged_attention.launches
        check_leg("bitflip", engines, before, launched0 - launched, L)
        launched = launched0
        check_replicas("bitflip", router, rs)
        assert [s for s, _, _ in inj.fired] == ["handoff.import"]
        assert dec.tiering.counters["quarantined"] - q0 == 1
        errs = sum(r["errors"] for r in dec.request_latency.completed()) - e0
        assert errs == 1, f"disagg bitflip: {errs} sessions re-prefilled"
        log(f"[{smi}] disagg bitflip leg: 1 wire flip at handoff.import, "
            f"1 session quarantined and re-prefilled; "
            f"{sum(np.array_equal(a, b) for a, b in zip(bad, got))}/16 "
            "outputs equal to the clean leg's")
        # -- roles off: both replicas decode, capturing and replaying from
        # their own threads at once
        router.set_roles({})
        before = leg_counts(engines)
        mixed = reqs[:8]
        drive_router(router, mixed)
        launched0 = rpa.ragged_paged_attention.launches
        dev = check_leg("fused", engines, before, launched0 - launched, L)
        launched = launched0
        check_replicas("roles off", router, rs)
        assert all(e.host_stats.graph_replays > 0 for e in engines)
        assert all(e.host_stats.graph_captures > 0 for e in engines)
        log(f"[{smi}] disagg roles off: 8 requests over both replicas; "
            f"captures {[e.host_stats.graph_captures for e in engines]}, "
            f"replays {[e.host_stats.graph_replays for e in engines]}, "
            f"#9 launches {dev} by replica (device)")
        # -- SSE through the front door, 1P1D again; the tokens streamed
        # are the engines' get_outputs for those requests
        router.set_roles({"r0": "prefill", "r1": "decode"})
        collected = {}
        for e in engines:
            get = e.get_outputs

            def recording(get=get):
                out = get()
                for _, toks in out:
                    collected[tuple(toks[:DISAGG_SHORT])] = toks
                return out
            e.get_outputs = recording
        before = leg_counts(engines)
        srv = FrontDoorServer(router, port=0).start()
        try:
            async def clients():
                return await asyncio.gather(*[sse_generate(
                    srv.host, srv.port,
                    {"prompt": p.tolist(), "max_new_tokens": n})
                    for p, n in reqs[:4]])
            res = asyncio.run(clients())
        finally:
            srv.close()
        for e in engines:
            del e.get_outputs
        launched0 = rpa.ragged_paged_attention.launches
        check_leg("sse", engines, before, launched0 - launched, L)
        launched = launched0
        check_replicas("sse", router, rs)
        for (p, n), r in zip(reqs[:4], res):
            assert r["status"] == 200 and r["error"] is None, r
            eng_out = collected[tuple(p[:DISAGG_SHORT])]
            assert np.array_equal(np.asarray(r["final"]), eng_out)
            assert r["tokens"] == eng_out[len(p):].tolist()
        log(f"[{smi}] disagg SSE: 4 streams over 127.0.0.1:{srv.port}, "
            f"tokens equal to the engines' get_outputs; TTFT at the socket "
            f"{[round(r['ttft_s'] * 1e3, 1) for r in res]} ms")
    finally:
        rs.close()
    peak = torch.cuda.max_memory_allocated() / 2**30
    del pre, dec, engines, rs, router, module, model
    gc.collect()
    torch.cuda.empty_cache()
    disagg_fp32(smi)
    log(f"[{smi}] phase 23: peak {peak:.2f} GiB (weights once, three "
        f"pools); #9 launches over the router legs {launched}; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return launched


def disagg_fp32(smi):
    """2 layers at full width in fp32 (TF32 off), random weights on the
    card: 8 of the phase's requests through the 1P1D router against the
    fused control, by phase 7's margin rule."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.serving import ReplicaSet, Router

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3-8b", num_hidden_layers=2, dtype=torch.float32)
    reqs = disagg_traffic(cfg.vocab_size, SEED + 230)[:8]
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    control = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED + 23),
        device="cuda", **DISAGG)
    want, _ = drive_engine(control, reqs)
    module = control.module
    del control
    rs = ReplicaSet(lambda i: RaggedInferenceEngineV2(
        module, device="cuda", kv_tiering=DISAGG_TIER, **DISAGG), 2)
    try:
        router = Router(rs, policy="least_tokens")
        router.set_roles({"r0": "prefill", "r1": "decode"})
        got, _ = drive_router(router, reqs)
        check_replicas("fp32", router, rs)
        pre, dec = (h.engine for h in rs.handles)
        assert pre.handoffs == 4 and pre.handoff_folds == 0
        ts = dec.tiering.stats()
        assert ts["pages_verified"] == ts["pages_restored"] > 0
        for e in (pre, dec):
            e.audit_kv_sharing()
            assert e.allocator.free_pages == e.num_pages - 1
    finally:
        rs.close()
    smallest = math.inf
    for (p, _), g, w in zip(reqs, got, want):
        with torch.no_grad():
            logits = module(torch.from_numpy(w[None, :-1]).cuda())[0]
        top2 = logits[len(p) - 1:].topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        smallest = min(smallest, float(margins.min()))
        diff = np.nonzero(g != w)[0]
        if diff.size:
            i = int(diff[0]) - len(p)
            log(f"[{smi}] disagg fp32: prompt {len(p)}: first differing "
                f"token {i}, control top-2 margin {margins[i]:.3e}")
            assert margins[i] < MARGIN, (
                f"disagg fp32: tokens differ from the fused control at {i} "
                f"with margin {margins[i]:.3e}")
        del logits
    same = sum(np.array_equal(a, b) for a, b in zip(got, want))
    log(f"[{smi}] disagg fp32, 2 layers: {same}/8 requests token-equal to "
        f"the fused control (4 handed off); smallest control top-2 margin "
        f"{smallest:.3e}")
    del module, model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 24: sparse-MoE serving (Qwen2-MoE, Mixtral) through v1 and v2
# ---------------------------------------------------------------------------

# group 1 at D 128 (qwen1.5-moe-a2.7b's 16 heads over 16): the decode
# block's 16 rows and a tick's 512-token chunk beside 8 decode rows
MOE_PAGED = {"decode": ([1] * 16, [128 * (j + 1) for j in range(16)]),
             "mixed": ([1] * 8 + [512], [128 + 256 * j for j in range(8)] +
                       [1500])}


def moe_paged_kernels(smi):
    """#9 and #8 at the MoE preset's group-1 shape against their plain
    versions (phase 5's limits), bf16, int8 and e4m3 pages; each timed at
    decode beside its bound and its plain version, and at mixed.  Returns
    the kernel-line entries of #9 (bf16 pages) and #8 (int8 pages)."""
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    entries, worst = {}, {}
    for i, (name, (q_lens, kv_lens)) in enumerate(MOE_PAGED.items()):
        for pd in (torch.bfloat16, torch.int8, torch.float8_e4m3fn):
            q, pages, scales, meta = paged_case(SEED + 240 + i, q_lens,
                                                kv_lens, H=16, Hkv=16,
                                                pdtype=pd)
            sm = q.shape[-1] ** -0.5
            quant = scales is not None
            fn = rpa.ragged_paged_attention_quant if quant \
                else rpa.ragged_paged_attention
            ref = (rpa.ref_paged_attention_quant if quant
                   else rpa.ref_paged_attention)
            args = (q, pages, scales, *meta) if quant else (q, pages, *meta)
            out = fn(*args, sm_scale=sm)
            want = ref(*args, sm_scale=sm)
            torch.cuda.synchronize()
            of, wf = out.float(), want.float()
            err = (of - wf).abs()
            limit = PAGED_ATOL + PAGED_RTOL * wf.abs()
            assert torch.isfinite(of).all() and (err <= limit).all(), (
                f"moe paged {name} {pd}: differs from plain by up to "
                f"{err.max().item():.3e}")
            S, pp = meta[1].shape
            splits = rpa.split_plan(q.shape[0], S, 16, 16, pp, 64)[0]
            ms = graph_ms(lambda: fn(*args, sm_scale=sm))
            bound, by = paged_bound(q_lens, kv_lens, meta[1].cpu(), 16, 16,
                                    128, 64, q.dtype, pd)
            line = (f"[{smi}] moe paged {name} H16/Hkv16 D128 pages "
                    f"{str(pd)[6:]}: max|o-plain| {err.max().item():.3e} "
                    f"({(err / limit).max().item():.1%} of the limit), "
                    f"splits {splits}, kernel {ms:.4f} ms, bound "
                    f"{bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
            kname = ("ragged_paged_attn_quant" if quant
                     else "ragged_paged_attn") + "_moe_g1"
            worst[kname] = max(worst.get(kname, 0.0), err.max().item())
            if name == "decode" and pd in (torch.bfloat16, torch.int8):
                plain_ms = time_ms(lambda: ref(*args, sm_scale=sm), reps=3,
                                   warmup=1)
                line += f", plain {plain_ms:.3f} ms"
                entries[kname] = dict(
                    name=kname, route="cuda",
                    source="deepspeed_tpu_torch/ops/csrc/"
                           "ragged_paged_attn.cu",
                    replaces=("deepspeed_tpu/ops/ragged_paged_quant.py:51"
                              if quant else
                              "deepspeed_tpu/inference/paged.py:602"),
                    launches=0, max_abs_err=0.0, ms=ms, plain_ms=plain_ms,
                    bound_ms=bound, bound_by=by, library_ms=None)
            log(line)
            del q, pages, scales, meta, out, want
    for kname, e in entries.items():
        e["max_abs_err"] = worst[kname]
    torch.cuda.empty_cache()
    return entries


def watch_drops(module):
    """Log (rows routed, copies dropped for capacity) of every MoE layer
    call, read from its gating result; the drop counts stay on the card
    until read.  Returns the log and the function that stops it."""
    from deepspeed_tpu_torch.moe.layer import MoE

    calls, layers = [], [m for m in module.modules() if isinstance(m, MoE)]
    for mod in layers:
        def gating(x, *a, _inner=mod.gating, **kw):
            gr = _inner(x, *a, **kw)
            calls.append((x.shape[0], (gr.weights == 0).sum()))
            return gr
        mod.gating = gating

    def stop():
        for mod in layers:
            del mod.gating
    return calls, stop


def drops_per_call(calls, rows):
    """Routed copies dropped for capacity per layer call, over the calls
    of ``rows`` rows, and the number of such calls."""
    got = [int(d) for g, d in calls if g == rows]
    return sum(got) / max(len(got), 1), len(got)


def phase_moe():
    """Phase 24: sparse MoE through both engines.  ``qwen1.5-moe-a2.7b``
    at full size, bf16, random seeded weights made on the card: v2 over
    phase 6's traffic eager and unpipelined (the copies dropped for
    capacity read from the gating), then graphed and pipelined, graphed
    and unpipelined, and over an int8 pool, every run's tokens equal the
    eager run's and #9 / #8 counted once a layer a tick; v1 at 4 x 512 +
    32, eager and graphed with the same tokens, #1 once a layer a
    prefill.  Then 2 of its layers in fp32, v2
    against v1 by phase 7's margin rule extended to the router, and
    ``mixtral-8x7b`` at 2 of its 32 layers, bf16, graphed against eager.
    The same module as target of a 2-layer MoE draft (``moe_draft``),
    and 2 fp32 layers with an MoE draft (``moe_draft_fp32``).
    Returns the kernel-line entries of #9 and #8 at the group-1 shape
    with their launches in the phase's serving runs, and #1's."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models import mixtral, qwen2_moe
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t_phase = time.perf_counter()
    entries = moe_paged_kernels(smi)
    cfg = qwen2_moe.get_config("qwen1.5-moe-a2.7b")
    L, K, T = (cfg.num_hidden_layers, V2["decode_block_size"],
               V2["max_seqs"] + V2["prefill_chunk"])
    graph = {"config": {"enable_cuda_graph": True}}
    p9, p8 = rpa.ragged_paged_attention, rpa.ragged_paged_attention_quant
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with torch.device("meta"):
        model = qwen2_moe.Qwen2MoeForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    module = engine.module
    torch.cuda.synchronize()
    resident = resident_bytes(module) / 2**30
    log(f"[{smi}] moe: qwen1.5-moe-a2.7b up in "
        f"{time.perf_counter() - t0:.1f} s, "
        f"{qwen2_moe.count_params(module) / 1e9:.2f} B parameters, "
        f"resident weights {resident:.2f} GiB, router "
        f"{module.model.layers[0].mlp.gate.dtype}")
    reqs = v2_traffic()
    p9.launches = p8.launches = 0        # the main path starts here
    flash_before = flash_fwd.launches
    calls, stop = watch_drops(module)
    want, eager = serve(engine, reqs)
    stop()
    assert p9.launches == L * engine.host_stats.ticks, (
        f"moe v2: {p9.launches} #9 launches, want {L} x "
        f"{engine.host_stats.ticks} ticks")
    assert flash_fwd.launches == flash_before, "v2 launched the flash kernel"
    k = cfg.num_experts_per_tok
    tick_drops, fused = drops_per_call(calls, T)
    block_drops, dcalls = drops_per_call(calls, V2["max_seqs"])
    st = engine.serving_stages()
    log(f"[{smi}] moe v2 eager: 24 requests in {eager['wall_s']:.2f} s, "
        f"decode {eager['decode_tps']:.1f} tokens/s in blocks, prefill "
        f"{eager['prompt_tokens'] / eager['fused_s']:.0f} prompt tokens/s, "
        f"TTFT p50 {st['requests']['ttft_ms_p50']} ms p99 "
        f"{st['requests']['ttft_ms_p99']} ms; routed copies dropped for "
        f"capacity a layer: {tick_drops:.1f} of {T * k} in fused ticks "
        f"({tick_drops / (T * k):.1%}, {fused // L} ticks), "
        f"{block_drops:.2f} of {V2['max_seqs'] * k} in decode ticks "
        f"({block_drops / (V2['max_seqs'] * k):.1%}, {dcalls // L} "
        "ticks)")
    del engine, calls
    torch.cuda.empty_cache()
    piped = v2_graph_run("moe v2, pipeline on", module, want, [(p9, L)],
                         eager, reqs, pipeline=True, **graph)
    peak = torch.cuda.max_memory_allocated() / 2**30
    v2_graph_run("moe v2, pipeline off", module, want, [(p9, L)], eager,
                 reqs, **graph)
    engine = RaggedInferenceEngineV2(module, device="cuda",
                                     kv_cache_dtype="int8", **V2)
    want8, eager8 = serve(engine, reqs[:8])
    del engine
    v2_graph_run("moe v2, int8 KV pool, pipeline on", module, want8,
                 [(p8, L)], eager8, reqs[:8], kv_cache_dtype="int8",
                 pipeline=True, **graph)
    # (A12c) the same module as target of a 2-layer MoE draft
    moe_draft(smi, module, reqs)
    # v1 over the same module: 4 x 512 + 32, the flash kernel once a layer
    # a prefill; then the decode step captured and replayed, the same
    # tokens
    prompts = torch.randint(0, cfg.vocab_size, (4, 512),
                            generator=torch.Generator().manual_seed(SEED))
    v1_launches, v1_out = 0, []
    for graphed in (False, True):
        v1 = deepspeed_tpu_torch.init_inference(
            module, config={"dtype": "bfloat16", "max_out_tokens": 1024,
                            "enable_cuda_graph": graphed})
        before = flash_fwd.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        v1_out.append(v1.generate(prompts, max_new_tokens=32))
        v1_s = time.perf_counter() - t
        assert flash_fwd.launches - before == L, "moe v1: not one #1 a layer"
        v1_launches += L
        del v1
    assert v1_out[0].shape == (4, 544)
    assert torch.equal(v1_out[0][:, :512], prompts)
    assert torch.equal(v1_out[0], v1_out[1]), "moe v1: graphed != eager"
    entries["ragged_paged_attn_moe_g1"]["launches"] = p9.launches
    entries["ragged_paged_attn_quant_moe_g1"]["launches"] = p8.launches
    log(f"[{smi}] moe v2 graphed + pipelined: decode "
        f"{piped['decode_tps']:.1f} tokens/s in blocks (eager "
        f"{eager['decode_tps']:.1f}), TTFT p50 {piped['ttft_p50']} ms p99 "
        f"{piped['ttft_p99']} ms, prefill "
        f"{piped['prompt_tokens'] / piped['fused_s']:.0f} prompt tokens/s, "
        f"host_bound_fraction {piped['hbf']} (in blocks "
        f"{piped['block_hbf']:.4f}); resident weights {resident:.2f} GiB, "
        f"peak {peak:.2f} GiB; v1 4 x 512 + 32 graphed in {v1_s:.2f} s, "
        f"the eager run's tokens; launches #9 {p9.launches}, #8 "
        f"{p8.launches}, #1 {v1_launches}")
    del module, model
    gc.collect()
    torch.cuda.empty_cache()
    moe_fp32(smi)
    moe_draft_fp32(smi)
    moe_mixtral(smi)
    log(f"[{smi}] phase 24: {time.perf_counter() - t_phase:.1f} s")
    return (entries["ragged_paged_attn_moe_g1"],
            entries["ragged_paged_attn_quant_moe_g1"], v1_launches)


def moe_fp32(smi, quant=None):
    """2 of qwen1.5-moe-a2.7b's layers at full width in fp32 (TF32 off),
    weights made on the card, ``drop_tokens`` off so that v1's batch and
    v2's padded tick route each token alike: 4 greedy requests through v2
    against v1 one at a time.  With ``quant`` (v1's ``quant`` config) v1
    quantizes the weights, the banks too, and v2 serves the same
    quantized module.  Both runs record every row's router logits
    (keyed by position and input token), so the top-k sets of v1 and v2
    are compared at each position.  A token may differ only where v1's
    top-2 logit margin at it is under ``MARGIN``, or where, at a position
    up to it, the two runs routed a token to different experts."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models import qwen2_moe
    from deepspeed_tpu_torch.moe.layer import MoE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = qwen2_moe.get_config("qwen1.5-moe-a2.7b", num_hidden_layers=2,
                               dtype=torch.float32, drop_tokens=False)
    k = cfg.num_experts_per_tok
    with torch.device("meta"):
        model = qwen2_moe.Qwen2MoeForCausalLM(cfg)
    v1 = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "float32", "max_out_tokens": 1024,
                       **({"quant": quant} if quant else {})},
        generator=torch.Generator(device="cuda").manual_seed(SEED + 24))
    module = v1.module
    label = "moe fp32" + (f" ({quant['qtype']} weights and banks)"
                          if quant else "")

    # each forward's (input ids, positions, router logits a layer), cloned
    # where they are made: the engines reuse their buffers
    calls = []
    record = {"on": False}

    def on_forward(_m, args):
        if record["on"]:
            calls.append((args[0].reshape(-1).clone(),
                          args[1].reshape(-1).clone(), []))

    layers = [m for m in module.modules() if isinstance(m, MoE)]
    for mod in layers:
        def gating(x, *a, _m=mod, _inner=mod.gating, **kw):
            if record["on"]:
                calls[-1][2].append(x.float() @ _m.gate.float())
            return _inner(x, *a, **kw)
        mod.gating = gating
    hook = module.model.register_forward_pre_hook(on_forward)

    def recorded(run):
        """``run()`` and its rows: ids [N], positions [N], logits
        [N, layers, E], as numpy."""
        calls.clear()
        record["on"] = True
        out = run()
        torch.cuda.synchronize()
        record["on"] = False
        ids, pos, lg = zip(*calls)
        return out, (torch.cat(ids).cpu().numpy(),
                     torch.cat(pos).cpu().numpy(),
                     torch.cat([torch.stack(l, 1) for l in lg]).cpu().numpy())

    def top_sets(lg):
        return np.sort(np.argsort(-lg, axis=-1, kind="stable")[..., :k], -1)

    rng = np.random.default_rng(SEED + 24)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (37, 100, 300, 513)]
    want, rows1 = [], []
    for p in prompts:
        out, rows = recorded(
            lambda: v1.generate(p[None], max_new_tokens=16)[0].numpy())
        want.append(out)
        ids, pos, _ = rows
        assert np.array_equal(pos, np.arange(len(pos))), "moe fp32: v1 rows"
        assert np.array_equal(ids, out[:len(ids)]), "moe fp32: v1 rows"
        rows1.append(rows)
    eng = RaggedInferenceEngineV2(module, device="cuda", max_seqs=4,
                                  max_seq_len=640, prefill_chunk=128,
                                  page_size=64, decode_block_size=4)
    outs, (ids2, pos2, lg2) = recorded(
        lambda: eng.generate_all(prompts, max_new_tokens=16))
    got = [outs[u] for u in sorted(outs)]
    eng.audit_kv_sharing()
    del eng
    hook.remove()
    for mod in layers:
        del mod.gating
    where = {}
    for r, key in enumerate(zip(pos2.tolist(), ids2.tolist())):
        where.setdefault(key, []).append(r)
    smallest = router_smallest = math.inf
    largest_diff, n_flips = 0.0, 0
    for p, g, w, (_, _, lg1) in zip(prompts, got, want, rows1):
        with torch.no_grad():
            logits = module(torch.from_numpy(w[None, :-1]).cuda())[0][0]
        top2 = logits[len(p) - 1:].topk(2, dim=-1).values
        margins = (top2[:, 0] - top2[:, 1]).cpu().numpy()
        smallest = min(smallest, float(margins.min()))
        top = -np.sort(-lg1, axis=-1)
        gaps = (top[..., k - 1] - top[..., k]).min(axis=-1)     # [N]
        diff = np.nonzero(g != w)[0]
        # the rows both runs fed the model: up to the first differing token
        d = int(diff[0]) if diff.size else len(w) - 1
        router_smallest = min(router_smallest, float(gaps[:d].min()))
        flips = []
        for j in range(d):
            cand = where.get((j, int(w[j])))
            assert cand, f"moe fp32: no v2 row at position {j}"
            errs = np.abs(lg2[cand] - lg1[j]).reshape(len(cand), -1)
            r = cand[int(errs.max(axis=1).argmin())]
            largest_diff = max(largest_diff, float(errs.max(axis=1).min()))
            if not np.array_equal(top_sets(lg2[r]), top_sets(lg1[j])):
                flips.append(j)
        n_flips += len(flips)
        if diff.size:
            i = d - len(p)
            log(f"[{smi}] {label}: prompt {len(p)}: first differing token "
                f"{i}, v1 top-2 margin {margins[i]:.3e}, router gap at it "
                f"{gaps[d - 1]:.3e}; {len(flips)} positions up to it with "
                f"another top-{k} set in v2 (first {flips[:1]})")
            assert margins[i] < MARGIN or flips, (
                f"{label}: v2 differs from v1 at {i} with margin "
                f"{margins[i]:.3e} and the same experts chosen up to it")
        del logits
    same = sum(np.array_equal(a, b) for a, b in zip(got, want))
    log(f"[{smi}] {label}, 2 layers: {same}/4 requests token-equal v2 "
        f"against v1; smallest v1 top-2 margin {smallest:.3e}, smallest "
        f"router k-th/(k+1)-th gap {router_smallest:.3e}, largest v1/v2 "
        f"router logit difference {largest_diff:.3e}, {n_flips} positions "
        f"with another top-{k} set in v2")
    del v1, module, model
    gc.collect()
    torch.cuda.empty_cache()


def moe_draft(smi, module, reqs):
    """Phase 24's MoE-draft leg (A12c): ``module`` (``qwen1.5-moe-a2.7b``
    at full size, bf16) as target of a 2-layer Qwen2-MoE draft at its
    widths and vocabulary, drawn on the card, ``speculation="draft"`` at
    k SPEC_K, graphed: 4 of phase 6's prompts, 32 new tokens each,
    greedy, pipelined twice
    and unpipelined once, every run's tokens equal; #9 held per run to
    the target's layers a tick plus the draft's a draft step and a
    catch-up chunk (``spec_launches``).  Drops are on, so the tokens are
    not held to speculation off: the verify tick's capacity depends on
    the proposals (the fp32 leg holds them with drops off)."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models import qwen2_moe
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    L = module.config.num_hidden_layers
    dcfg = qwen2_moe.get_config("qwen1.5-moe-a2.7b", num_hidden_layers=2)
    with torch.device("meta"):
        draft = qwen2_moe.Qwen2MoeForCausalLM(dcfg)
    greedy = [(p, {"max_new_tokens": 32}) for p, _ in reqs[:4]]
    p9 = rpa.ragged_paged_attention
    outs, lines = [], []
    for label, pipeline in (("pipeline on", True),
                            ("pipeline on, again", True),
                            ("pipeline off", False)):
        extra = dict(draft_model=draft)
        if outs:
            extra = dict(draft_model=draft_module)
        else:
            extra["generator"] = torch.Generator(
                device="cuda").manual_seed(SEED + 26)
        eng = RaggedInferenceEngineV2(
            module, device="cuda", speculation={"mode": "draft",
                                                "k": SPEC_K},
            config={"enable_cuda_graph": True},
            **{**V2, "pipeline": pipeline}, **extra)
        draft_module = eng._draft_module
        assert eng._draft_moe
        before = p9.launches
        out, r = serve(eng, greedy)
        python, device = spec_launches(eng, L, dcfg.num_hidden_layers,
                                       SPEC_K)
        assert p9.launches - before == python, (
            f"moe draft, {label}: #9 counted {p9.launches - before}, want "
            f"{python}")
        if outs:
            for i, (a, b) in enumerate(zip(out, outs[0])):
                assert np.array_equal(a, b), (
                    f"moe draft, {label}: request {i}'s tokens differ from "
                    "the first run's")
        outs.append(out)
        sp = eng.serving_stages()["speculation"]
        assert sp["spec_dispatches"] > 0 and eng.draft_catchup_chunks > 0
        lines.append(
            f"{label}: {r['wall_s']:.2f} s, decode {r['decode_tps']:.1f} "
            f"tokens/s in blocks, acceptance {sp['acceptance_rate']} "
            f"({sp['accepted']}/{sp['proposed']}), draft catch-up chunks "
            f"{eng.draft_catchup_chunks} of {V2['prefill_chunk']} rows, "
            f"#9 {python} counted, {device} on the device")
        del eng
        torch.cuda.empty_cache()
    log(f"[{smi}] moe draft (qwen1.5-moe-a2.7b, a 2-layer Qwen2-MoE draft, "
        f"k {SPEC_K}, graphs, 4 prompts + 32 greedy tokens), tokens equal in "
        "all three "
        "runs: " + "; ".join(lines))
    del draft_module, draft
    gc.collect()
    torch.cuda.empty_cache()


def moe_draft_fp32(smi):
    """2 of qwen1.5-moe-a2.7b's layers at full width in fp32 (TF32 off),
    ``drop_tokens`` off, weights made on the card, with a 2-layer
    Qwen2-MoE draft of another seed: greedy speculation against
    speculation off on the card, by phase 7's margin rule (as phase 20's
    fp32 leg)."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models import qwen2_moe

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = qwen2_moe.get_config("qwen1.5-moe-a2.7b", num_hidden_layers=2,
                               dtype=torch.float32, drop_tokens=False)
    rng = np.random.default_rng(SEED + 26)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (37, 100, 300, 513)]
    kw = dict(max_seqs=4, max_seq_len=704, prefill_chunk=128, page_size=64,
              decode_block_size=4)
    with torch.device("meta"):
        model = qwen2_moe.Qwen2MoeForCausalLM(cfg)
        draft = qwen2_moe.Qwen2MoeForCausalLM(cfg)
    off_eng = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED + 26),
        device="cuda", **kw)
    outs = off_eng.generate_all(prompts, max_new_tokens=NEW_FP32)
    want = [outs[u] for u in sorted(outs)]
    module = off_eng.module
    del off_eng
    margins = []
    with torch.no_grad():
        for p, w in zip(prompts, want):
            logits = module(torch.from_numpy(w[None, :-1]).cuda())[0][0]
            top2 = logits[len(p) - 1:].topk(2, dim=-1).values
            margins.append((top2[:, 0] - top2[:, 1]).cpu().numpy())
    eng = RaggedInferenceEngineV2(
        module, device="cuda", speculation={"mode": "draft", "k": SPEC_K},
        draft_model=draft,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 27),
        **kw)
    outs = eng.generate_all(prompts, max_new_tokens=NEW_FP32)
    got = [outs[u] for u in sorted(outs)]
    eng.audit_kv_sharing()
    sp = eng.serving_stages()["speculation"]
    for p, g, w, m in zip(prompts, got, want, margins):
        diff = np.nonzero(g != w)[0]
        if diff.size:
            i = int(diff[0]) - len(p)
            log(f"[{smi}] moe draft fp32: prompt {len(p)}: first differing "
                f"token {i}, spec-off top-2 margin {m[i]:.3e}")
            assert m[i] < MARGIN, (
                f"moe draft fp32: tokens differ from speculation off at {i} "
                f"with margin {m[i]:.3e}")
    same = sum(np.array_equal(a, b) for a, b in zip(got, want))
    log(f"[{smi}] moe draft fp32, 2 layers, drops off: {same}/4 requests "
        f"token-equal to speculation off; acceptance "
        f"{sp['acceptance_rate']} ({sp['accepted']}/{sp['proposed']}), "
        f"draft catch-up chunks {eng.draft_catchup_chunks}; smallest "
        f"spec-off top-2 margin {min(float(m.min()) for m in margins):.3e}")
    assert sp["spec_dispatches"] > 0
    del eng, module, model, draft
    gc.collect()
    torch.cuda.empty_cache()


def moe_mixtral(smi):
    """``mixtral-8x7b`` at full width and 2 of its 32 layers, bf16,
    random weights made on the card (top 2 of 8, the gates renormalised):
    8 of phase 6's requests eager and unpipelined, then graphed and
    pipelined with the same tokens; #9 twice a tick."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models import mixtral
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = mixtral.get_config("mixtral-8x7b", num_hidden_layers=2)
    assert cfg.num_experts_per_tok == 2 and cfg.num_local_experts == 8
    with torch.device("meta"):
        model = mixtral.MixtralForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    module = engine.module
    assert module.model.layers[0].block_sparse_moe.normalize_weights
    reqs = [(p % cfg.vocab_size, kw) for p, kw in v2_traffic(8)]
    before = rpa.ragged_paged_attention.launches
    want, eager = serve(engine, reqs)
    assert rpa.ragged_paged_attention.launches - before == \
        2 * engine.host_stats.ticks
    del engine
    r = v2_graph_run("mixtral-8x7b (2 of 32 layers) v2, pipeline on",
                     module, want, [(rpa.ragged_paged_attention, 2)], eager,
                     reqs, pipeline=True, config={"enable_cuda_graph": True})
    log(f"[{smi}] moe mixtral-8x7b, 2 layers: 8 requests finished, graphed "
        f"and pipelined tokens equal to eager; decode "
        f"{r['decode_tps']:.1f} tokens/s in blocks (eager "
        f"{eager['decode_tps']:.1f}), resident weights "
        f"{resident_bytes(module) / 2**30:.2f} GiB")
    del module, model
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 25: quantized expert banks (int8, fp8, fp6) through v1 and v2
# ---------------------------------------------------------------------------

# one expert bank of each preset, [E, M, I] (``w1``, ``w3``)
MOE_BANKS = {"mixtral_bank": (8, 4096, 14336), "qwen_bank": (60, 2048, 1408)}
MOE_QUANT_LINE = {
    "dequantize_int8_g2048": "deepspeed_tpu/ops/quantization.py:59",
    "dequant_scaled": "deepspeed_tpu/ops/quantization.py:175",
    "dequant_fp6_g2048": "deepspeed_tpu/ops/quantization.py:274"}
# phase 25(d)'s depth, 8 of qwen1.5-moe-a2.7b's 24 layers: with all 24
# the whole smoke took 918 s on an H100 80GB HBM3 at 700 W with a slower
# host (nvcc 34.0 s where it takes 19.9), over its 900 s budget; (d) runs
# the banks' formats, which every layer runs alike, and phase 24 serves
# the model at full depth
QWEN_QUANT_LAYERS = 8


def moe_quant_traffic(vocab, n=8):
    """``n`` requests of 128..1024 prompt tokens and 32..64 new tokens
    from numpy seed ``SEED + 25``; every third samples, as phase 6's."""
    rng = np.random.default_rng(SEED + 25)
    lens = rng.integers(128, 1025, size=n)
    news = rng.integers(32, 65, size=n)
    reqs = []
    for i in range(n):
        kw = dict(max_new_tokens=int(news[i]))
        if i % 3 == 2:
            kw.update(do_sample=True, temperature=0.8, top_k=50, top_p=0.9)
        reqs.append((rng.integers(0, vocab, size=int(lens[i])), kw))
    return reqs


def moe_bank_kernels(smi):
    """Phase 25(a): #7 (int8, groups of 2048, after #6 quantized the bank
    bit-identically to plain), K1 (fp8, one scale) and K2 (fp6, groups of
    2048) over one ``mixtral-8x7b`` and one ``qwen1.5-moe-a2.7b`` bank in
    bf16, bit-identical to their plain versions on the card; each timed
    (graph-replayed) beside its byte bound and its plain version.
    Returns the kernel-line entries by name, and each format's quantizer
    working set in bytes a value of bf16 input: the most its call adds to
    the card's memory, outputs included, over the two banks."""
    from deepspeed_tpu_torch.ops import quantization as qz

    bf16 = torch.bfloat16
    entries, work = {}, {}
    for i, (bname, shape) in enumerate(MOE_BANKS.items()):
        gen = torch.Generator(device="cuda").manual_seed(SEED + 2500 + i)
        E, M = shape[:2]
        # rows of mixed magnitude, as trained weights have
        w = (torch.randn(shape, generator=gen, device="cuda") *
             torch.rand(E, M, 1, generator=gen, device="cuda") * 0.05
             ).to(bf16)
        n = w.numel()
        t = held_peak(lambda: qz.quantize(w, group_size=2048), work, "int8",
                      n)
        ref = qz.quantize_reference(w, group_size=2048)
        assert all(bits_equal(a, b) for a, b in zip(t[:3], ref[:3])), (
            f"#6 over {bname}: payload, scale, offset differ from plain")
        del ref
        ft = held_peak(lambda: qz.quantize_fp8(w), work, "fp8", n)
        t6 = held_peak(lambda: qz.quantize_fp6(w, 2048), work, "fp6", n)
        assert t6.group_size == 2048
        del w
        cases = (
            ("dequantize_int8_g2048", lambda: qz.dequantize(t),
             lambda: qz.dequantize_reference(t),
             2 * n + t.values.numel() + 8 * t.scale.numel()),
            ("dequant_scaled", lambda: qz.dequantize_fp8(ft),
             lambda: qz.dequant_scaled_reference(ft.values, ft.scale, bf16),
             3 * n + 4),
            ("dequant_fp6_g2048", lambda: qz.dequantize_fp6(t6),
             lambda: qz.dequantize_fp6_reference(t6),
             t6.values.numel() + 4 * t6.scale.numel() + 2 * n))
        parts = []
        for kname, run, plain, nbytes in cases:
            got, want = run(), plain()
            assert bits_equal(got, want), f"{kname} over {bname} != plain"
            err = (got.float() - want.float()).abs().max().item()
            del got, want
            ms = graph_ms(run)
            plain_ms = time_ms(plain, reps=3, warmup=1)
            e = wq_entry(f"{kname}_{bname}", ms, plain_ms, nbytes,
                         MOE_QUANT_LINE[kname],
                         source="quantization.cu" if kname.startswith(
                             "dequantize_int8") else "weight_formats.cu")
            e["max_abs_err"] = err
            entries[e["name"]] = e
            parts.append(f"{kname} {ms:.4f} ms (bound {e['bound_ms']:.4f} "
                         f"ms, {e['bound_ms'] / ms:.1%}; plain "
                         f"{plain_ms:.3f} ms)")
        log(f"[{smi}] moe bank {bname} {list(shape)} bf16 ({n / 1e9:.3f} G "
            f"values): #6, #7, K1 and K2 bit-identical to plain; "
            + "; ".join(parts) + "; the quantizers' working sets "
            + ", ".join(f"{f} {b:.2f} B a value" for f, b in work.items()))
        del t, ft, t6, cases
        torch.cuda.empty_cache()
    return entries, work


def held_peak(fn, work, fmt, n):
    """``fn()``, recording in ``work[fmt]`` the most bytes a value of its
    ``n`` that its call added to the allocated memory at its peak."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    added = (torch.cuda.max_memory_allocated() - base) / n
    work[fmt] = max(work.get(fmt, 0.0), added)
    return out


def streamed_build(smi, make, name, fmt, work):
    """The engines' build of a meta model with no weights given
    (``normalize_params`` with ``quantize``, as v2 calls it), run alone:
    an engine allocates its KV pool after the build, which would hide the
    build's peak.  Its weights are drawn and quantized module by module,
    so its peak above what was allocated before holds the quantized model
    and the largest transient of one module: its own full-precision
    parameters, a Linear's transposed copy, and the quantizer's working
    set (``work``, bytes a value, from phase 25(a)) for its largest
    weight; with 0.25 GiB for the allocator's rounding and the small
    buffers.  A build that kept the weights it has quantized, or drew the
    whole model first, goes over.  Returns the model's parameter count."""
    from deepspeed_tpu_torch.inference.common import normalize_params

    with torch.device("meta"):
        model = make()
    n_params = sum(p.numel() for p in model.parameters())
    transient = 0
    for mod in model.modules():     # bf16, the router fp32
        fp32 = getattr(mod, "fp32_params", ())
        own = list(mod.named_parameters(recurse=False))
        big = max((p.numel() for _, p in own if p.dim() >= 2), default=0)
        transient = max(transient, sum(
            p.numel() * (4 if n in fp32 else 2) for n, p in own)
            + (2 * big if isinstance(mod, torch.nn.Linear) else 0)
            + work[fmt] * big)
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    module = normalize_params(
        model, dtype=torch.bfloat16, device=torch.device("cuda"),
        generator=torch.Generator(device="cuda").manual_seed(SEED),
        keep_fp32=True, quantize=dict(fmt=fmt, native_w8a8=True))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() - base
    resident = resident_bytes(module)
    bound = resident + transient + 2**28
    log(f"[{smi}] moe {fmt}: {name} ({n_params / 1e9:.2f} B parameters, "
        f"{n_params * 2 / 2**30:.1f} GiB in bf16) built on meta and "
        f"quantized module by module in {build_s:.1f} s: resident "
        f"{resident / 2**30:.2f} GiB, build peak {peak / 2**30:.2f} GiB "
        f"above the memory before it, bound {bound / 2**30:.2f} GiB (the "
        f"largest module's transient {transient / 2**30:.2f} GiB + 0.25)")
    assert peak <= bound, (
        f"{name} {fmt} build: peak {peak / 2**30:.2f} GiB over the bound "
        f"{bound / 2**30:.2f} GiB")
    del module, model
    gc.collect()
    torch.cuda.empty_cache()
    return n_params


def n_quantized(module) -> int:
    """The module's quantized weights: one dequant launch each a tick."""
    from deepspeed_tpu_torch.inference.quantization import _Quantized

    return sum(isinstance(m, _Quantized) for m in module.modules())


def phase_moe_quant():
    """Phase 25: quantized expert banks.  (a) #7, K1 and K2 at the bank
    shapes (:func:`moe_bank_kernels`).  (b) ``mixtral-8x7b`` at full size
    (32 layers, published widths), built on meta and quantized to int8 by
    v2 one module at a time: peak memory under its 87.0 GiB of bf16; 8
    requests eager and unpipelined, then graphed and pipelined with the
    same tokens, #7 226 and #9 32 a tick.  (c) v1 over the same module
    (cast by v1's rule: the router to bf16), int8 at groups of 2048, 2 x
    512 + 32 eager against graphed, #1 once a layer a prefill.  (d)
    ``qwen1.5-moe-a2.7b`` at 8 of its 24 layers with fp8 and with fp6
    banks through v2, graphed against eager, K1 / K2 90 a tick.  (e) phase 24's fp32 leg with int8
    banks.  Returns the kernel-line entries with their launches, and #1's
    launches."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models import mixtral, qwen2_moe
    from deepspeed_tpu_torch.ops import quantization as qz
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa
    from deepspeed_tpu_torch.ops.flash_attention import flash_fwd

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    entries, work = moe_bank_kernels(smi)
    graph = {"config": {"enable_cuda_graph": True}}
    p9 = rpa.ragged_paged_attention

    # (b) mixtral-8x7b, int8, built module by module
    cfg = mixtral.get_config("mixtral-8x7b")
    L = cfg.num_hidden_layers
    n_params = streamed_build(smi, lambda: mixtral.MixtralForCausalLM(cfg),
                              "mixtral-8x7b", "int8", work)
    bf16_gib = n_params * 2 / 2**30
    with torch.device("meta"):
        model = mixtral.MixtralForCausalLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    qz.quantize.launches = qz.dequantize.launches = 0   # the path starts
    t0 = time.perf_counter()
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", quantize_weights="int8", **V2)
    module = engine.module
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    n_w = n_quantized(module)
    assert n_w == 7 * L + 2 and qz.quantize.launches == n_w, (
        n_w, qz.quantize.launches)
    resident = resident_bytes(module)
    build_peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[{smi}] moe int8: mixtral-8x7b v2 engine built in {build_s:.1f} "
        f"s: {n_w} weights (#6 {qz.quantize.launches} launches), resident "
        f"{resident / 2**30:.2f} GiB, peak with the KV pool "
        f"{build_peak:.2f} GiB")
    assert build_peak < bf16_gib
    reqs = moe_quant_traffic(cfg.vocab_size)
    p9.launches = qz.dequantize.launches = 0
    want, eager = serve(engine, reqs)
    ticks = engine.host_stats.ticks
    assert (qz.dequantize.launches, p9.launches) == (n_w * ticks,
                                                     L * ticks), (
        f"moe int8 eager: (#7, #9) {(qz.dequantize.launches, p9.launches)}"
        f", want {n_w} and {L} x {ticks} ticks")
    st = engine.serving_stages()
    log(f"[{smi}] moe int8 v2 eager: {len(reqs)} requests in "
        f"{eager['wall_s']:.2f} s, decode {eager['decode_tps']:.1f} "
        f"tokens/s in blocks, TTFT p50 {st['requests']['ttft_ms_p50']} ms "
        f"p99 {st['requests']['ttft_ms_p99']} ms, {ticks} ticks")
    del engine
    torch.cuda.empty_cache()
    r = v2_graph_run("moe int8 mixtral-8x7b v2, pipeline on", module, want,
                     [(qz.dequantize, n_w), (p9, L)], eager, reqs,
                     pipeline=True, **graph)
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert peak < bf16_gib, f"peak {peak:.2f} GiB over bf16's {bf16_gib:.1f}"
    tick_ms = r["block_s"] / max(r["blocks"] * V2["decode_block_size"],
                                 1) * 1e3
    bound_ms = resident / PEAK_BYTES * 1e3
    mix = entries["dequantize_int8_g2048_mixtral_bank"]
    mix["launches"] = qz.dequantize.launches
    device7 = r["device"]["dequantize"]
    log(f"[{smi}] moe int8 mixtral-8x7b v2 graphed + pipelined: decode "
        f"{r['decode_tps']:.1f} tokens/s in blocks (eager "
        f"{eager['decode_tps']:.1f}), TTFT p50 {r['ttft_p50']} ms p99 "
        f"{r['ttft_p99']} ms, host_bound_fraction {r['hbf']} (in blocks "
        f"{r['block_hbf']:.4f}); a replayed tick {tick_ms:.1f} ms wall "
        f"against the int8 weight read's {bound_ms:.1f} ms "
        f"({resident / 1e9:.1f} GB at 3.35 TB/s): {bound_ms / tick_ms:.1%};"
        f" resident {resident / 2**30:.2f} GiB, peak {peak:.2f} GiB (bf16 "
        f"would need {bf16_gib:.1f}); #7 counted {qz.dequantize.launches} "
        f"({n_w} a tick), {device7} on the device in the graphed run, "
        f"derived")

    # (c) v1 over the same module and format
    prompts = torch.randint(0, cfg.vocab_size, (2, 512),
                            generator=torch.Generator().manual_seed(SEED))
    v1_out, v1_flash = [], 0
    quant = {"enabled": True, "qtype": "int8", "group_size": 2048}
    for graphed in (False, True):
        v1 = deepspeed_tpu_torch.init_inference(
            module, config={"dtype": "bfloat16", "max_out_tokens": 1024,
                            "enable_cuda_graph": graphed, "quant": quant})
        before = (flash_fwd.launches, qz.dequantize.launches)
        torch.cuda.synchronize()
        t = time.perf_counter()
        v1_out.append(v1.generate(prompts, max_new_tokens=32))
        v1_s = time.perf_counter() - t
        got = (flash_fwd.launches - before[0],
               qz.dequantize.launches - before[1])
        assert got[0] == L, "moe int8 v1: not one #1 a layer"
        assert graphed or got[1] == n_w * 32, got
        v1_flash += L
        mix["launches"] += got[1]
        router = module.model.layers[0].block_sparse_moe.gate.dtype
        log(f"[{smi}] moe int8 mixtral-8x7b v1 "
            f"{'graphed' if graphed else 'eager'}: 2 x 512 + 32 in "
            f"{v1_s:.2f} s, #1 {got[0]}, #7 counted {got[1]}; router "
            f"{router} (v1 casts it)")
        del v1
    assert torch.equal(v1_out[0][:, :512], prompts)
    assert torch.equal(v1_out[0], v1_out[1]), "moe int8 v1: graphed != eager"
    del module, model
    gc.collect()
    torch.cuda.empty_cache()

    # (d) qwen1.5-moe-a2.7b with fp8 and fp6 banks
    qcfg = qwen2_moe.get_config("qwen1.5-moe-a2.7b",
                                num_hidden_layers=QWEN_QUANT_LAYERS)
    QL = qcfg.num_hidden_layers
    qreqs = moe_quant_traffic(qcfg.vocab_size)
    for fmt, counter, kname in (("fp8", qz.dequant_scaled, "dequant_scaled"),
                                ("fp6", qz.dequantize_fp6,
                                 "dequant_fp6_g2048")):
        streamed_build(smi, lambda: qwen2_moe.Qwen2MoeForCausalLM(qcfg),
                       "qwen1.5-moe-a2.7b", fmt, work)
        with torch.device("meta"):
            model = qwen2_moe.Qwen2MoeForCausalLM(qcfg)
        engine = RaggedInferenceEngineV2(
            model, device="cuda", quantize_weights=fmt, **V2,
            generator=torch.Generator(device="cuda").manual_seed(SEED))
        module = engine.module
        n_w = n_quantized(module)
        assert n_w == 11 * QL + 2, n_w
        counter.launches = p9.launches = 0      # the path starts
        want, eager = serve(engine, qreqs)
        ticks = engine.host_stats.ticks
        assert (counter.launches, p9.launches) == (n_w * ticks, QL * ticks)
        del engine
        r = v2_graph_run(f"moe {fmt} qwen1.5-moe-a2.7b v2, pipeline on",
                         module, want, [(counter, n_w), (p9, QL)], eager,
                         qreqs, pipeline=True, **graph)
        entries[f"{kname}_qwen_bank"]["launches"] = counter.launches
        log(f"[{smi}] moe {fmt} qwen1.5-moe-a2.7b ({QL} layers) v2: "
            f"resident {resident_bytes(module) / 2**30:.2f} GiB; decode "
            f"{r['decode_tps']:.1f} tokens/s graphed + pipelined (eager "
            f"{eager['decode_tps']:.1f}), TTFT p50 {r['ttft_p50']} ms p99 "
            f"{r['ttft_p99']} ms; {counter.__name__} counted "
            f"{counter.launches} ({n_w} a tick), "
            f"{r['device'][counter.__name__]} on the device in the graphed "
            "run, derived")
        del module, model
        gc.collect()
        torch.cuda.empty_cache()

    # (e) phase 24's fp32 leg over int8 banks
    moe_fp32(smi, quant=quant)
    log(f"[{smi}] phase 25: {time.perf_counter() - t_phase:.1f} s")
    return ([entries[k] for k in ("dequantize_int8_g2048_mixtral_bank",
                                  "dequant_scaled_qwen_bank",
                                  "dequant_fp6_g2048_qwen_bank")], v1_flash)


# ---------------------------------------------------------------------------
# Phase 26: the tuning layer (A10b): the training autotuner, the online
# controller, the offline sweep and the host profile
# ---------------------------------------------------------------------------

# the autotuner's optimal config, the sweep's profile and the tiering
# leg's spill files go under the git-ignored build/, removed afterwards
TUNE_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_tuning")
# the reference test's armed controller (tests/unit/test_serving_pipeline.py,
# TestControlPlane._ctl): a tick every step, judged after one settle tick
CONTROL = {"interval": 1, "settle": 1, "cooldown": 0}
AUTOTUNE_STEPS = 3


def gpt2_autotune_job():
    """bench.py's config 1 as an autotuning job: ``gpt2-125m`` at full
    size on the meta device (each engine draws its weights on the card)
    and its batches of 1024 tokens (numpy seed SEED).  Phase 26's
    subprocess point imports it as ``chip_smoke:gpt2_autotune_job``."""
    from deepspeed_tpu_torch.models.gpt2 import GPT2LMLoss, get_config

    cfg = get_config("gpt2-125m", n_positions=1024, remat=False,
                     remat_policy="none", use_flash_attention=True)
    with torch.device("meta"):
        model = GPT2LMLoss(cfg)

    def batch_fn(n):
        return np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                    size=(n, 1024))
    return model, batch_fn


def tuning_autotuner(smi):
    """(a) ``Autotuner`` on bench.py's config 1 (bf16, fused AdamW, seq
    1024) over ZeRO stages 0-2 and micro batches 4..32 doubling, every
    point a fresh engine timed by ``engine_runner`` (each point's #1, #2,
    #3 and #4 held to phase 17's 12, 12, 12 and 1 a step), the winner's
    config written and read back, and the winner again in a fresh
    interpreter through ``make_subprocess_runner``.  Returns the launches
    by kernel."""
    from deepspeed_tpu_torch.autotuning import (Autotuner,
                                                ExperimentScheduler,
                                                ModelInfo,
                                                make_subprocess_runner)
    from deepspeed_tpu_torch.autotuning.autotuner import engine_runner
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fo

    counters = {"flash_fwd": fa.flash_fwd, "flash_bwd_dq": fa.flash_bwd_dq,
                "flash_bwd_dkv": fa.flash_bwd_dkv,
                "fused_adam": fo.fused_adam}
    model, batch_fn = gpt2_autotune_job()
    L = model.config.n_layer
    base = gpt2_train_config("AdamW", 4, 0)
    for key in ("train_batch_size", "train_micro_batch_size_per_gpu",
                "zero_optimization"):
        base.pop(key)
    base["autotuning"] = {"fast": False, "zero_stages": [0, 1, 2],
                          "min_train_micro_batch_size_per_gpu": 4,
                          "max_train_micro_batch_size_per_gpu": 32}
    run = engine_runner(model, batch_fn, steps=AUTOTUNE_STEPS,
                        device="cuda")
    per_point = []

    def runner(cfg):
        before = [c.launches for c in counters.values()]
        try:
            return run(cfg)
        finally:
            per_point.append([c.launches - b for c, b in
                              zip(counters.values(), before)])

    for c in counters.values():          # the main path's run starts here
        c.launches = 0
    info = ModelInfo.from_model(model)
    tuner = Autotuner(info, base, runner=runner, device="cuda")
    t = time.perf_counter()
    best_cfg, best = tuner.tune()
    tune_s = time.perf_counter() - t
    launches = {k: c.launches for k, c in counters.items()}
    assert best_cfg is not None, "autotuner: no point ran"
    assert {r["zero_stage"] for r in tuner.records} == {0, 1, 2}
    want = [(AUTOTUNE_STEPS + 1) * n for n in (L, L, L, 1)]
    rows = []
    for rec, got in zip(tuner.records, per_point):
        tput = rec["throughput"]
        assert tput is not None, f"autotuner: point {rec} failed"
        assert got == want, (f"autotuner point stage {rec['zero_stage']} "
                             f"mbs {rec['micro_batch_size']}: launches "
                             f"{got}, want {want}")
        rows.append(f"stage {rec['zero_stage']} mbs "
                    f"{rec['micro_batch_size']}: {tput:.1f} samples/s, peak "
                    f"{rec['peak_bytes'] / 2**30:.2f} GiB (memory model "
                    f"{rec['estimate_bytes'] / 2**30:.2f} GiB), "
                    f"{rec['tuning_seconds']:.1f} s")
    os.makedirs(TUNE_DIR, exist_ok=True)
    path = os.path.join(TUNE_DIR, "ds_config.json")
    tuner.write_optimal_config(path)
    with open(path) as f:
        assert json.load(f) == best_cfg
    # the winner again, in a fresh interpreter on the card
    repo = os.path.dirname(os.path.abspath(__file__))
    sub = make_subprocess_runner(
        "chip_smoke:gpt2_autotune_job", steps=AUTOTUNE_STEPS, timeout=600,
        env={"PYTHONPATH": repo}, device="cuda")
    t = time.perf_counter()
    (exp,) = ExperimentScheduler(sub, exps_dir=TUNE_DIR).run_experiments(
        [best_cfg])
    assert exp.ok, f"autotuner: the subprocess point failed: {exp.error}"
    log(f"[{smi}] autotuner, gpt2-125m (config 1: bf16, fused AdamW, seq "
        f"1024; {info.num_params / 1e6:.2f} M parameters), ZeRO 0-2 x micro "
        f"batch 4..32, {len(tuner.records)} points in {tune_s:.1f} s, "
        f"{AUTOTUNE_STEPS} timed steps after one warm-up, each point's #1, "
        f"#2, #3, #4 launches {want}: " + "; ".join(rows) +
        f"; winner stage {best_cfg['zero_optimization']['stage']} mbs "
        f"{best_cfg['train_micro_batch_size_per_gpu']} at {best:.1f} "
        f"samples/s, written to and read back from build/; the winner in a "
        f"fresh interpreter: {exp.metric_val:.1f} samples/s "
        f"({time.perf_counter() - t:.1f} s with its start)")
    return launches


def tuned_run(engine, traffic, counters, want=None, label=""):
    """Serve ``traffic`` on ``engine``; each ``(counter, per tick)`` of
    ``counters`` held to per x (eager ticks + 2 K x new captures) over the
    run, as phase 14 holds it; tokens held to ``want`` when given.
    Returns the outputs, the run's numbers and the stages."""
    st0 = engine.host_stats
    before = dict(ticks=st0.ticks, rep=st0.graph_replays,
                  cap=st0.graph_captures,
                  n=[c.launches for c, _ in counters])
    out, r = serve(engine, traffic)
    st = engine.serving_stages()
    K = engine.decode_block_size
    rep = st.get("graph_replays", 0) - before["rep"]
    cap = st.get("graph_captures", 0) - before["cap"]
    eager_ticks = engine.host_stats.ticks - before["ticks"] - K * rep
    for (c, per), b in zip(counters, before["n"]):
        assert c.launches - b == per * (eager_ticks + 2 * K * cap), (
            f"{label}: {c.__name__} counted {c.launches - b}, want {per} x "
            f"({eager_ticks} eager ticks + 2 x {K} x {cap} captures)")
    if want is not None:
        for i, (a, b) in enumerate(zip(out, want)):
            assert np.array_equal(a, b), (
                f"{label}: request {i}'s tokens differ")
    return out, r, st


def tuning_control(smi):
    """(b) the online controller and (c) the offline sweep and profile on
    ``llama3-8b`` at full width and depth, bf16, graphed and pipelined
    (phase 14's settings), over phase 6's traffic; then the controller
    over phase 19's tight pool with the tiers at TIERED_LAYERS layers,
    bf16 and int8 pools.  Returns the launches of #9 and #8."""
    import shutil

    from deepspeed_tpu_torch.control import (autotune_serving,
                                             host_fingerprint, load_profile)
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    cfg = get_config("llama3-8b")
    L = cfg.num_hidden_layers
    p9, p8 = rpa.ragged_paged_attention, rpa.ragged_paged_attention_quant
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    module = engine.module
    del engine
    reqs = v2_traffic()
    graph = {"config": {"enable_cuda_graph": True}}
    p9.launches = p8.launches = 0         # the main path starts here

    def fresh(**kw):
        return RaggedInferenceEngineV2(module, device="cuda",
                                       **{**V2, "pipeline": True, **graph,
                                          **kw})

    # (b) control off, then armed: the same tokens, the same captures
    eng = fresh()
    want, off, st_off = tuned_run(eng, reqs, [(p9, L)], label="control off")
    del eng
    eng = fresh(control=CONTROL)
    assert eng._controller is not None
    _, on, st_on = tuned_run(eng, reqs, [(p9, L)], want,
                             label="control armed")
    ctl = st_on["control"]
    log_counts = {}
    for d in eng._controller.decision_log:
        log_counts[d["action"]] = log_counts.get(d["action"], 0) + 1
    del eng
    torch.cuda.empty_cache()
    assert ctl["ticks"] > 0 and ctl["probes"] > 0, ctl
    assert st_on["graph_captures"] == st_off["graph_captures"], (
        f"control armed captured {st_on['graph_captures']} graphs, control "
        f"off {st_off['graph_captures']}")
    log(f"[{smi}] control (llama3-8b bf16, graphs + pipeline, 24 requests, "
        f"{CONTROL}): tokens equal to control off; controller ticks "
        f"{ctl['ticks']}, decisions {ctl['decisions']} by action "
        f"{log_counts}, probes {ctl['probes']}, accepts {ctl['accepts']}, "
        f"reverts {ctl['reverts']}, settles {ctl['settles']}, frozen "
        f"{ctl['frozen']}, knobs after {ctl['knobs']}; graph captures "
        f"{st_on['graph_captures']} (control off "
        f"{st_off['graph_captures']}); host_bound_fraction "
        f"{st_on['host_bound_fraction']} (off "
        f"{st_off['host_bound_fraction']}), in blocks "
        f"{on['block_hbf']:.4f} (off {off['block_hbf']:.4f}); decode "
        f"{on['decode_tps']:.1f} tokens/s in blocks (off "
        f"{off['decode_tps']:.1f}); wall {on['wall_s']:.2f} s (off "
        f"{off['wall_s']:.2f})")

    # (c) the offline sweep on a short greedy traffic, control off, its
    # profile, a new engine seeded from it, and the block size changed
    # between two runs of that engine.  Greedy, since a sampled request's
    # draws are keyed by its uid, which a second run on one engine moves
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    short = [(p, {"max_new_tokens": kw["max_new_tokens"]})
             for p, kw in reqs[:8]]
    points, by_k = [], {}

    def measure(point):
        k = point["engine.decode_block_size"]
        eng = fresh(decode_block_size=k,
                    harvest_interval=point["engine.harvest_interval"])
        # the harvest interval moves no token: one block size, one output
        out, r, _ = tuned_run(eng, short, [(p9, L)], by_k.get(k),
                              label=f"sweep {point}")
        by_k.setdefault(k, out)
        points.append(f"{point}: {r['decode_tps']:.1f}")
        return r["decode_tps"]

    space = {"engine.decode_block_size": [4, 8],
             "engine.harvest_interval": [1, 4]}
    prof = autotune_serving(measure, space, metric_name="decode_tok_per_s",
                            save_to=TUNE_DIR, device="cuda")
    assert prof is not None and len(points) == 4, points
    win_k = prof.knobs["engine.decode_block_size"]
    win_h = prof.knobs["engine.harvest_interval"]
    assert load_profile(TUNE_DIR, fingerprint=host_fingerprint(
        "cuda")).knobs == prof.knobs
    eng = fresh(control={"profile": TUNE_DIR, "interval": 1000000})
    assert (eng.decode_block_size, eng.harvest_interval) == (win_k, win_h)
    assert eng.host_stats.graph_captures == 0
    _, seeded, st = tuned_run(eng, short, [(p9, L)], by_k[win_k],
                              label="profile-seeded")
    caps = st["graph_captures"]
    assert caps >= 1
    # the offline knob between two runs: one more capture, the tokens of
    # the other block size
    other = 4 if win_k == 8 else 8
    eng.knob_registry().set("engine.decode_block_size", other,
                            allow_recompile=True)
    _, changed, st = tuned_run(eng, short, [(p9, L)], by_k[other],
                               label=f"decode_block_size {win_k} -> {other}")
    assert st["graph_captures"] == caps + 1, (caps, st["graph_captures"])
    del eng
    torch.cuda.empty_cache()
    same = sum(np.array_equal(a, b) for a, b in zip(by_k[4], by_k[8]))
    log(f"[{smi}] offline sweep (8 of the 24 requests, greedy, control "
        f"off; decode tokens/s in blocks by point: {'; '.join(points)}; "
        f"the same tokens at both harvest intervals): winner {prof.knobs} "
        f"at {prof.metric:.1f}, profile {prof.key} saved under build/ and "
        f"read back; a new engine seeded from it starts at K {win_k}, "
        f"harvest {win_h} before any capture and serves the sweep's tokens "
        f"at K {win_k} (decode {seeded['decode_tps']:.1f} tokens/s); "
        f"decode_block_size set to {other} between runs: graph captures "
        f"{caps} -> {caps + 1}, the sweep's tokens at K {other} "
        f"({changed['decode_tps']:.1f} tokens/s); K 4 and K 8 give "
        f"{same}/8 equal outputs")
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    del module, model
    gc.collect()
    torch.cuda.empty_cache()

    # the controller over the tight pool with the tiers, prefetch off at
    # the start: the spill signal's rule turns it on
    tcfg = get_config("llama3-8b", num_hidden_layers=TIERED_LAYERS)
    with torch.device("meta"):
        model = LlamaForCausalLM(tcfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(SEED),
        device="cuda", **V2)
    module = engine.module
    del engine
    tight = 1 + V2["max_seqs"] * (V2["max_seq_len"] // V2["page_size"] // 4)
    rng = np.random.default_rng(SEED + 2)
    heavy = [(rng.integers(0, tcfg.vocab_size, size=100),
              dict(max_new_tokens=500)) for _ in range(V2["max_seqs"])]
    tiering = dict(TIER, prefetch=False,
                   nvme_dir=os.path.join(TUNE_DIR, "kvtier"))
    lines = []
    for fmt, kernel in (("none", p9), ("int8", p8)):
        runs = {}
        for armed in (False, True):
            eng = fresh(num_pages=tight, kv_cache_dtype=fmt,
                        kv_tiering=tiering,
                        **({"control": CONTROL} if armed else {}))
            held = hold_restores(eng)
            out, r, st = tuned_run(
                eng, heavy, [(kernel, TIERED_LAYERS)],
                runs[False][0] if armed else None,
                label=f"tiering {fmt} pool, control {armed}")
            kt = st["kv_tiering"]
            assert eng.spills > 0 and kt["quarantined"] == 0, kt
            assert kt["pages_verified"] == kt["pages_restored"] == \
                held["pages"] > 0, (kt, held)
            rules = ([d for d in eng._controller.decision_log
                      if d["action"] == "rule"] if armed else [])
            runs[armed] = (out, r, st, kt, rules, eng.spills, eng.restores)
            eng.close()
            del eng
            torch.cuda.empty_cache()
        out, r, st, kt, rules, spills, restores = runs[True]
        assert rules and all(d["knob"] == "kv.prefetch" and
                             d["signal"] == "tiering_spill_rate"
                             and d["new"] is True for d in rules), rules
        lines.append(
            f"{fmt} pool: tokens equal to control off; spills {spills}, "
            f"restores {restores} (off {runs[False][5]}, "
            f"{runs[False][6]}), {kt['pages_restored']} pages restored, "
            f"each digest-verified and read back equal to its spilled "
            f"bytes; prefetch rule fired {len(rules)} x at tick "
            f"{[d['tick'] for d in rules]} on tiering_spill_rate; prefetch "
            f"hits {kt['prefetch_hits']} misses {kt['prefetch_misses']} "
            f"(off {runs[False][3]['prefetch_hits']}, "
            f"{runs[False][3]['prefetch_misses']}); controller "
            f"{st['control']['decisions']} decisions, "
            f"{st['control']['probes']} probes; wall {r['wall_s']:.2f} s "
            f"(off {runs[False][1]['wall_s']:.2f})")
    shutil.rmtree(TUNE_DIR, ignore_errors=True)
    log(f"[{smi}] control over the tiers (llama3-8b at {TIERED_LAYERS} "
        f"layers, {tight} pages, host {TIER['host_pages']} + NVMe "
        f"{TIER['nvme_pages']} pages, prefetch off at the start, 16 x "
        f"(100 + 500), graphs + pipeline): " + " | ".join(lines))
    del module, model
    gc.collect()
    torch.cuda.empty_cache()
    return p9.launches, p8.launches


def phase_tuning():
    """Phase 26: the tuning layer (A10b).  Returns the launches of #1,
    #2, #3, #4 (the autotuner's points) and of #9 and #8 (the
    controller's runs)."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t_phase = time.perf_counter()
    train = tuning_autotuner(smi)
    log(f"[{smi}] phase 26 (a) done at {time.perf_counter() - t_phase:.1f} s")
    paged = tuning_control(smi)
    log(f"[{smi}] phase 26: {time.perf_counter() - t_phase:.1f} s; "
        f"launches counted: {train} in the autotuner's points, "
        f"ragged_paged_attn {paged[0]} and ragged_paged_attn_quant "
        f"{paged[1]} in the controller's runs")
    return train, paged


# ---------------------------------------------------------------------------
# Phase 27: ZeRO-Offload and ZeRO-Infinity (A11)
# ---------------------------------------------------------------------------

OFFLOAD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build", "smoke_offload")
HOST_SPARE = 16 << 30       # host RAM the 8 B leg leaves free
OFFLOAD_STEPS = 3


def meminfo():
    """``MemTotal`` and ``MemAvailable`` of the host, in bytes."""
    out = {}
    with open("/proc/meminfo") as f:
        for line in f:
            key, val = line.split(":", 1)
            if key in ("MemTotal", "MemAvailable"):
                out[key] = int(val.split()[0]) * 1024
    return out


def offload_config(stage, tier=None, param=False, micro=4, gas=2, **off):
    """Phase 9's training config at ``stage``, with the optimizer state in
    ``tier`` ("cpu" or "nvme"; the working copy too with ``param``)."""
    zero = {"stage": stage}
    if tier is not None:
        zero["offload_optimizer"] = dict(device=tier, **off)
        if tier == "nvme":
            zero["offload_optimizer"]["nvme_path"] = OFFLOAD_DIR
    if param:
        zero["offload_param"] = {"device": "cpu"}
    return train_config(zero_optimization=zero,
                        train_micro_batch_size_per_gpu=micro,
                        gradient_accumulation_steps=gas)


def offload_run(cfg, config, batch, steps, keep_master=True):
    """``steps`` train_batch calls on a fresh engine: losses, the final
    master on the host, step seconds, peak GiB, and the engine."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaLMLoss

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    with torch.device("meta"):
        model = LlamaLMLoss(cfg)
    t = time.perf_counter()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config,
        generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t
    losses, step_s = [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        losses.append(float(engine.train_batch(batch=batch)))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t)
    master = None
    if keep_master:
        engine._settle_tier()
        master = engine.state.params.detach().to("cpu", copy=True)
    return dict(engine=engine, model=model, losses=losses, master=master,
                step_s=step_s, init_s=init_s,
                peak=torch.cuda.max_memory_allocated() / 2**30)


def drop(run):
    """Free a run's engine (its tier unpins and removes its files)."""
    eng = run.pop("engine", None)
    if eng is not None and eng.swapper is not None:
        eng.swapper.close()
    run.pop("model", None)
    del eng
    gc.collect()
    torch.cuda.empty_cache()


def offload_1b(smi):
    """Phase 27(a): the tiers on ``llama-1b`` at full size, phase 9's
    config, seed and batch, 3 steps each."""
    import shutil

    from deepspeed_tpu_torch.models.llama import get_config
    from deepspeed_tpu_torch.ops import fused_adam as fo

    cfg = get_config("llama-1b")
    batch = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                 size=(8, 2048))
    shutil.rmtree(OFFLOAD_DIR, ignore_errors=True)
    os.makedirs(OFFLOAD_DIR)
    lines, launches = [], 0

    def leg(label, config, steps=OFFLOAD_STEPS, **kw):
        nonlocal launches
        before = fo.fused_adam.launches
        r = offload_run(cfg, config, batch, steps, **kw)
        sw = r["engine"].swapper
        n = fo.fused_adam.launches - before
        if sw is not None:
            assert n == steps * len(sw.buckets), (label, n, len(sw.buckets))
            launches += n
        lines.append(
            f"{label}: losses {[round(x, 4) for x in r['losses']]}, step s "
            f"{[round(x, 2) for x in r['step_s']]}, init {r['init_s']:.1f} s,"
            f" peak {r['peak']:.2f} GiB"
            + (f", {len(sw.buckets)} buckets (#4 launches {n}), host "
               f"{sw.host_bytes / 2**30:.2f} GiB pinned in "
               f"{sw.pin_seconds:.1f} s, stages {sw.stage_stats}"
               if sw is not None else ""))
        return r

    res = leg("stage 0 resident", offload_config(0))
    drop(res)
    cpu = leg("stage 0 tier cpu", offload_config(0, "cpu"))
    drop(cpu)
    same = (cpu["losses"] == res["losses"] and
            torch.equal(cpu["master"], res["master"]))
    assert same, ("tier cpu differs from resident", cpu["losses"],
                  res["losses"])
    lines.append("stage 0 tier cpu = resident bit for bit (losses and the "
                 "final master)")
    del cpu
    res3 = leg("stage 3 resident", offload_config(3))
    drop(res3)
    s3 = leg("stage 3 offload_optimizer + offload_param cpu",
             offload_config(3, "cpu", param=True))
    numels = s3["engine"].buffer_numels()
    drop(s3)
    # the host working copy and its unit fill, held bit for bit
    same = (s3["losses"] == res3["losses"] and
            torch.equal(s3["master"], res3["master"]))
    assert same, ("stage 3 with both offloads differs from stage 3 "
                  "resident", s3["losses"], res3["losses"])
    gap = max(abs(a - b) / abs(b) for a, b in zip(s3["losses"],
                                                 res["losses"]))
    assert gap <= STAGE_LOSS_RTOL and all(map(math.isfinite, s3["losses"]))
    lines.append(f"stage 3 both offloads = stage 3 resident bit for bit "
                 f"(losses and the final master); largest loss gap to "
                 f"stage 0 {gap:.3e} (limit {STAGE_LOSS_RTOL}); buffers on "
                 f"the card {numels}")
    del res3, s3
    on = leg("stage 2 tier nvme pipelined",
             offload_config(2, "nvme", buffer_count=3))
    st_on = on["engine"].swapper.stage_stats
    drop(on)
    off = leg("stage 2 tier nvme serial",
              offload_config(2, "nvme", pipeline_read=False,
                             pipeline_write=False))
    drop(off)
    assert on["losses"] == off["losses"] and torch.equal(
        on["master"], off["master"]), "nvme pipelined differs from serial"
    lines.append(f"stage 2 nvme pipelined = serial bit for bit; pipelined "
                 f"stream {st_on.get('stream_gbps')} GB/s, overlap "
                 f"{st_on.get('overlap_efficiency')}")
    del on, off

    # an nvme checkpoint (CKPT_LAYERS layers) resumed into a resident
    # stage-2 engine: the next steps equal the nvme engine's own
    ccfg = get_config("llama-1b", num_hidden_layers=CKPT_LAYERS)
    ckpt = os.path.join(OFFLOAD_DIR, "ckpt")
    nv = offload_run(ccfg, offload_config(2, "nvme"), batch, 1,
                     keep_master=False)
    t = time.perf_counter()
    nv["engine"].save_checkpoint(ckpt)
    save_s = time.perf_counter() - t
    cont = [float(nv["engine"].train_batch(batch=batch)) for _ in range(2)]
    nv["engine"]._settle_tier()
    want = nv["engine"].state.params.detach().cpu()
    drop(nv)
    rs = offload_run(ccfg, offload_config(2), batch, 0, keep_master=False)
    path, _ = rs["engine"].load_checkpoint(ckpt)
    again = [float(rs["engine"].train_batch(batch=batch)) for _ in range(2)]
    same = torch.equal(rs["engine"].state.params.detach().cpu(), want)
    drop(rs)
    shutil.rmtree(ckpt, ignore_errors=True)
    lines.append(f"nvme checkpoint of {CKPT_LAYERS} layers saved in "
                 f"{save_s:.1f} s, resumed into a resident stage-2 engine: "
                 f"losses {cont} then {again}, master bit-identical {same}")
    assert path is not None and again == cont and same, \
        "the resident engine resumed from the nvme checkpoint differs"
    log(f"[{smi}] offload (a) llama-1b, phase 9's config: " +
        " | ".join(lines))
    return launches


def pcie_rates(nbytes=1 << 30):
    """Page-locked copy rates (bytes/s) host to card and back, each alone
    and both at once (the two copy engines together)."""
    from deepspeed_tpu_torch.runtime.swap_tensor import host_buffer

    torch.cuda.synchronize()
    owners = []
    h1 = host_buffer(nbytes, torch.uint8, torch.device("cuda"),
                     owners=owners)
    h2 = host_buffer(nbytes, torch.uint8, torch.device("cuda"),
                     owners=owners)
    d1 = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    d2 = torch.empty(nbytes, dtype=torch.uint8, device="cuda")
    s1, s2 = torch.cuda.Stream(), torch.cuda.Stream()

    def timed(fns):
        for _ in range(2):
            for s, fn in fns:
                with torch.cuda.stream(s):
                    fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(3):
            for s, fn in fns:
                with torch.cuda.stream(s):
                    fn()
        torch.cuda.synchronize()
        return 3 * nbytes / (time.perf_counter() - t)

    h2d = (s1, lambda: d1.copy_(h1, non_blocking=True))
    d2h = (s2, lambda: h2.copy_(d2, non_blocking=True))
    out = dict(h2d=timed([h2d]), d2h=timed([d2h]), both=timed([h2d, d2h]))
    del d1, d2, owners
    torch.cuda.empty_cache()
    return out


def offload_bucket_check(engine, entries):
    """One bucket of the 8 B leg's tier through #4 on the card against
    ``adam_update_reference``, from page-locked staging, timed beside
    its byte bound and one ``torch.optim.AdamW(fused=True).step``."""
    from deepspeed_tpu_torch.ops import fused_adam as fo

    sw = engine.swapper
    sw.synchronize()
    a, b = max(sw.buckets, key=lambda r: r[1] - r[0])
    n = b - a
    before = fo.fused_adam.launches
    p = sw.p[a:b].to("cuda", non_blocking=True)
    m = sw.m[a:b].to("cuda", non_blocking=True)
    v = sw.v[a:b].to("cuda", non_blocking=True)
    g = engine._grad[a:b]
    w = torch.empty(n, dtype=torch.bfloat16, device="cuda")
    sc = engine._sc.clone()
    opt = engine.opt
    kw = dict(b1=opt.b1, b2=opt.b2, eps=opt.eps, wd=opt.wd,
              adam_w=opt.adam_w)
    ref = [t.clone() for t in (p, m, v, w)]
    fo.fused_adam(p, g, m, v, sc, w, **kw)
    fo.adam_update_reference(ref[0], g, ref[1], ref[2], sc, ref[3], **kw)
    torch.cuda.synchronize()
    err = 0.0
    for x, y in zip((p, m, v), ref[:3]):
        d = (x - y).abs()
        assert (d <= OPT_ATOL + OPT_RTOL * y.abs()).all(), (
            f"offload bucket: #4 differs from plain by {d.max().item():.3e}")
        err = max(err, d.max().item())
    assert torch.equal(w, p.to(torch.bfloat16))
    ms = time_ms(lambda: fo.fused_adam(p, g, m, v, sc, w, **kw), reps=10,
                 warmup=2)
    plain_ms = time_ms(lambda: fo.adam_update_reference(
        ref[0], g, ref[1], ref[2], sc, ref[3], **kw), reps=3, warmup=1)
    param = torch.nn.Parameter(p.clone())
    param.grad = g.clone()
    topt = torch.optim.AdamW([param], lr=1e-4, betas=(opt.b1, opt.b2),
                             weight_decay=opt.wd, fused=True)
    lib_ms = time_ms(topt.step, reps=10, warmup=2)
    bound = n * (16 + 12 + 2) / PEAK_BYTES * 1e3
    fo.fused_adam.launches = before      # the comparison is not the path
    del p, m, v, w, ref, param, topt
    torch.cuda.empty_cache()
    entries.append(dict(
        name="fused_adam_offload_bucket", route="cuda",
        source="deepspeed_tpu_torch/ops/csrc/fused_adam.cu",
        replaces="deepspeed_tpu/ops/fused_adam.py:52", launches=0,
        max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound,
        bound_by="bytes", library_ms=lib_ms))
    return n


def offload_8b(smi, entries):
    """Phase 27(b): ``llama3-8b`` at full width on one card, ZeRO stage 2
    at one NCCL rank with its optimizer state in page-locked host RAM
    (tier cpu), bf16 compute, fused AdamW, full remat, 1 x 2048 tokens a
    step; the depth is the most that the host's RAM holds with 16 GiB to
    spare."""
    import shutil

    from deepspeed_tpu_torch.models.llama import LlamaLMLoss, get_config
    from deepspeed_tpu_torch.ops import flash_attention as fa
    from deepspeed_tpu_torch.ops import fused_adam as fo

    mem = meminfo()
    os.makedirs(OFFLOAD_DIR, exist_ok=True)
    disk = shutil.disk_usage(OFFLOAD_DIR)
    log(f"[{smi}] offload preflight: MemTotal {mem['MemTotal'] / 2**30:.1f} "
        f"GiB, MemAvailable {mem['MemAvailable'] / 2**30:.1f} GiB; "
        f"{disk.free / 2**30:.1f} GiB free of {disk.total / 2**30:.1f} GiB "
        f"under {OFFLOAD_DIR}")
    full = get_config("llama3-8b")
    with torch.device("meta"):
        one = sum(p.numel() for p in LlamaLMLoss(get_config(
            "llama3-8b", num_hidden_layers=1)).parameters())
        two = sum(p.numel() for p in LlamaLMLoss(get_config(
            "llama3-8b", num_hidden_layers=2)).parameters())
    per_layer, rest = two - one, 2 * one - two
    budget = mem["MemAvailable"] - HOST_SPARE
    L = min(full.num_hidden_layers, int((budget / 12 - rest) // per_layer))
    assert L >= 1, f"the host cannot hold one layer's state: {mem}"
    n_params = rest + L * per_layer
    cut = ("full depth" if L == full.num_hidden_layers else
           f"DEPTH CUT to {L} of {full.num_hidden_layers} layers: "
           f"{12 * (rest + full.num_hidden_layers * per_layer) / 2**30:.1f} "
           f"GiB of master and moments at full depth, the host holds "
           f"{budget / 2**30:.1f} GiB with {HOST_SPARE >> 30} GiB spare")
    log(f"[{smi}] offload (b) llama3-8b at {L} layers, {n_params} "
        f"parameters ({cut})")
    cfg = get_config("llama3-8b", num_hidden_layers=L)
    batch = np.random.default_rng(SEED).integers(0, cfg.vocab_size,
                                                 size=(1, 2048))
    rates = pcie_rates()
    config = offload_config(2, "cpu", micro=1, gas=1)
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                fo.fused_adam)
    for c in counters:                    # the main path's run starts here
        c.launches = 0
    r = offload_run(cfg, config, batch, 1 + OFFLOAD_STEPS,
                    keep_master=False)
    launched = {c.__name__: c.launches for c in counters}
    eng = r["engine"]
    sw = eng.swapper
    nb = len(sw.buckets)
    assert launched["fused_adam"] == (1 + OFFLOAD_STEPS) * nb, (launched, nb)
    assert all(map(math.isfinite, r["losses"])), r["losses"]
    step = float(np.median(r["step_s"][1:]))
    stream = 12 * sw.numel                # each way
    bound = stream / min(rates["both"], rates["h2d"], rates["d2h"])
    n_bucket = offload_bucket_check(eng, entries)
    entries[-1]["launches"] = launched["fused_adam"]
    log(f"[{smi}] offload (b) llama3-8b x {L} layers, stage 2 tier cpu, "
        f"1 x 2048 tokens a step: losses (warm-up, then {OFFLOAD_STEPS}) "
        f"{[round(x, 4) for x in r['losses']]}; step s "
        f"{[round(x, 3) for x in r['step_s']]} (median after the warm-up "
        f"{step:.3f}); peak card {r['peak']:.2f} GiB; host "
        f"{sw.host_bytes / 2**30:.2f} GiB page-locked in "
        f"{sw.pin_seconds:.1f} s (engine init {r['init_s']:.1f} s); "
        f"PCIe page-locked rates h2d {rates['h2d'] / 1e9:.2f} GB/s, d2h "
        f"{rates['d2h'] / 1e9:.2f} GB/s, both at once "
        f"{rates['both'] / 1e9:.2f} GB/s each way; the stream moves "
        f"{stream / 1e9:.2f} GB each way a step, bound {bound:.3f} s, step "
        f"at {bound / step:.1%} of it; {nb} buckets a step (the largest "
        f"{n_bucket} elements), #4 launched {launched['fused_adam']} times "
        f"in {1 + OFFLOAD_STEPS} steps; flash launches {launched}; tier "
        f"stages {sw.stage_stats}; card buffers {eng.buffer_numels()}")
    drop(r)
    return launched


def offload_stream(smi):
    """Phase 27(c): ``llama3-8b`` at full size served through
    ``NvmeWeightStreamingEngine``, 4 x 128 prompt tokens + 8 new, bf16,
    against v1's greedy tokens on the same weights (drawn from one
    seed)."""
    import shutil

    from deepspeed_tpu_torch.inference.engine import init_inference
    from deepspeed_tpu_torch.inference.zero_inference import \
        NvmeWeightStreamingEngine
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.ops import flash_attention as fa

    cfg = get_config("llama3-8b")
    prompts = np.random.default_rng(SEED + 27).integers(
        0, cfg.vocab_size, size=(4, 128))
    new = 8
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    v1 = init_inference(model, dtype="bfloat16", max_out_tokens=256,
                        generator=torch.Generator(device="cuda").manual_seed(
                            SEED + 27))
    want = v1.generate(prompts, max_new_tokens=new)
    tree = sum(p.numel() * p.element_size() for n, p in
               v1.module.named_parameters() if ".layers." not in n)
    del v1, model
    gc.collect()
    torch.cuda.empty_cache()
    wdir = os.path.join(OFFLOAD_DIR, "weights")
    shutil.rmtree(wdir, ignore_errors=True)
    fa.flash_fwd.launches = 0             # the main path's run starts here
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    torch.cuda.reset_peak_memory_stats()
    eng = NvmeWeightStreamingEngine(
        model, None, wdir, max_batch_size=4, max_out_tokens=256,
        dtype=torch.bfloat16,
        generator=torch.Generator(device="cuda").manual_seed(SEED + 27))
    layer = eng.store.layer_bytes
    # the read rate of one sweep alone, two layer reads in flight as in
    # the engine (the files were just written: a warm page-cache read)
    ops = []
    t = time.perf_counter()
    for i in range(cfg.num_hidden_layers):
        if len(ops) == 2:
            eng.store.handle.wait(ops.pop(0))
        ops.append(eng.store.start_read(i, eng._hbuf[i % 2]))
    for op in ops:
        eng.store.handle.wait(op)
    read_rate = cfg.num_hidden_layers * layer / (time.perf_counter() - t)
    torch.cuda.synchronize()
    t = time.perf_counter()
    got = eng.generate(prompts, max_new_tokens=new)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t
    launches = fa.flash_fwd.launches
    assert launches == cfg.num_hidden_layers, launches    # one prefill
    st = dict(eng.stats)
    resident = eng.resident_bytes()
    peak = torch.cuda.max_memory_allocated() / 2**30
    assert resident <= tree + 2 * layer, (resident, tree, layer)
    same = torch.equal(got, want)
    tokens = 4 * new
    bound_s = st["bytes_read"] / read_rate
    log(f"[{smi}] offload (c) llama3-8b at full size through "
        f"NvmeWeightStreamingEngine (4 x 128 + {new}, bf16): tokens equal "
        f"to v1's {same}; {eng.store.bytes_written / 1e9:.2f} GB of layers "
        f"written in {eng.write_seconds:.1f} s (drawn module by module); "
        f"resident {resident / 1e9:.3f} GB (tree {tree / 1e9:.3f} GB + 2 x "
        f"{layer / 1e6:.1f} MB layer slots), peak card {peak:.2f} GiB; "
        f"{st['sweeps']} sweeps read {st['bytes_read'] / 1e9:.2f} GB from "
        f"NVMe in {gen_s:.2f} s (read waits {st['read_wait_s']:.2f} s): "
        f"{tokens / gen_s:.2f} new tokens/s against a read bound of "
        f"{tokens / bound_s:.2f}, {bound_s / gen_s:.1%} of it (a sweep "
        f"alone reads {read_rate / 1e9:.2f} GB/s, warm page cache); #1 "
        f"{launches} launches (one prefill)")
    assert same, (got, want)
    eng.close()
    del eng, model
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(wdir, ignore_errors=True)
    return launches


def phase_offload():
    """Phase 27: ZeRO-Offload and ZeRO-Infinity (A11).  Returns the
    kernels-line entry of #4 over an offload bucket (with its launches in
    the 8 B leg) and #1's launches in the streamed prefill."""
    import shutil

    from deepspeed_tpu_torch import comm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    t_phase = time.perf_counter()
    comm.init_distributed(dist_backend="nccl")
    entries = []
    try:
        n1b = offload_1b(smi)
        log(f"[{smi}] phase 27 (a) done at "
            f"{time.perf_counter() - t_phase:.1f} s, #4 launched {n1b} "
            "times over the tiers' buckets")
        offload_8b(smi, entries)
        log(f"[{smi}] phase 27 (b) done at "
            f"{time.perf_counter() - t_phase:.1f} s")
    finally:
        comm.destroy_process_group()
    flash = offload_stream(smi)
    shutil.rmtree(OFFLOAD_DIR, ignore_errors=True)
    log(f"[{smi}] phase 27: {time.perf_counter() - t_phase:.1f} s")
    return entries[0], flash


def main() -> int:
    # ``--cpu-side NAMES``: the worker of the parity checks' CPU halves,
    # which the whole run and ``--wq-only`` start themselves; it sees no
    # card
    if sys.argv[1:2] == ["--cpu-side"] and len(sys.argv) == 3:
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        return cpu_side_worker(sys.argv[2].split(","))
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deepspeed_tpu_torch  # noqa: F401  (fails outside the repository)

    # ``--gpt2-only``: the build and phases 15-18 alone, for work on the
    # GPT-2 path; it prints no result lines
    if sys.argv[1:] == ["--gpt2-only"]:
        t0 = time.perf_counter()
        phase_report()
        gpt2_phases(t0)
        log(f"gpt2 phases done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--tiering-only``: the build and phase 19 alone, for work on the KV
    # tiers and the prefix cache; it prints no result lines
    if sys.argv[1:] == ["--tiering-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_tiering()
        log(f"phase 19 done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--spec-only``: the build and phase 20 alone, for work on
    # speculative decoding; it prints no result lines
    if sys.argv[1:] == ["--spec-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_spec()
        log(f"phase 20 done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--wq-only``: the build and phase 22 alone, for work on the weight
    # formats; it prints no result lines
    if sys.argv[1:] == ["--wq-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_wq(CPUSide(WQ_FORMATS), {})
        log(f"phase 22 done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--lc-only``: the build, phase 5's carry cases and phase 21 alone,
    # for work on long context; it prints no result lines
    if sys.argv[1:] == ["--lc-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_carry_kernels()
        log(f"phase 5 (carry) done at {time.perf_counter() - t0:.1f} s")
        phase_lc()
        log(f"phase 21 done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--moe-only``: the build and phases 24 and 25 alone, for work on
    # sparse MoE serving; it prints no result lines
    if sys.argv[1:] == ["--moe-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_moe()
        log(f"phase 24 done at {time.perf_counter() - t0:.1f} s")
        phase_moe_quant()
        log(f"phase 25 done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--tuning-only``: the build and phase 26 alone, for work on the
    # autotuner and the control plane; it prints no result lines
    if sys.argv[1:] == ["--tuning-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_tuning()
        log(f"phase 26 done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--offload-only``: the build and phase 27 alone, for work on the
    # offload tiers and NVMe weight streaming; it prints no result lines
    if sys.argv[1:] == ["--offload-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_offload()
        log(f"phase 27 done at {time.perf_counter() - t0:.1f} s")
        return 0
    # ``--disagg-only``: the build and phase 23 alone, for work on
    # disaggregated serving; it prints no result lines
    if sys.argv[1:] == ["--disagg-only"]:
        t0 = time.perf_counter()
        phase_report()
        phase_disagg()
        log(f"phase 23 done at {time.perf_counter() - t0:.1f} s")
        return 0
    t0 = time.perf_counter()
    phase_report()
    entry = phase_kernel()
    log(f"phase 2 done at {time.perf_counter() - t0:.1f} s")
    entry["launches"], bf16_greedy, v1_eager = phase_slice()
    log(f"phase 3 done at {time.perf_counter() - t0:.1f} s")
    cfg2, state = phase_cpu_parity()
    log(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    paged, paged_quant = phase_paged_kernels()
    carry, carry_quant = phase_carry_kernels()
    log(f"phase 5 done at {time.perf_counter() - t0:.1f} s")
    (paged["launches"], paged_quant["launches"], bf16_outs,
     v2_eager) = phase_v2()
    log(f"phase 6 done at {time.perf_counter() - t0:.1f} s")
    phase_v2_cpu_parity(cfg2, state)
    log(f"phase 7 done at {time.perf_counter() - t0:.1f} s")
    del state
    gc.collect()
    train = phase_train_kernels()
    log(f"phase 8 done at {time.perf_counter() - t0:.1f} s")
    launches, stage0 = phase_train()
    for name, e in train.items():
        e["launches"] = launches[name]
    log(f"phase 9 done at {time.perf_counter() - t0:.1f} s")
    phase_train_cpu_parity()
    log(f"phase 10 done at {time.perf_counter() - t0:.1f} s")
    quant = phase_quant_kernels()
    log(f"phase 11 done at {time.perf_counter() - t0:.1f} s")
    # phase 12(c)'s and phase 22's parity checks: their CPU halves run in
    # a worker from here on, beside the card's phases
    cpu_side = CPUSide(PARITY_JOBS)
    int8_v1 = phase_int8_v1(bf16_greedy)
    int8_v2, int8_outs, int8_eager = phase_int8_v2(bf16_outs)
    for gs, launches in ((128, int8_v1), (2048, int8_v2)):
        quant[f"quantize_int8_g{gs}"]["launches"] = launches[0]
        quant[f"dequantize_int8_g{gs}"]["launches"] = launches[1]
    card_halves = {"int8": phase_int8_cpu_parity()}
    log(f"phase 12 done at {time.perf_counter() - t0:.1f} s")
    phase_zero(stage0)
    log(f"phase 13 done at {time.perf_counter() - t0:.1f} s")
    phase_graphs(bf16_outs, v2_eager, int8_outs, int8_eager, bf16_greedy,
                 v1_eager)
    log(f"phase 14 done at {time.perf_counter() - t0:.1f} s")
    gpt2 = gpt2_phases(t0)
    phase_tiering()
    log(f"phase 19 done at {time.perf_counter() - t0:.1f} s")
    # phase 20's speculative launches join #9's and #8's entries
    spec = phase_spec()
    paged["launches"] += spec[0]
    paged_quant["launches"] += spec[1]
    log(f"phase 20 done at {time.perf_counter() - t0:.1f} s")
    # the carry rows: #9 and #8 in phase 21's long-context runs
    carry["launches"], carry_quant["launches"] = phase_lc()
    log(f"phase 21 done at {time.perf_counter() - t0:.1f} s")
    # phase 23's router legs join #9's entry
    paged["launches"] += phase_disagg()
    log(f"phase 23 done at {time.perf_counter() - t0:.1f} s")
    wq = phase_wq(cpu_side, card_halves, bf16_outs)
    log(f"phase 22 done at {time.perf_counter() - t0:.1f} s")
    # phase 24's v1 prefills join #1's entry
    moe9, moe8, moe_flash = phase_moe()
    entry["launches"] += moe_flash
    log(f"phase 24 done at {time.perf_counter() - t0:.1f} s")
    # phase 25's v1 prefills join #1's entry too
    banks, moe_flash = phase_moe_quant()
    entry["launches"] += moe_flash
    log(f"phase 25 done at {time.perf_counter() - t0:.1f} s")
    # phase 26's autotuner points join GPT-2's config-1 training entries,
    # its controller runs #9's and #8's
    tuned, (tuned9, tuned8) = phase_tuning()
    paged["launches"] += tuned9
    paged_quant["launches"] += tuned8
    by_name = {e["name"]: e for e in gpt2}
    for kname, n in tuned.items():
        by_name[f"{kname}_gpt2_125m" + ("" if kname == "fused_adam"
                                        else "_train")]["launches"] += n
    log(f"phase 26 done at {time.perf_counter() - t0:.1f} s")
    # phase 27's streamed prefill joins #1's entry; #4 over an offload
    # bucket is its own entry, with the 8 B leg's launches
    offload_adam, flash = phase_offload()
    entry["launches"] += flash
    log(f"phase 27 done at {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [entry, paged, paged_quant, carry,
                                carry_quant, moe9, moe8] + banks +
                    [train[k] for k in ("flash_bwd_dq", "flash_bwd_dkv",
                                        "fused_adam", "fused_lion")] +
                    [offload_adam] +
                    [quant[f"{op}_int8_g{gs}"] for gs in (128, 2048)
                     for op in ("quantize", "dequantize")] + gpt2 + wq}))
    log(f"chip_smoke: all phases done in {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def gpt2_phases(t0):
    """Phases 15-18; returns their kernel-line entries with the launches
    of phases 16 and 17's main-path runs."""
    entries = phase_gpt2_kernels()
    log(f"phase 15 done at {time.perf_counter() - t0:.1f} s")
    fwd_launches, (q_launches, dq_launches) = phase_gpt2_serve()
    entries["flash_fwd_gpt2_125m_prefill"]["launches"] = fwd_launches
    for name in ("c_fc", "wte"):
        entries[f"quantize_int8_g128_gpt2_{name}"]["launches"] = q_launches
        entries[f"dequantize_int8_g128_gpt2_{name}"]["launches"] = \
            dq_launches
    log(f"phase 16 done at {time.perf_counter() - t0:.1f} s")
    launches = phase_gpt2_train()
    for shape, counts in launches.items():
        for kname in ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"):
            entries[f"{kname}_{shape}"]["launches"] = counts[kname]
    entries["fused_adam_gpt2_125m"]["launches"] = \
        launches["gpt2_125m_train"]["fused_adam"]
    entries["fused_adam_gpt2_1.3b"]["launches"] = \
        launches["gpt2_1.3b_train"]["fused_adam"]
    log(f"phase 17 done at {time.perf_counter() - t0:.1f} s")
    phase_gpt2_cpu_parity()
    log(f"phase 18 done at {time.perf_counter() - t0:.1f} s")
    return list(entries.values())


if __name__ == "__main__":
    try:
        sys.exit(main())
    finally:
        for worker in CPU_SIDES:
            worker.close()
