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
   sliding window, page-table holes, D=64) and an fp32 case; two decode
   calls bit-identical.  Times the kernels on the device (20 calls in a
   CUDA graph, replayed) beside the wrapper's host loop and the bound at
   the four decode and mixed shapes, and the plain versions at decode
   and mixed.
6. The v2 slice: ``RaggedInferenceEngineV2`` on ``llama3-8b`` at full
   width and depth, bf16, serving 24 requests (16 slots) twice with
   identical tokens; the paged kernel launched once per layer per model
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
   runs'.  (c) 2 layers at full width in fp32: weights quantized on the
   card and on the CPU are byte-identical, and 4 greedy v2 requests give
   the same tokens (the margin rule of phase 7).

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
   a world of one's too: none is a local copy.  Then the stage-3
   engine's partitioned checkpoint at full depth
   (``build/smoke_zero_ckpt``, removed afterwards): save, 2 more steps,
   and a fresh engine that loads and retakes them, bit-identically.

Phases 3 and 6 (serving) keep their full depth: the whole run stays well
inside its time limit.  The line before the last is the ``kernels`` JSON;
the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA GPU it exits nonzero
and prints no result.
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
                               "flash_bwd", "fused_adam", "quantization"])
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
    return smi


def check_no_spill(built, name, kernels, count):
    """The ``count`` kernels of library ``name`` whose names contain one
    of ``kernels``, from ``ptxas -v``: no warning (the source's flags make
    a spill or local memory one), no stack, no spill."""
    from deepspeed_tpu_torch.ops import builder

    if not built.log:           # built before this run: build it again
        built.path.unlink()
        built = builder.build_all([name])[name]
    lines = built.log.splitlines()
    bad = [ln for ln in lines
           if "warning" in ln and any(k in ln for k in kernels)]
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
    return launches, greedy1


def flax_tree(cfg, rng):
    """A random flax-layout Llama param tree (unrolled layers) in numpy."""
    E, I, V = cfg.hidden_size, cfg.intermediate_size, cfg.vocab_size
    H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                  cfg.head_dim)

    def dense(n_in, n_out):
        w = rng.standard_normal((n_in, n_out), dtype=np.float32)
        return {"kernel": w * np.float32(1 / math.sqrt(n_in))}

    def norm():
        return {"scale": 1 + 0.1 * rng.standard_normal(E, dtype=np.float32)}

    model = {"embed_tokens": {
        "embedding": rng.standard_normal((V, E), dtype=np.float32)},
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
               pad=0):
    """q, a pool of just the pages the sequences use (plus the trash page
    0, in a shuffled order), fp32 scales for 1-byte pages, and the tick's
    metadata, on the card.  K and V are standard normal; 1-byte pages hold
    them as the pool's own write quantizes them (scale = row absmax /
    qmax), so every page type dequantizes to values of the same size.
    ``holes`` marks every other page before a sequence's first query
    token -1; ``pad`` adds padding tokens."""
    from deepspeed_tpu_torch.inference.paged import PagedKVPool

    g = torch.Generator().manual_seed(seed)
    S = len(q_lens)
    cols = [-(-kv // page) for kv in kv_lens]
    n_pages = 1 + sum(cols)
    ids = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    table = torch.full((S, max(cols)), -1, dtype=torch.int32)
    for j, c in enumerate(cols):
        table[j, :c] = torch.tensor(ids[:c], dtype=torch.int32)
        ids = ids[c:]
        if holes:
            table[j, 1:(kv_lens[j] - q_lens[j]) // page:2] = -1
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
                window=None):
    """Least time (ms) the card could take for one ragged paged attention
    call, and what bounds it.  Bytes: q and o once, every page a sequence
    attends (pages with a key in its window, holes excluded) once, with
    its scale rows for 1-byte pages.  Operations: 4*D per valid (query
    head, key) pair, at the bf16 tensor-core rate for bf16 queries and
    the fp32 rate for fp32 ones."""
    qe = torch.finfo(qdtype).bits // 8
    pe = 1 if pdtype in (torch.int8, torch.float8_e4m3fn) else \
        torch.finfo(pdtype).bits // 8
    row = 2 * Hkv * (D * pe + (4 if pe == 1 else 0))
    nbytes = 2 * sum(q_lens) * H * D * qe
    pairs = 0
    for j, (n, kv) in enumerate(zip(q_lens, kv_lens)):
        qpos = np.arange(kv - n, kv)
        lo = np.maximum(0, qpos - window + 1) if window else np.zeros_like(
            qpos)
        pairs += int((qpos + 1 - lo).sum()) * H
        first = int(lo.min()) // page
        cols = [c for c in range(first, -(-kv // page))
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
               {"D": 64, "H": 16, "Hkv": 4}, False)]
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
            if name in ("decode", "mixed"):
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
# Phase 6: the v2 slice at full width and depth
# ---------------------------------------------------------------------------

V2 = dict(max_seqs=16, max_seq_len=2048, prefill_chunk=512, page_size=64,
          decode_block_size=8)


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
    wall time, prompt and decode-block tokens)."""
    uids = [engine.put_request(p, **kw) for p, kw in reqs]
    st = engine.host_stats
    fused_s = block_s = 0.0
    block_tokens = 0
    outs = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    while engine.has_work():
        ticks = st.ticks
        t = time.perf_counter()
        produced = engine.step()
        dt = time.perf_counter() - t
        if st.ticks - ticks == engine.decode_block_size > 1:
            block_s += dt
            block_tokens += produced
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
    engine.audit_kv_sharing()
    assert engine.allocator.free_pages == engine.num_pages - 1, \
        "pages still held after the run"
    return [outs[u] for u in uids], dict(
        wall_s=wall, fused_s=fused_s, block_s=block_s,
        block_tokens=block_tokens,
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
    return launches, quant_launches, out1


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
        lib_ms = None
        if opt == "adamw":
            param = torch.nn.Parameter(p.clone())
            param.grad = g
            topt = torch.optim.AdamW([param], lr=3e-4, betas=(0.9, 0.95),
                                     weight_decay=0.1, fused=True)
            lib_ms = time_ms(topt.step, reps=10, warmup=2)
            del param, topt
        log(f"{opt} over {n} fp32 parameters (+ bf16 copy): max|kernel-"
            f"plain|={err:.3e}; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms,"
            f" bound {bound:.3f} ms (bytes), {bound / ms:.1%} of bound"
            + (f"; torch AdamW(fused=True).step {lib_ms:.3f} ms"
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
    outs, ticks = [], 0
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
    return launches


def phase_int8_cpu_parity():
    from deepspeed_tpu_torch.models.llama import get_config
    from deepspeed_tpu_torch.module_inject.flax_bridge import \
        flax_to_state_dict

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("llama3-8b", num_hidden_layers=2, dtype=torch.float32)
    state = flax_to_state_dict(flax_tree(cfg, np.random.default_rng(SEED + 4)))
    phase_v2_cpu_parity(cfg, state, runs=(("none", "int8"),))
    del state
    gc.collect()
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 13: ZeRO stages 1-3 over NCCL at full width and depth
# ---------------------------------------------------------------------------

STAGE_LOSS_RTOL = 2e-3   # the reference's tests/unit/test_engine.py:55


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
    against phase 9's stage-0 losses; the stage-3 engine's partitioned
    checkpoint resumes bit-identically."""
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
        if stage < 3:
            del engine, model

    # the stage-3 engine's partitioned checkpoint, at full depth
    ckpt = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                        "smoke_zero_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    t = time.perf_counter()
    engine.save_checkpoint(ckpt)
    save_s = time.perf_counter() - t
    cont = [float(engine.train_batch(batch=batch)) for _ in range(2)]
    want_p = engine.state.params.clone()
    del engine, model
    fresh, model, _, _, _, _ = zero_run(cfg, conf, batch, 0)
    t = time.perf_counter()
    path, _ = fresh.load_checkpoint(ckpt)
    load_s = time.perf_counter() - t
    again = [float(fresh.train_batch(batch=batch)) for _ in range(2)]
    same = torch.equal(fresh.state.params, want_p)
    size = sum(os.path.getsize(os.path.join(d, f))
               for d, _, fs in os.walk(ckpt) for f in fs) / 2**30
    log(f"zero: stage-3 checkpoint of {cfg.num_hidden_layers} layers "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA GPU available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import deepspeed_tpu_torch  # noqa: F401  (fails outside the repository)

    t0 = time.perf_counter()
    phase_report()
    entry = phase_kernel()
    log(f"phase 2 done at {time.perf_counter() - t0:.1f} s")
    entry["launches"], bf16_greedy = phase_slice()
    log(f"phase 3 done at {time.perf_counter() - t0:.1f} s")
    cfg2, state = phase_cpu_parity()
    log(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    paged, paged_quant = phase_paged_kernels()
    log(f"phase 5 done at {time.perf_counter() - t0:.1f} s")
    paged["launches"], paged_quant["launches"], bf16_outs = phase_v2()
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
    for gs, launches in ((128, phase_int8_v1(bf16_greedy)),
                         (2048, phase_int8_v2(bf16_outs))):
        quant[f"quantize_int8_g{gs}"]["launches"] = launches[0]
        quant[f"dequantize_int8_g{gs}"]["launches"] = launches[1]
    phase_int8_cpu_parity()
    log(f"phase 12 done at {time.perf_counter() - t0:.1f} s")
    phase_zero(stage0)
    log(f"phase 13 done at {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [entry, paged, paged_quant] +
                    [train[k] for k in ("flash_bwd_dq", "flash_bwd_dkv",
                                        "fused_adam", "fused_lion")] +
                    [quant[f"{op}_int8_g{gs}"] for gs in (128, 2048)
                     for op in ("quantize", "dequantize")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
