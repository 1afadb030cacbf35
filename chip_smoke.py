#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failed check raises; nothing is caught):

1. Report: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build every kernel of the paths from ``ops/csrc`` (one
   ``nvcc`` per source, all started together) and print the build
   seconds and ``ptxas -v``.
2. Kernel against plain: the flash-attention forward kernel against its
   plain PyTorch version on the card, in bf16 at the serving shape and
   three more, plus an fp32 case; ``o`` and ``lse`` both compared.  Times
   the kernel, the plain version and, as a yardstick the port never
   calls, ``scaled_dot_product_attention``.
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
   the v2 path's shapes (decode, mixed decode + prefill chunk, sliding
   window, page-table holes, D=64) and an fp32 case; times the kernels,
   the plain versions and the bound at the decode and mixed shapes.
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

The line before the last is the ``kernels`` JSON; the last line is
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


def attention_bound(B, H, Hkv, S, Sk, D, causal, dtype):
    """Least time (ms) the card could take, and what bounds it: the q-k
    pairs these inputs need, 4*D operations each, at the peak rate of
    their type; each input read once and each output written once."""
    if causal:
        pairs = int(np.clip(np.arange(S) + (Sk - S) + 1, 0, Sk).sum())
    else:
        pairs = S * Sk
    ops = 4 * B * H * D * pairs
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
    built = builder.build_all(["flash_fwd", "ragged_paged_attn"])
    log(f"build: {time.perf_counter() - t0:.1f} s for {sorted(built)}")
    for name, b in built.items():
        log(f"[{name}] nvcc {b.seconds:.1f} s\n{b.log.strip()}")
    return smi


def _qkv(gen, B, H, Hkv, S, Sk, D, dtype):
    # the layout the model hands the kernel: [B, S, heads, D] projections
    # seen as [B, heads, S, D]
    def make(n, s):
        return torch.randn(B, s, n, D, generator=gen, device="cuda",
                           dtype=dtype).transpose(1, 2)

    return make(H, S), make(Hkv, Sk), make(Hkv, Sk)


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
        ("fp32", 1, 8, 2, 300, 300, 128, True, f32),
    ]
    entry = None
    for i, (name, B, H, Hkv, S, Sk, D, causal, dtype) in enumerate(shapes):
        gen = torch.Generator(device="cuda").manual_seed(SEED + i)
        q, k, v = _qkv(gen, B, H, Hkv, S, Sk, D, dtype)
        o, lse = flash_fwd(q, k, v, causal=causal)
        ro, rlse = flash_fwd_reference(q, k, v, causal=causal)
        torch.cuda.synchronize()
        of, rof = o.float(), ro.float()
        err = (of - rof).abs()
        atol, rtol = (BF16_ATOL, BF16_RTOL) if dtype == bf16 \
            else (FP32_ATOL, FP32_ATOL)
        assert torch.isfinite(of).all(), f"{name}: non-finite output"
        assert (err <= atol + rtol * rof.abs()).all(), (
            f"{name}: o differs from plain by up to {err.max().item():.3e}")
        inf = torch.isinf(rlse)
        assert torch.equal(torch.isinf(lse), inf), f"{name}: lse inf rows"
        lerr = (lse - rlse)[~inf].abs()
        assert (lerr <= LSE_ATOL + LSE_RTOL * rlse[~inf].abs()).all(), (
            f"{name}: lse differs by up to {lerr.max().item():.3e}")
        if causal and Sk < S:   # rows before the diagonal see no key
            blind = S - Sk
            assert inf[:, :, :blind].all() and not inf[:, :, blind:].any()
            assert (of[:, :, :blind] == 0).all()
        ms = time_ms(lambda: flash_fwd(q, k, v, causal=causal))
        # SDPA's causal mask is top-left aligned, so it computes the same
        # function only when S == Sk
        lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)) \
            if (not causal or S == Sk) else None
        bound, by = attention_bound(B, H, Hkv, S, Sk, D, causal, dtype)
        log(f"flash_fwd[{name}] B={B} H={H} Hkv={Hkv} S={S} Sk={Sk} D={D} "
            f"causal={causal} {dtype}: max|o-plain|={err.max().item():.3e} "
            f"max|lse-plain|={lerr.max().item():.3e} kernel {ms:.4f} ms, "
            f"sdpa {lib_ms if lib_ms is None else round(lib_ms, 4)} ms, "
            f"bound {bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
        if name == "serving":
            plain_ms = time_ms(
                lambda: flash_fwd_reference(q, k, v, causal=causal),
                reps=3, warmup=1)
            log(f"flash_fwd[serving] plain {plain_ms:.3f} ms")
            entry = dict(name="flash_fwd", route="cuda",
                         source="deepspeed_tpu_torch/ops/csrc/flash_fwd.cu",
                         replaces="deepspeed_tpu/ops/flash_attention.py:225",
                         launches=0, max_abs_err=err.max().item(), ms=ms,
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
    return launches


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
        if timed:
            ms = time_ms(lambda: fn(*args, sm_scale=sm))
            plain_ms = time_ms(lambda: ref(*args, sm_scale=sm), reps=3,
                               warmup=1)
            bound, by = paged_bound(q_lens, kv_lens, meta[1].cpu(),
                                    q.shape[1], pages.shape[2] // 2,
                                    q.shape[2], pages.shape[1], q.dtype, pd)
            line += (f" kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                     f"{bound:.4f} ms ({by}), {bound / ms:.1%} of bound")
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
    return launches, quant_launches


# ---------------------------------------------------------------------------
# Phase 7: v2 on the card against v2 on the CPU
# ---------------------------------------------------------------------------

def phase_v2_cpu_parity(cfg, state):
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM

    rng = np.random.default_rng(SEED + 1)
    prompts = [rng.integers(0, cfg.vocab_size, size=n)
               for n in (37, 100, 300, 513)]
    kw = dict(max_seqs=4, max_seq_len=640, prefill_chunk=128, page_size=64,
              decode_block_size=4)
    for fmt in ("none", "int8"):
        toks, engines = {}, {}
        for dev in ("cuda", "cpu"):
            with torch.device("meta"):
                model = LlamaForCausalLM(cfg)
            eng = RaggedInferenceEngineV2(model, params=state, device=dev,
                                          kv_cache_dtype=fmt, **kw)
            outs = eng.generate_all(prompts, max_new_tokens=16)
            toks[dev] = [outs[u] for u in sorted(outs)]
            eng.audit_kv_sharing()
            engines[dev] = eng
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
                log(f"v2 parity {fmt}: prompt {len(p)}: first differing "
                    f"token {i}, CPU top-2 margin {margins[i]:.3e}")
                assert margins[i] < MARGIN, (
                    f"card and CPU tokens differ at {i} with margin "
                    f"{margins[i]:.3e}")
        same = sum(np.array_equal(a, b)
                   for a, b in zip(toks["cuda"], toks["cpu"]))
        log(f"v2 parity, 2 layers fp32, {fmt} pool: {same}/4 requests "
            f"token-equal card vs CPU; smallest CPU top-2 margin "
            f"{worst:.3e}")
        del cpu_model
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
    entry["launches"] = phase_slice()
    log(f"phase 3 done at {time.perf_counter() - t0:.1f} s")
    cfg2, state = phase_cpu_parity()
    log(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    paged, paged_quant = phase_paged_kernels()
    log(f"phase 5 done at {time.perf_counter() - t0:.1f} s")
    paged["launches"], paged_quant["launches"] = phase_v2()
    log(f"phase 6 done at {time.perf_counter() - t0:.1f} s")
    phase_v2_cpu_parity(cfg2, state)
    log(f"phase 7 done at {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [entry, paged, paged_quant]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
