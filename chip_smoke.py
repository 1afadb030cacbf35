#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``deepspeed_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the repository root

Phases (any failed check raises; nothing is caught):

1. Report: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions; build every kernel of the path from ``ops/csrc`` and print
   the build seconds and ``ptxas -v``.
2. Kernel against plain: the flash-attention forward kernel against its
   plain PyTorch version on the card, in bf16 at the serving shape and
   three more, plus an fp32 case; ``o`` and ``lse`` both compared.  Times
   the kernel, the plain version and, as a yardstick the port never
   calls, ``scaled_dot_product_attention``.
3. The slice: ``init_inference`` on ``llama3-8b`` at full width and depth,
   bf16, random seeded weights made on the card; greedy ``generate`` of
   4 prompts x 1000 tokens + 64 new tokens twice (identical tokens), and a
   sampled one.  Every ``generate`` must launch the flash kernel exactly
   once per layer.
4. End to end against the CPU: the same engine at full width with 2
   layers in fp32 (TF32 off), one set of weights made as a flax-layout
   tree and passed through the weight bridge; prefill logits on the card
   against the port on the CPU.

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
    built = builder.build_all(["flash_fwd"])
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
    phase_cpu_parity()
    log(f"phase 4 done at {time.perf_counter() - t0:.1f} s")
    log(json.dumps({"kernels": [entry]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
