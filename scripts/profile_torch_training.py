#!/usr/bin/env python3
"""Where the time goes in one training step of the PyTorch port, on one GPU.

    python3 scripts/profile_torch_training.py [--model llama-1b]
                                              [--layers N] [--top 16]
                                              [--out FILE]

Builds a model with random seeded weights on the card and the training
engine of ``chip_smoke.py``, takes two warm-up steps, then traces one
``train_batch`` with ``torch.profiler``.  ``--model``: ``llama-1b``
(TinyLlama shape; phase 9: bf16 with fp32 master weights, fused AdamW,
clipping 1.0, micro-batch 4 x 2048 tokens, 2 accumulation steps),
``gpt2-125m`` (phase 17's config 1, ``bench.py``'s: ZeRO 0, fused AdamW,
micro-batch 12 x 1024, remat off) or ``gpt2-1.3b`` (config 2: ZeRO 2
over one NCCL rank, FusedAdam, micro-batch 4 x 1024, ``dots_saveable``).
``--layers`` cuts the depth.  It prints the wall time, the
device busy share (the union of device intervals over wall time), the
kernels that take the most device time, and the device time by class:
GEMMs (cuBLAS), the port's flash forward and backward kernels, the fused
optimizer kernel, and everything else (elementwise, reductions, copies).
``--out`` also writes the numbers as JSON.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)

from profile_torch_serving import profile, report  # noqa: E402

# kernel name fragments of each class (the port's kernels by their CUDA
# function names; cuBLAS GEMMs by their library prefixes)
CLASSES = {
    "flash_fwd": ("flash_fwd_hopper", "flash_fwd_f32"),
    "flash_bwd_dq": ("dq_hopper", "dq_f32"),
    "flash_bwd_dkv": ("dkv_hopper", "dkv_f32"),
    "optimizer": ("adam_kernel", "lion_kernel"),
    "gemm": ("nvjet", "gemm", "cutlass", "sm90_xmma", "Kernel2"),
}


def by_class(step_fn):
    """Device ms of each class over one call (every kernel counted)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        step_fn()
        torch.cuda.synchronize()
    out = {k: 0.0 for k in CLASSES}
    out["other"] = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        for cls, frags in CLASSES.items():
            if any(f in e.name for f in frags):
                out[cls] += ms
                break
        else:
            out["other"] += ms
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="llama-1b",
                    choices=("llama-1b", "gpt2-125m", "gpt2-1.3b"))
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--top", type=int, default=16)
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_training: needs a CUDA GPU", file=sys.stderr)
        return 2
    import deepspeed_tpu_torch

    if args.model == "llama-1b":
        from deepspeed_tpu_torch.models.llama import LlamaLMLoss, get_config

        cfg = get_config("llama-1b", **({} if args.layers is None else
                                        {"num_hidden_layers": args.layers}))
        with torch.device("meta"):
            model = LlamaLMLoss(cfg)
        config = {"train_micro_batch_size_per_gpu": 4,
                  "gradient_accumulation_steps": 2,
                  "bf16": {"enabled": True},
                  "optimizer": {"type": "AdamW", "params": {
                      "lr": 3e-4, "weight_decay": 0.1, "fused": True,
                      "betas": [0.9, 0.95]}},
                  "gradient_clipping": 1.0, "steps_per_print": 1000}
        shape = (8, 2048)
    else:
        from chip_smoke import gpt2_train_config
        from deepspeed_tpu_torch.models.gpt2 import GPT2LMLoss, get_config

        small = args.model == "gpt2-125m"
        cfg = get_config(args.model, n_positions=1024,
                         use_flash_attention=True, remat=not small,
                         remat_policy="none" if small else "dots_saveable",
                         **({} if args.layers is None else
                            {"n_layer": args.layers}))
        with torch.device("meta"):
            model = GPT2LMLoss(cfg)
        micro = 12 if small else 4
        config = gpt2_train_config("AdamW" if small else "FusedAdam", micro,
                                   0 if small else 2)
        shape = (micro, 1024)
        if not small:
            from deepspeed_tpu_torch import comm

            comm.init_distributed(dist_backend="nccl")
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=config,
        generator=torch.Generator(device="cuda").manual_seed(0))
    batch = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                              size=shape)
    for _ in range(2):                                   # warm-up
        engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.train_batch(batch=batch)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    out = {"device": torch.cuda.get_device_name(0), "model": args.model,
           "layers": args.layers, "tokens_per_step": shape[0] * shape[1],
           "step_ms_unprofiled": plain_ms}
    out["train_step"] = profile(lambda: engine.train_batch(batch=batch),
                                args.top)
    out["device_ms_by_class"] = by_class(
        lambda: engine.train_batch(batch=batch))
    print(f"step without the profiler: {plain_ms:.1f} ms")
    print("device ms by class: " + ", ".join(
        f"{k} {v:.1f}" for k, v in out["device_ms_by_class"].items()))
    if args.model == "gpt2-1.3b":
        from deepspeed_tpu_torch import comm

        comm.destroy_process_group()
    return report(out, ("train_step",), args.out)


if __name__ == "__main__":
    sys.exit(main())
