#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving paths, on one GPU.

    python3 scripts/profile_torch_serving.py [--mode v1|v2] [--new 16]
                                             [--out FILE]

Builds ``llama3-8b`` at full width and depth with random seeded weights
(bf16, made on the card) and traces with ``torch.profiler``:

- ``v1`` (``init_inference``): serves 4 prompts x 1000 tokens once to
  warm up, then traces (a) a prefill (``generate`` of one token) and
  (b) a whole ``generate`` of ``--new`` tokens;
- ``v2`` (``RaggedInferenceEngineV2``, 16 slots, 512-token prefill
  chunks, 64-token pages, 8-tick decode blocks): warms up on one small
  run, submits 16 requests of 600 prompt tokens and 64 new tokens, then
  traces (a) a fused tick that mixes decode tokens with a prefill chunk
  and (b) a decode block.

For each window it prints the wall time, the device busy share (the
union of device intervals over wall time: the rest is the device waiting
on the host), and the kernels that take the most device time.  ``--out``
also writes the numbers as JSON.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profile(fn, top: int):
    """Wall ms, device busy share and the top kernels of one call.  Busy
    time is the union of the device events' intervals (kernels, copies,
    memsets), so nothing is counted twice."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "Command Buffer Full"]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in dev):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in dev:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    total = sum(us for _, us in by_name.values())
    rows = [{"kernel": name[:90], "calls": calls, "device_ms": us / 1e3,
             "share": us / total}
            for name, (calls, us) in sorted(by_name.items(),
                                            key=lambda kv: -kv[1][1])[:top]]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
            "device_busy_share": busy_us / 1e3 / (wall * 1e3),
            "top_kernels": rows}


def profile_v2(top: int):
    """Trace one mixed fused tick and one decode block of the v2 engine."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config

    cfg = get_config("llama3-8b")
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(0),
        max_seqs=16, max_seq_len=2048, prefill_chunk=512, page_size=64,
        decode_block_size=8)
    rng = np.random.default_rng(0)

    def submit(n, prompt, new):
        for _ in range(n):
            engine.put_request(rng.integers(0, cfg.vocab_size, size=prompt),
                               max_new_tokens=new)

    submit(16, 300, 24)                                    # warm-up
    while engine.has_work():
        engine.step()
    engine.get_outputs()
    submit(16, 600, 64)
    out = {"device": torch.cuda.get_device_name(0), "mode": "v2",
           "requests": 16, "prompt": 600, "new_tokens": 64}
    st = engine.host_stats

    def traced_step(want_block: bool):
        while True:
            live = [r for r in engine.slots if r is not None]
            decoding = [r for r in live if r.prefill_done >= r.ctx_len]
            if want_block == (len(decoding) == len(live)) and (
                    want_block or decoding):
                break
            engine.step()
        ticks = st.ticks
        res = profile(engine.step, top)
        res["ticks"] = st.ticks - ticks
        res["tokens_in_batch"] = (len(decoding) if want_block else None)
        return res

    out["fused_tick"] = traced_step(want_block=False)
    out["decode_block"] = traced_step(want_block=True)
    assert out["fused_tick"]["ticks"] == 1
    assert out["decode_block"]["ticks"] == engine.decode_block_size
    while engine.has_work():
        engine.step()
    out["serving_stages"] = {k: v for k, v in engine.serving_stages().items()
                             if not isinstance(v, dict)}
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("v1", "v2"), default="v1")
    ap.add_argument("--new", type=int, default=16,
                    help="new tokens in the traced v1 generate")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA GPU", file=sys.stderr)
        return 2
    if args.mode == "v2":
        return report(profile_v2(args.top), ("fused_tick", "decode_block"),
                      args.out)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config

    cfg = get_config("llama3-8b")
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    engine = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "bfloat16", "max_out_tokens": 2048},
        generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (4, 1000),
                            generator=torch.Generator().manual_seed(0))
    engine.generate(prompts, max_new_tokens=4)             # warm-up
    out = {"device": torch.cuda.get_device_name(0),
           "batch": 4, "prompt": 1000, "new_tokens": args.new}
    out["prefill"] = profile(
        lambda: engine.generate(prompts, max_new_tokens=1), args.top)
    out["generate"] = profile(
        lambda: engine.generate(prompts, max_new_tokens=args.new), args.top)
    return report(out, ("prefill", "generate"), args.out)


def report(out, windows, path) -> int:
    for name in windows:
        r = out[name]
        print(f"{name}: wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['device_busy_ms']:.1f} ms ({r['device_busy_share']:.1%})")
        for row in r["top_kernels"]:
            print(f"  {row['device_ms']:9.3f} ms {row['share']:6.1%} "
                  f"x{row['calls']:<5d} {row['kernel']}")
    if "serving_stages" in out:
        print(f"serving_stages: {out['serving_stages']}")
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
