#!/usr/bin/env python3
"""Time the port's flash-attention forward against SDPA on one GPU, with
other builds of the same C entry point in the same process.

    python3 scripts/bench_flash_fwd.py [--ablations]
                                       [--variant NAME=PATH ...]
                                       [--reps 30] [--out FILE]

``kernel`` is ``ops/csrc/flash_fwd.cu`` as committed.  ``--variant``
adds another source of ``dstpu_flash_fwd`` (for example the parent
commit's ``flash_fwd.cu``, unpacked into a git-ignored directory);
``--ablations`` adds copies of the committed source with one design
choice changed each: ``pingpong`` (the two consumer warpgroups take
turns to issue their products, over named barriers 3 and 4), ``exp2f``
(libm's ``exp2f`` for ``ex2.approx.ftz``), ``qtile_fastest`` (the tile
order walks q tiles first, so heavy and light causal tiles interleave)
and ``one_tile_per_block`` (a block per tile instead of one persistent
block per SM).  Each build prints what ``ptxas`` says of its bf16 kernels and
is checked against ``flash_fwd_reference`` at ragged shapes (bf16
limits of ``chip_smoke.py``); then all are timed in turns (A B .. B A)
beside ``scaled_dot_product_attention`` at the main paths' shapes: the
v1 serving prefill (B4 H32/8 S1000 D128 causal), the training step (B4
H32/4 S2048 D64 causal), S2048 D128 and D64 not causal.  It prints the
card's name and power limit, min and max ms per build, TFLOP/s and the
share of the operation bound; ``--out`` writes them as JSON.  Needs a
CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

PEAK_BF16 = 989e12
BF16_ATOL, BF16_RTOL = 2e-2, 2e-2
LSE_ATOL, LSE_RTOL = 2e-3, 1e-4
# (old, new) text of the committed source for each ablation
ABLATIONS = {
    "pingpong": [  # the consumers take turns to issue their products
        ("  int it = 0, nq = 0;  // key tiles and q tiles consumed so far\n",
         "  auto turn_wait = [&]() { hopper::named_barrier_sync(3 + cw, 256); "
         "};\n  auto turn_pass = [&]() { "
         "hopper::named_barrier_arrive(4 - cw, 256); };\n"
         "  if (cw == 1) turn_pass();\n"
         "  int it = 0, nq = 0;  // key tiles and q tiles consumed so far\n"),
        ("      hopper::mbar_wait(k_full(s), (it / ST) & 1);\n"
         "      hopper::wgmma_fence();\n"
         "      qk_issue<D>(sc, qa, k_tile(s));\n"
         "      hopper::wgmma_commit();\n",
         "      hopper::mbar_wait(k_full(s), (it / ST) & 1);\n"
         "      turn_wait();\n      hopper::wgmma_fence();\n"
         "      qk_issue<D>(sc, qa, k_tile(s));\n"
         "      hopper::wgmma_commit();\n      turn_pass();\n"),
        ("      hopper::mbar_wait(k_full(s), ((it + j) / ST) & 1);\n",
         "      hopper::mbar_wait(k_full(s), ((it + j) / ST) & 1);\n"
         "      turn_wait();\n"),
        ("      pv_issue<D>(acc, pf, v_tile(sp));\n"
         "      hopper::wgmma_commit();\n",
         "      pv_issue<D>(acc, pf, v_tile(sp));\n"
         "      hopper::wgmma_commit();\n      turn_pass();\n"),
        ("      hopper::mbar_wait(v_full(s), ((it + nk - 1) / ST) & 1);\n",
         "      hopper::mbar_wait(v_full(s), ((it + nk - 1) / ST) & 1);\n"
         "      turn_wait();\n"),
        ("      pv_issue<D>(acc, pf, v_tile(s));\n"
         "      hopper::wgmma_commit();\n",
         "      pv_issue<D>(acc, pf, v_tile(s));\n"
         "      hopper::wgmma_commit();\n      turn_pass();\n"),
        ("  if (tid == 0) hopper::tma_store_wait();\n}\n",
         "  if (cw == 0) turn_wait();  // warpgroup 1's last pass\n"
         "  if (tid == 0) hopper::tma_store_wait();\n}\n")],
    "exp2f": [(
        '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n'
        "  return y;", "  y = exp2f(x);\n  return y;")],
    "qtile_fastest": [(
        "  const int r = t % (H * B);\n"
        "  return {q_tiles - 1 - t / (H * B), r % H, r / H};",
        "  const int r = t / q_tiles;\n"
        "  return {q_tiles - 1 - t % q_tiles, r % H, r / H};")],
    "one_tile_per_block": [(
        "  const int grid = (int)(tiles < sms ? tiles : sms);",
        "  const int grid = (int)tiles;")],
}
CHECKS = [  # B, H, Hkv, S, Sk, D, causal
    (1, 8, 8, 1, 1, 64, True), (2, 8, 2, 1, 1000, 128, True),
    (1, 8, 1, 63, 63, 64, False), (1, 8, 2, 129, 129, 128, True),
    (1, 8, 1, 129, 400, 64, True), (1, 4, 1, 1000, 129, 128, True),
    (1, 4, 4, 300, 1000, 128, False), (2, 16, 4, 1000, 1000, 128, True),
]
TIMED = {
    "serving": (4, 32, 8, 1000, 1000, 128, True),
    "train": (4, 32, 4, 2048, 2048, 64, True),
    "s2048": (4, 32, 8, 2048, 2048, 128, True),
    "d64_noncausal": (4, 32, 8, 1000, 1000, 64, False),
}


def build(sources):
    """One library per (name, source text), all nvcc started together."""
    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import flash_attention as fa

    out_dir = builder.BUILD_DIR / "bench_flash_fwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [builder.nvcc(), *builder._flags("flash_fwd"), "-I",
               str(builder.CSRC), "-o", str(out_dir / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    entry, argtypes = fa._ENTRY["flash_fwd"]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        bf16 = [f"{ln.split('ILi')[1][:3].rstrip('E')}: "
                f"{lines[i + 1].strip()}; {lines[i + 2].split(': ')[-1]}"
                for i, ln in enumerate(lines)
                if "Function properties" in ln and "f32" not in ln]
        warn = [ln for ln in lines if "warning" in ln and "f32" not in ln]
        print(f"[{name}] ptxas, bf16 kernel by D: {bf16}; other warnings: "
              f"{warn}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        lib.dstpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def inputs(shape, seed):
    B, H, Hkv, S, Sk, D, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(B, s, n, D, generator=g, device="cuda",
                             dtype=torch.bfloat16).transpose(1, 2)
                 for n, s in ((H, S), (Hkv, Sk), (Hkv, Sk)))


def check(fa, shape, seed):
    q, k, v = inputs(shape, seed)
    causal = shape[-1]
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    err = (o.float() - ro.float()).abs()
    inf = torch.isinf(rlse)
    ok = bool((err <= BF16_ATOL + BF16_RTOL * ro.float().abs()).all())
    ok &= torch.equal(torch.isinf(lse), inf) and bool((o[inf] == 0).all())
    ok &= bool(((lse - rlse)[~inf].abs() <=
                LSE_ATOL + LSE_RTOL * rlse[~inf].abs()).all())
    return ok, err.max().item()


def time_ms(fn, reps):
    for _ in range(3):
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--ablations", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_fwd: no CUDA GPU available", file=sys.stderr)
        return 2
    from torch.nn import functional as F

    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    committed = (builder.CSRC / "flash_fwd.cu").read_text()
    sources = {"kernel": committed}
    if args.ablations:
        for name, edits in ABLATIONS.items():
            text = committed
            for old, new in edits:
                assert old in text, f"ablation {name}: source changed"
                text = text.replace(old, new)
            sources[name] = text
    for spec in args.variant:
        name, path = spec.split("=", 1)
        with open(path) as f:
            sources[name] = f.read()
    libs = build(sources)

    def use(name):
        fa._lib = lambda _, lib=libs[name]: lib

    failed = []
    for name in libs:
        use(name)
        worst = 0.0
        for i, shape in enumerate(CHECKS + list(TIMED.values())):
            ok, err = check(fa, shape, i)
            worst = max(worst, err)
            if not ok:
                failed.append((name, shape, err))
        print(f"[{name}] {len(CHECKS) + len(TIMED)} shapes against plain: "
              f"max|o-plain| {worst:.3e}", flush=True)
    if failed:
        print(f"FAILED against plain: {failed}", flush=True)
        return 1

    order = list(libs) + list(libs)[::-1]
    results = {"card": card, "reps": args.reps, "shapes": {}}
    for tname, shape in TIMED.items():
        B, H, Hkv, S, Sk, D, causal = shape
        q, k, v = inputs(shape, 0)
        pairs = S * Sk if not causal else sum(
            min(max(r + Sk - S + 1, 0), Sk) for r in range(S))
        ops = 4 * B * H * D * pairs
        times = {name: [] for name in [*libs, "sdpa"]}
        for name in order:
            use(name)
            times[name].append(time_ms(
                lambda: fa.flash_fwd(q, k, v, causal=causal), args.reps))
            times["sdpa"].append(time_ms(
                lambda: F.scaled_dot_product_attention(
                    q, k, v, is_causal=causal, enable_gqa=True), args.reps))
        bound = ops / PEAK_BF16 * 1e3
        row = {n: {"min_ms": min(t), "max_ms": max(t),
                   "tflops": ops / min(t) / 1e9,
                   "of_bound": bound / min(t)} for n, t in times.items()}
        results["shapes"][tname] = {"shape": shape, "bound_ms": bound,
                                    "builds": row}
        print(f"{tname} B{B} H{H}/{Hkv} S{S} Sk{Sk} D{D} causal={causal} "
              f"(bound {bound:.4f} ms): " + ", ".join(
                  f"{n} {r['min_ms']:.4f}/{r['max_ms']:.4f} ms "
                  f"{r['tflops']:.1f} TFLOP/s {r['of_bound']:.1%}"
                  for n, r in row.items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
