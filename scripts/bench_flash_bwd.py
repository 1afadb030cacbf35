#!/usr/bin/env python3
"""Time the port's flash-attention backward against SDPA's on one GPU,
with other builds of the same C entry point in the same process.

    python3 scripts/bench_flash_bwd.py [--ablations] [--check-only]
                                       [--variant NAME=PATH ...]
                                       [--reps 30] [--out FILE]

``kernel`` is ``ops/csrc/flash_bwd.cu`` as committed.  ``--variant``
adds another source of ``dstpu_flash_bwd`` (for example the parent
commit's ``flash_bwd.cu``, from ``git show HEAD:...`` into a git-ignored
directory); ``--ablations`` adds copies of the committed source with one
design choice changed each: ``exp2f`` (libm's ``exp2f`` for
``ex2.approx.ftz``), ``round_robin`` (units dealt to the blocks in plain
rounds instead of a snake), ``one_tile_per_block`` (a block per unit
instead of one persistent block per SM), ``dkv_bq64`` (dK/dV stages of
64 q rows at D=64 instead of 128) and ``dq_bk64`` (dQ key tiles of 64 rows
at D=64 instead of 128).  Each build prints what ``ptxas`` says of its
bf16 kernels and is checked against ``flash_bwd_reference`` at ragged
shapes within ``chip_smoke.py``'s phase-8 limits (3e-3 absolute plus
2e-2 relative), rows that see no key giving exactly 0 and two calls
giving bit-identical gradients; ``--check-only`` stops there.  Then all
are timed in turns (A B .. B A) at the training step's shape (B4 H32/4
S2048 D64 causal), S2048 D128 (H32/8) and S1000 D128 (H32/8), all
causal: the dQ kernel, the dK/dV kernel, the whole ``flash_bwd`` and its
torch pass ``delta = rowsum(dO * O)`` alone, beside SDPA's backward on
each backend that takes the inputs (flash, cuDNN, efficient), pinned
through ``torch.nn.attention.sdpa_kernel``.  It prints the card's name
and power limit, min and max ms per build, TFLOP/s and the share of the
bound (operations at 989 TFLOP/s or bytes at 3.35 TB/s, whichever is
larger); ``--out`` writes them as JSON.  Needs a CUDA GPU.
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
PEAK_BYTES = 3.35e12
BWD_ATOL, BWD_RTOL = 3e-3, 2e-2      # chip_smoke.py phase 8
# (old, new) text of the committed source for each ablation
ABLATIONS = {
    "exp2f": [(
        '  asm("ex2.approx.ftz.f32 %0, %1;\\n" : "=f"(y) : "f"(x));\n'
        "  return y;", "  y = exp2f(x);\n  return y;")],
    "round_robin": [(
        "  return r * blocks + ((r & 1) ? blocks - 1 - (int)blockIdx.x\n"
        "                               : (int)blockIdx.x);",
        "  return r * blocks + (int)blockIdx.x;")],
    "one_tile_per_block": [(
        "  *grid = (int)(units < sms ? units : sms);",
        "  *grid = (int)units;")],
    "dkv_bq64": [(
        "  static constexpr int BQ = D == 64 ? 128 : 64;",
        "  static constexpr int BQ = 64;")],
    "dq_bk64": [(
        "  static constexpr int BK = D == 64 ? 128 : 64;",
        "  static constexpr int BK = 64;")],
}
CHECKS = [  # B, H, Hkv, S, Sk, D, causal
    (1, 8, 8, 1, 1, 64, True), (2, 8, 2, 1, 1000, 128, True),
    (1, 8, 1, 63, 63, 64, False), (1, 8, 2, 129, 129, 128, True),
    (1, 8, 1, 129, 400, 64, True), (1, 4, 1, 1000, 129, 128, True),
    (1, 4, 4, 300, 1000, 128, False), (2, 16, 2, 1100, 1100, 64, True),
    (1, 8, 2, 200, 460, 128, True), (2, 4, 1, 130, 100, 64, True),
]
TIMED = {
    "train": (4, 32, 4, 2048, 2048, 64, True),
    "s2048_d128": (4, 32, 8, 2048, 2048, 128, True),
    "s1000_d128": (4, 32, 8, 1000, 1000, 128, True),
}


def build(sources):
    """One library per (name, source text), all nvcc started together."""
    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import flash_attention as fa

    out_dir = builder.BUILD_DIR / "bench_flash_bwd"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [builder.nvcc(), *builder._flags("flash_bwd"), "-I",
               str(builder.CSRC), "-o", str(out_dir / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    entry, argtypes = fa._ENTRY["flash_bwd"]
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        bf16 = [f"{ln.split('Function properties for ')[1]}: "
                f"{lines[i + 1].strip()}; {lines[i + 2].split(': ')[-1]}"
                for i, ln in enumerate(lines)
                if "Function properties" in ln and "f32" not in ln]
        warn = [ln for ln in lines if ("warning" in ln or "serialized" in ln)
                and "f32" not in ln]
        print(f"[{name}] ptxas, bf16 kernels: {bf16}; warnings: {warn}",
              flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        getattr(lib, entry).argtypes = argtypes
        getattr(lib, entry).restype = ctypes.c_int
        lib.dstpu_cuda_error_string.argtypes = [ctypes.c_int]
        lib.dstpu_cuda_error_string.restype = ctypes.c_char_p
        libs[name] = lib
    return libs


def inputs(shape, seed):
    """q, k, v, dO in the layout the model hands the kernels: [B,S,heads,D]
    projections seen as [B,heads,S,D]."""
    B, H, Hkv, S, Sk, D, _ = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    return tuple(torch.randn(B, s, n, D, generator=g, device="cuda",
                             dtype=torch.bfloat16).transpose(1, 2)
                 for n, s in ((H, S), (Hkv, Sk), (Hkv, Sk), (H, S)))


def check(fa, shape, seed):
    """(ok, largest error) of one build against the plain backward."""
    q, k, v, do = inputs(shape, seed)
    causal = shape[-1]
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    again = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    ok, worst = True, 0.0
    for a, a2, b in zip(got, again, want):
        err = (a.float() - b.float()).abs()
        ok &= bool((err <= BWD_ATOL + BWD_RTOL * b.float().abs()).all())
        ok &= torch.equal(a, a2)
        worst = max(worst, err.max().item())
    S, Sk = shape[3], shape[4]
    if causal and Sk < S:
        ok &= bool((got[0][:, :, :S - Sk] == 0).all())
    return ok, worst


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


def sdpa_backwards(q, k, v, do):
    """{backend name: timer} of SDPA's causal backward alone, its graph
    kept alive, for each of the flash, cuDNN and efficient backends that
    takes these inputs."""
    from torch.nn import functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    runs = {}
    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.CUDNN_ATTENTION,
                    SDPBackend.EFFICIENT_ATTENTION):
        leaves = tuple(t.detach().requires_grad_() for t in (q, k, v))
        try:
            with sdpa_kernel(backend):
                out = F.scaled_dot_product_attention(
                    *leaves, is_causal=True, enable_gqa=True)
                torch.autograd.grad(out, leaves, do, retain_graph=True)
        except RuntimeError:
            continue

        def run(out=out, leaves=leaves, backend=backend):
            with sdpa_kernel(backend):
                torch.autograd.grad(out, leaves, do, retain_graph=True)
        runs[backend.name.lower()] = run
    if not runs:
        raise RuntimeError("no SDPA backend takes these inputs")
    return runs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--ablations", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_flash_bwd: no CUDA GPU available", file=sys.stderr)
        return 2
    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import flash_attention as fa

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    committed = (builder.CSRC / "flash_bwd.cu").read_text()
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
    own_lib = fa._lib

    def use(name):
        fa._lib = lambda n, lib=libs[name]: (
            lib if n == "flash_bwd" else own_lib(n))

    failed = []
    for name in libs:
        use(name)
        worst = 0.0
        for i, shape in enumerate(CHECKS + list(TIMED.values())):
            ok, err = check(fa, shape, i)
            worst = max(worst, err)
            if not ok:
                failed.append((name, shape, err))
        print(f"[{name}] {len(CHECKS) + len(TIMED)} shapes against plain, "
              f"twice each: max|grad-plain| {worst:.3e}", flush=True)
    if failed:
        print(f"FAILED against plain: {failed}", flush=True)
        return 1
    if args.check_only:
        return 0

    order = list(libs) + list(libs)[::-1]
    results = {"card": card, "reps": args.reps, "shapes": {}}
    for tname, shape in TIMED.items():
        B, H, Hkv, S, Sk, D, causal = shape
        q, k, v, do = inputs(shape, 0)
        o, lse = fa.flash_fwd(q, k, v, causal=causal)
        delta = fa.bwd_delta(do, o)
        pairs = S * Sk if not causal else sum(
            min(max(r + Sk - S + 1, 0), Sk) for r in range(S))
        ops = {"dq": 6 * B * H * D * pairs, "dkv": 8 * B * H * D * pairs}
        ops["bwd"] = ops["dq"] + ops["dkv"]
        ops["delta"] = 2 * B * H * S * D
        # bytes each input read once, each output written once
        qb, kb, rows = 2 * B * H * S * D, 2 * B * Hkv * Sk * D, B * H * S
        ins = 2 * qb + 2 * kb + 8 * rows            # q, dO, k, v, lse, delta
        nbytes = {"dq": ins + qb, "dkv": ins + 2 * kb,
                  "bwd": 3 * qb + 2 * kb + 4 * rows + qb + 2 * kb,
                  "delta": 2 * qb + 4 * rows}
        sdpa = sdpa_backwards(q, k, v, do)
        runs = {
            "dq": lambda: fa.flash_bwd_dq(q, k, v, do, lse, delta, causal),
            "dkv": lambda: fa.flash_bwd_dkv(q, k, v, do, lse, delta, causal),
            "bwd": lambda: fa.flash_bwd(q, k, v, o, lse, do, causal=causal),
        }
        # flash_bwd's torch pass before the kernels, and the yardsticks
        others = {("torch", "delta"): lambda: fa.bwd_delta(do, o)}
        others.update({(f"sdpa_{b}", "bwd"): fn for b, fn in sdpa.items()})
        times = {(n, w): [] for n in libs for w in runs}
        times.update({key: [] for key in others})
        for name in order:
            use(name)
            for w, fn in runs.items():
                times[(name, w)].append(time_ms(fn, args.reps))
            for key, fn in others.items():
                times[key].append(time_ms(fn, args.reps))
        out = {}
        for (name, w), t in times.items():
            t_ops, t_bytes = ops[w] / PEAK_BF16, nbytes[w] / PEAK_BYTES
            bound = max(t_ops, t_bytes) * 1e3
            out[f"{name}.{w}"] = {
                "min_ms": min(t), "max_ms": max(t), "bound_ms": bound,
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "tflops": ops[w] / min(t) / 1e9, "of_bound": bound / min(t)}
        results["shapes"][tname] = {"shape": shape, "builds": out}
        print(f"{tname} B{B} H{H}/{Hkv} S{S} Sk{Sk} D{D} causal={causal}:",
              flush=True)
        for key, r in out.items():
            print(f"  {key}: {r['min_ms']:.4f}/{r['max_ms']:.4f} ms, "
                  f"{r['tflops']:.1f} TFLOP/s, {r['of_bound']:.1%} of "
                  f"{r['bound_ms']:.4f} ms ({r['bound_by']})", flush=True)
        del q, k, v, do, o, lse, delta, sdpa, others
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
