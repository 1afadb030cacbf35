#!/usr/bin/env python3
"""Time the port's W8A8 Linear (``ops/csrc/w8a8_gemm.cu``) on one GPU,
beside other builds of it and beside the first design's three launches.

    python3 scripts/bench_w8a8.py [--check-only] [--ablations [NAMES]]
                                  [--variant NAME=PATH ...] [--time-failed]
                                  [--reps 20] [--out FILE]

``kernel`` is ``ops/csrc/w8a8_gemm.cu`` as committed, called through its
C entries as the wrapper calls them: the row pre-pass, then the GEMM with
``quantization.w8a8_plan``'s blocks; it is also timed as its two
launches apart (``kernel_rows_only``, against the pre-pass's own byte
bound, and ``kernel_gemm_only``).
``--ablations [NAMES]`` adds builds of the committed source with one
design choice changed each: ``stages6`` (a ring of at most 6 stages
instead of 16), ``nopdl`` (the GEMM launched without programmatic
dependent launch, so it starts only once the pre-pass has ended), ``x2``
(two blocks an SM with rings of 6, twice the blocks) and ``fdiv`` (every
quantized value by ``__fdiv_rn``, not the reciprocal with the division
only near a half-integer).  ``--variant NAME=PATH`` adds another build: a
source with the ``dstpu_w8a8_gemm`` entry, or one with
``dstpu_w8a8_quant_rows`` and ``dstpu_w8a8_epilogue`` (the first design's
``weight_formats.cu``, for example the parent commit's from ``git show
<parent>:deepspeed_tpu_torch/ops/csrc/weight_formats.cu`` into a
git-ignored directory), which is timed as that design ran: K3 over the
rows padded to 17, ``torch._int_mm`` against the weight's transpose,
then K4 (where ``_int_mm`` takes the shape).  Every build is first
checked bit-identical to ``w8a8_linear_reference`` (twice) at the timed
shapes and at shapes that take each path of the kernel: 1 to 512 rows,
fp16 and fp32, a zero, an inf and a NaN row, N off the 128-channel tile,
K off the 128-byte panel; ``--check-only`` stops there, and a build that
fails is timed only where it passed (or everywhere, ``--time-failed``).
Then all are timed in turns (A B .. B A) at ``llama3-8b``'s
``gate_proj``, ``down_proj``, ``k_proj`` and ``lm_head`` at 16, 80 and
512 rows (bf16), with bf16 ``F.linear`` over the same weight in bf16 in
the same turns.  Device time is a CUDA graph of ``--reps`` calls on
preallocated outputs, replayed (``chip_smoke.graph_ms``).  It prints the
card's name and power limit, min and max ms per build and the share of
the bound (the int8 weight, x and y bytes at 3.35 TB/s, or 2 M N K
operations at 1,979 TOP/s, whichever is larger); ``--out`` writes them
as JSON.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch
from torch.nn import functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# llama3-8b's Linears as nn.Linear weights [out, in]: (N, K)
WEIGHTS = {"gate_proj": (14336, 4096), "down_proj": (4096, 14336),
           "k_proj": (1024, 4096), "lm_head": (128256, 4096)}
ROWS = (16, 80, 512)
# edits of the committed source for each ablation build
ABLATIONS = {
    "stages6": [("constexpr int MAX_STAGES = 16;",
                 "constexpr int MAX_STAGES = 6;")],
    "nopdl": [("attr[0].val.programmaticStreamSerializationAllowed = 1;",
               "attr[0].val.programmaticStreamSerializationAllowed = 0;")],
    # two blocks an SM, each with a ring of 6 stages (the plan's blocks
    # doubled, see PLANS)
    "x2": [("constexpr int MAX_STAGES = 16;", "constexpr int MAX_STAGES = 6;"),
           ("__global__ void __launch_bounds__(P_THREADS, 1)\nw8a8_gemm(",
            "__global__ void __launch_bounds__(P_THREADS, TN <= 32 ? 2 : 1)"
            "\nw8a8_gemm(")],
    "fdiv": [("  if (fabsf(fabsf(q - t) - 0.5f) < 0.0009765625f) "
              "t = rintf(__fdiv_rn(v, d));",
              "  t = rintf(__fdiv_rn(v, d));")],
}
# ablation builds that run with other plans: sms -> the SM count given to
# w8a8_plan
PLANS = {"x2": lambda sms: 2 * sms}
# (M, N, K, dtype, special rows) checked besides the timed shapes
CHECKS = [(1, 1024, 4096, "bfloat16", True),
          (17, 1024, 4096, "float16", True),
          (33, 4096, 4096, "bfloat16", False),
          (64, 1024, 14336, "float32", True),
          (65, 1024, 4096, "bfloat16", True),
          (200, 1000, 4096, "float16", False),
          (16, 40, 80, "bfloat16", True), (80, 40, 80, "float32", True),
          (3, 300, 336, "float32", True)]
_DTYPE = {"bfloat16": 0, "float16": 1, "float32": 2}
PEAK_BYTES, PEAK_INT8 = 3.35e12, 1979e12


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(sources):
    """One library per (name, source text), all nvcc started together;
    returns {name: lib}."""
    from deepspeed_tpu_torch.ops import builder

    out_dir = builder.BUILD_DIR / "bench_w8a8"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [builder.nvcc(), *builder._flags("w8a8_gemm"), "-I",
               str(builder.CSRC), "-o", str(out_dir / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                          ctypes.c_float)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        props = [f"{ln.split('Function properties for ')[1]}: "
                 f"{lines[i + 1].strip()}; {lines[i + 2].split(': ')[-1]}"
                 for i, ln in enumerate(lines)
                 if "Function properties" in ln and "w8a8" in ln]
        warn = [ln for ln in lines
                if "warning" in ln or "C7520" in ln or "serializ" in ln]
        print(f"[{name}] ptxas:\n  " + "\n  ".join(props) +
              f"\n  warnings: {warn}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        if hasattr(lib, "dstpu_w8a8_gemm"):
            lib.dstpu_w8a8_rows.argtypes = [ptr, i32, ptr, ptr, i64, i64,
                                            ptr]
            lib.dstpu_w8a8_gemm.argtypes = [ptr, ptr, i32, ptr, ptr, ptr,
                                            ptr, ptr, i64, i64, i64, i32,
                                            i32, i32, i32, ptr]
            lib.dstpu_w8a8_rows.restype = i32
            lib.dstpu_w8a8_gemm.restype = i32
        else:
            lib.dstpu_w8a8_quant_rows.argtypes = [ptr, i32, ptr, ptr, i64,
                                                  i64, i64, f32, f32, ptr]
            lib.dstpu_w8a8_epilogue.argtypes = [ptr, ptr, ptr, ptr, i32,
                                                i64, i64, ptr]
            lib.dstpu_w8a8_quant_rows.restype = i32
            lib.dstpu_w8a8_epilogue.restype = i32
        libs[name] = lib
    return libs


def _ok(err, what):
    if err:
        raise RuntimeError(f"{what} failed: error {err}")


class TwoLaunches:
    """One build of ``w8a8_gemm.cu`` on fixed inputs, every buffer
    allocated once, so that a call can be captured in a CUDA graph: the
    row pre-pass, then the GEMM with the wrapper's plan."""

    def __init__(self, lib, x, v, s, name="kernel"):
        from deepspeed_tpu_torch.ops import quantization as qz

        M, K = x.shape
        N = v.shape[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        if M <= qz.W8A8_STREAM_MAX_ROWS and name in PLANS:
            sms = PLANS[name](sms)
        plan = qz.w8a8_plan(M, N, K, sms)
        self.plan, self.lib, self.x = plan, lib, x
        self.y = torch.empty(M, N, dtype=x.dtype, device=x.device)
        self.xq = torch.empty(M, K, dtype=torch.int8, device=x.device)
        self.sx = torch.empty(M, 1, device=x.device)
        units = plan.token_tiles * plan.tiles
        self.sums = torch.zeros(units * plan.tn * 128, dtype=torch.int32,
                                device=x.device)
        self.tickets = torch.zeros(units, dtype=torch.int32,
                                   device=x.device)
        self.dt = _DTYPE[str(x.dtype)[6:]]
        self.args = (self.xq.data_ptr(), self.sx.data_ptr(), self.dt,
                     v.data_ptr(), s.data_ptr(), self.y.data_ptr(),
                     self.sums.data_ptr(), self.tickets.data_ptr(), M, N, K,
                     plan.tn, plan.ksplit, plan.kr, plan.blocks)

    def rows(self):
        _ok(self.lib.dstpu_w8a8_rows(
            self.x.data_ptr(), self.dt, self.xq.data_ptr(),
            self.sx.data_ptr(), *self.x.shape,
            torch.cuda.current_stream().cuda_stream), "w8a8_rows")

    def gemm(self):
        _ok(self.lib.dstpu_w8a8_gemm(
            *self.args, torch.cuda.current_stream().cuda_stream),
            "w8a8_gemm")
        return self.y

    def __call__(self):
        self.rows()
        return self.gemm()


class ThreeLaunches:
    """The first design: K3 over the rows padded to 17, ``torch._int_mm``
    against v's transpose (column-major), K4 over the first M rows."""

    def __init__(self, lib, x, v, s):
        M, K = x.shape
        self.Mp = max(M, 17)
        self.lib, self.x, self.v, self.s = lib, x, v, s
        self.xq = torch.empty(self.Mp, K, dtype=torch.int8, device=x.device)
        self.sx = torch.empty(self.Mp, 1, device=x.device)
        self.y = torch.empty(M, v.shape[0], dtype=x.dtype, device=x.device)
        self.dt = _DTYPE[str(x.dtype)[6:]]

    def __call__(self):
        st = torch.cuda.current_stream().cuda_stream
        M, K = self.x.shape
        _ok(self.lib.dstpu_w8a8_quant_rows(
            self.x.data_ptr(), self.dt, self.xq.data_ptr(),
            self.sx.data_ptr(), M, self.Mp, K, 127.0, 1e-12, st), "K3")
        acc = torch._int_mm(self.xq, self.v.t())[:M]
        _ok(self.lib.dstpu_w8a8_epilogue(
            acc.data_ptr(), self.sx.data_ptr(), self.s.data_ptr(),
            self.y.data_ptr(), self.dt, M, self.v.shape[0], st), "K4")
        return self.y


def calls_for(libs, x, v, s):
    out = {}
    for name, lib in libs.items():
        if hasattr(lib, "dstpu_w8a8_gemm"):
            out[name] = TwoLaunches(lib, x, v, s, name)
        elif v.shape[0] % 8 == 0 and x.shape[1] % 8 == 0:
            out[name] = ThreeLaunches(lib, x, v, s)  # _int_mm's limits
    return out


def path_of(call) -> str:
    if isinstance(call, ThreeLaunches):
        return "three launches"
    return f"pre-pass + GEMM, {call.plan.tn}-token tiles"


def make(M, N, K, dtype, special, seed):
    """x with rows of mixed magnitude (row 0 zero, row 1 with an inf, row 2
    with a NaN where ``special``), and quantize_per_channel's weight."""
    from deepspeed_tpu_torch.ops import quantization as qz

    g = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(M, K, generator=g, device="cuda") *
         torch.rand(M, 1, generator=g, device="cuda") * 3)
    w = (torch.randn(N, K, generator=g, device="cuda") *
         torch.rand(N, 1, generator=g, device="cuda") * 0.05)
    if special:
        x[0] = 0
        if M > 1:
            x[1, K // 3] = float("inf")
        if M > 2:
            x[2, K // 2] = float("nan")
    v, s = qz.quantize_per_channel(w)
    return x.to(getattr(torch, dtype)), v, s, w.to(torch.bfloat16)


def bits_equal(a, b):
    word = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.shape == b.shape and torch.equal(a.view(word), b.view(word))


def bound(M, N, K, elem):
    t_bytes = (N * K + M * K * elem + M * N * elem + 4 * N) / PEAK_BYTES
    t_ops = 2 * M * N * K / PEAK_INT8
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--ablations", nargs="?", const="all", default=None,
                    metavar="NAMES", help="all, or a comma-separated list")
    ap.add_argument("--time-failed", action="store_true",
                    help="time the other builds where they failed too")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_w8a8: no CUDA GPU available", file=sys.stderr)
        return 2
    import chip_smoke
    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import quantization as qz

    card = card_name()
    print(card, flush=True)
    committed = (builder.CSRC / "w8a8_gemm.cu").read_text()
    sources = {"kernel": committed}
    if args.ablations:
        wanted = (list(ABLATIONS) if args.ablations == "all"
                  else args.ablations.split(","))
        for name in wanted:
            edits = ABLATIONS[name]
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

    timed = [(M, N, K, "bfloat16", False, wname)
             for wname, (N, K) in WEIGHTS.items() for M in ROWS]
    checks = timed + [c + (None,) for c in CHECKS]
    failed = []
    for i, (M, N, K, dtype, special, wname) in enumerate(checks):
        x, v, s, _ = make(M, N, K, dtype, special, 1600 + i)
        want = qz.w8a8_linear_reference(x, v, s)
        for run, call in calls_for(libs, x, v, s).items():
            first = call().clone()
            second = call()
            torch.cuda.synchronize()
            same = [bits_equal(first, want), bits_equal(second, want)]
            tag = wname or "check"
            print(f"check {tag} M {M} N {N} K {K} {dtype}"
                  f"{' zero/inf/NaN rows' if special else ''} [{run}, "
                  f"{path_of(call)}]: bit-identical to plain, twice: "
                  f"{same} {'ok' if all(same) else 'FAILED'}", flush=True)
            if not all(same):
                failed.append((tag, M, N, K, dtype, run))
        del x, v, s, want
        torch.cuda.empty_cache()
    if failed:
        print(f"FAILED against plain: {failed}", flush=True)
        if any(f[-1] == "kernel" for f in failed) or args.check_only:
            return 1
        print("timing each other build only where it passed", flush=True)
    if args.check_only:
        return 0

    results = {"card": card, "reps": args.reps, "shapes": {}}
    for i, (M, N, K, dtype, _, wname) in enumerate(timed):
        x, v, s, w = make(M, N, K, dtype, False, 1600 + i)
        calls = {run: c for run, c in calls_for(libs, x, v, s).items()
                 if args.time_failed or
                 (wname, M, N, K, dtype, run) not in failed}
        calls["bf16_linear"] = lambda: F.linear(x, w)
        calls["kernel"]()       # its two launches apart
        calls["kernel_rows_only"] = calls["kernel"].rows
        calls["kernel_gemm_only"] = calls["kernel"].gemm
        order = list(calls) + list(calls)[::-1]
        t = {run: [] for run in calls}
        for run in order:
            t[run].append(chip_smoke.graph_ms(calls[run], args.reps))
        b, by = bound(M, N, K, x.element_size())
        # the pre-pass alone reads x and writes xq and sx
        apart = {"kernel_rows_only": ((x.element_size() + 1) * M * K + 4 * M)
                 / PEAK_BYTES * 1e3}
        key = f"{wname}_m{M}"
        results["shapes"][key] = {
            "M": M, "N": N, "K": K, "bound_ms": b, "bound_by": by,
            "plan": calls["kernel"].plan._asdict(),
            "builds": {run: {"min_ms": min(ts), "max_ms": max(ts),
                             "of_bound": apart.get(run, b) / min(ts)}
                       for run, ts in t.items()}}
        print(f"{key} [{N}, {K}] x {M} rows: bound {b:.4f} ms ({by}); plan "
              f"{tuple(calls['kernel'].plan)}", flush=True)
        for run, r in results["shapes"][key]["builds"].items():
            print(f"  {run}: {r['min_ms']:.4f}/{r['max_ms']:.4f} ms "
                  f"({r['of_bound']:.1%} of bound)", flush=True)
        del x, v, s, w, calls
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
