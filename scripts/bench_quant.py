#!/usr/bin/env python3
"""Time the port's group-wise quantize (#6) and dequantize (#7) kernels on
one GPU, with other builds of the same C entry points in the same process.

    python3 scripts/bench_quant.py [--ablations] [--check-only]
                                   [--variant NAME=PATH ...]
                                   [--reps 20] [--out FILE]

``kernel`` is ``ops/csrc/quantization.cu`` as committed.  ``--variant``
adds another source of ``dstpu_quantize``/``dstpu_dequantize`` (for
example the parent commit's, from ``git show HEAD:...`` into a
git-ignored directory).  ``--ablations`` adds builds of the committed
source with one design choice changed each: ``stages4`` (a ring of four
stages instead of two), ``no_ring`` (no producer: the consumer warps
load their chunks from device memory themselves) and ``reread`` (the
consumers read the tile from the ring twice, once for the max and min
and once to quantize, instead of holding it in registers).  Every build
is first checked bit-identical to the plain versions
(``quantize_reference``, ``dequantize_reference``: payload, scale,
offset and dequantized output) at the timed shapes and at shapes that
take each of the source's paths; ``--check-only`` stops there.  Then
all are timed in turns (A B .. B A) at ``chip_smoke.py``'s timed shapes:
``gate_proj`` [4096, 14336] bf16 at groups of 128 and 2048 (the v1 and
v2 int8 builds) and a ZeRO++-like flat vector of 2^26 values at groups
of 2048, fp32 8-bit and bf16 4-bit.  Device time is a CUDA graph of
``--reps`` calls of the C entry on preallocated outputs, replayed
(``chip_smoke.graph_ms``); the committed kernel is also timed through
its wrapper in a host loop (``chip_smoke.time_ms``), which is what an
uncaptured caller sees.  It prints the card's name and power limit, min
and max ms per build, and the share of ``chip_smoke.quant_bound``;
``--out`` writes them as JSON.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (old, new) text of the committed source for each ablation build
ABLATIONS = {
    "stages4": [("constexpr int STAGES = 2;", "constexpr int STAGES = 4;")],
    "no_ring": [("constexpr bool RING = true;",
                 "constexpr bool RING = false;")],
    "reread": [("constexpr bool HOLD = true;",
                "constexpr bool HOLD = false;")],
}
# name: (shape, group size, dtype, bits, symmetric)
TIMED = {
    "gate_proj_g128": ((4096, 14336), 128, "bfloat16", 8, True),
    "gate_proj_g2048": ((4096, 14336), 2048, "bfloat16", 8, True),
    "zero_fp32_g2048": ((1 << 26,), 2048, "float32", 8, True),
    "zero_bf16_4b_g2048": ((1 << 26,), 2048, "bfloat16", 4, True),
}
# more shapes for the checks: every lane split of the ring (1 to 32 lanes
# a group, groups off a power of two, 1 to 16 rows a group), fp16, 4-bit,
# asymmetric, tails inside a tile and a last tile of fewer groups, and
# the first design's shapes (gs off 16, groups above one stage, n off
# the vector width, an input 2 bytes off 16)
CHECKS = {
    "g16_bf16": ((333, 64), 16, "bfloat16", 8, True),
    "g32_bf16_asym": ((1000, 96), 32, "bfloat16", 8, False),
    "g48_fp16": ((777, 48), 48, "float16", 8, True),
    "g64_fp16_asym4": ((512, 320), 64, "float16", 4, False),
    "g256_fp32": ((100, 1000), 256, "float32", 8, True),
    "g512_bf16_asym": ((64, 1000), 512, "bfloat16", 8, False),
    "g1536_bf16": ((30, 4096), 1536, "bfloat16", 8, True),
    "g4096_fp32_asym": ((9, 5000), 4096, "float32", 8, False),
    "g4096_bf16_4b": ((17, 4104), 4096, "bfloat16", 4, True),
    "g8192_bf16": ((5, 8200), 8192, "bfloat16", 8, True),
    "tail_fp32_asym": ((1000, 1004), 128, "float32", 8, False),
    "tail_bf16": ((999, 1000), 2048, "bfloat16", 8, True),
    "first_g100_fp32": ((300, 77), 100, "float32", 8, False),
    "first_g8_bf16": ((64, 40), 8, "bfloat16", 8, True),
    "first_g16384_bf16": ((3, 20000), 16384, "bfloat16", 8, True),
    "first_odd_n": ((999, 1001), 128, "bfloat16", 8, True),
    "first_offset2": ((1000, 1024), 128, "bfloat16", 8, True),
}
_DTYPE = {"bfloat16": 0, "float16": 1, "float32": 2}


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(sources):
    """One library per (name, source text), all nvcc started together;
    returns {name: lib}."""
    from deepspeed_tpu_torch.ops import builder

    out_dir = builder.BUILD_DIR / "bench_quant"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [builder.nvcc(), *builder._flags("quantization"), "-I",
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
                 if "Function properties" in ln and "quant_ring" in ln]
        warn = [ln for ln in lines if "warning" in ln]
        print(f"[{name}] ptxas, quant_ring: {props}; warnings: {warn}",
              flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        lib.dstpu_quantize.argtypes = [ptr, i32, ptr, ptr, ptr, i64, i64,
                                       i32, f32, f32, f32, i32, ptr]
        lib.dstpu_quantize.restype = i32
        lib.dstpu_dequantize.argtypes = [ptr, ptr, ptr, ptr, i32, i64, i32,
                                         ptr]
        lib.dstpu_dequantize.restype = i32
        libs[name] = lib
    return libs


def make_input(name, spec, seed):
    """Rows of mixed magnitude, as trained weights have; ``first_offset2``
    is a view 2 bytes past a 16-byte boundary."""
    shape, gs, dtype, bits, sym = spec
    g = torch.Generator(device="cuda").manual_seed(seed)
    rows = shape[0] if len(shape) > 1 else 1 << 12
    n = 1
    for d in shape:
        n *= d
    x = (torch.randn(rows, n // rows, generator=g, device="cuda") *
         torch.rand(rows, 1, generator=g, device="cuda") * 3
         ).to(getattr(torch, dtype))
    if name == "first_offset2":
        x = torch.cat([torch.zeros(1, dtype=x.dtype, device="cuda"),
                       x.reshape(-1)])[1:]
        assert x.data_ptr() % 16 == 2
    return x.reshape(shape)


class Quant:
    """One build's quantize (and dequantize) on fixed inputs, outputs
    allocated once, so that it can be captured in a CUDA graph."""

    def __init__(self, lib, x, gs, bits, sym):
        n = x.numel()
        self.groups = -(-n // gs)
        self.v = torch.empty(self.groups, gs, dtype=torch.int8,
                             device=x.device)
        self.s = torch.empty(self.groups, 1, device=x.device)
        self.o = torch.empty_like(self.s)
        self.back = torch.empty_like(x)
        q_max = float(2 ** (bits - 1) - 1)
        self.qargs = [x.data_ptr(), _DTYPE[str(x.dtype)[6:]],
                      self.v.data_ptr(), self.s.data_ptr(),
                      self.o.data_ptr(), n, self.groups, gs, q_max,
                      2.0 * q_max, 1e-12, int(sym)]
        self.dargs = [self.v.data_ptr(), self.s.data_ptr(),
                      self.o.data_ptr(), self.back.data_ptr(),
                      _DTYPE[str(x.dtype)[6:]], n, gs]
        self.lib = lib

    def quantize(self):
        err = self.lib.dstpu_quantize(
            *self.qargs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"quantize launch failed: error {err}")

    def dequantize(self):
        err = self.lib.dstpu_dequantize(
            *self.dargs, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dequantize launch failed: error {err}")


def bits_of(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check(call, x, spec):
    """Payload, scale, offset and dequantized output bit-identical to the
    plain versions, and a second call bit-identical to the first."""
    from deepspeed_tpu_torch.ops import quantization as qz

    _, gs, _, bits, sym = spec
    call.quantize()
    call.dequantize()
    first = [call.v.clone(), bits_of(call.s).clone(),
             bits_of(call.o).clone()]
    call.quantize()
    torch.cuda.synchronize()
    want = qz.quantize_reference(x, num_bits=bits, group_size=gs,
                                 symmetric=sym)
    want_back = qz.dequantize_reference(want)
    return [torch.equal(call.v, want.values),
            torch.equal(bits_of(call.s), bits_of(want.scale)),
            torch.equal(bits_of(call.o), bits_of(want.offset)),
            torch.equal(bits_of(call.back), bits_of(want_back)),
            all(map(torch.equal, first,
                    (call.v, bits_of(call.s), bits_of(call.o))))]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variant", action="append", default=[],
                    metavar="NAME=PATH")
    ap.add_argument("--ablations", action="store_true")
    ap.add_argument("--check-only", action="store_true")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_quant: no CUDA GPU available", file=sys.stderr)
        return 2
    import chip_smoke
    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import quantization as qz

    card = card_name()
    print(card, flush=True)
    committed = (builder.CSRC / "quantization.cu").read_text()
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

    failed = []
    for i, (cname, spec) in enumerate({**TIMED, **CHECKS}.items()):
        x = make_input(cname, spec, 700 + i)
        for run, lib in libs.items():
            same = check(Quant(lib, x, spec[1], *spec[3:]), x, spec)
            print(f"check {cname} {list(spec[0])} groups of {spec[1]} "
                  f"{spec[2]} {spec[3]}-bit "
                  f"{'sym' if spec[4] else 'asym'} [{run}]: payload, "
                  f"scale, offset, output, twice: {same} "
                  f"{'ok' if all(same) else 'FAILED'}", flush=True)
            if not all(same):
                failed.append((cname, run))
        del x
        torch.cuda.empty_cache()
    if failed:
        print(f"FAILED against plain: {failed}", flush=True)
        return 1
    if args.check_only:
        return 0

    order = list(libs) + list(libs)[::-1]
    results = {"card": card, "reps": args.reps, "shapes": {}}
    for i, (cname, spec) in enumerate(TIMED.items()):
        shape, gs, dtype, bits, sym = spec
        x = make_input(cname, spec, 700 + i)
        calls = {run: Quant(lib, x, gs, bits, sym)
                 for run, lib in libs.items()}
        tq = {run: [] for run in libs}
        td = {run: [] for run in libs}
        for run in order:
            tq[run].append(chip_smoke.graph_ms(calls[run].quantize,
                                               args.reps))
            td[run].append(chip_smoke.graph_ms(calls[run].dequantize,
                                               args.reps))
        kw = dict(num_bits=bits, group_size=gs, symmetric=sym)
        qt = qz.quantize(x, **kw)
        host_q = chip_smoke.time_ms(lambda: qz.quantize(x, **kw), args.reps)
        host_d = chip_smoke.time_ms(lambda: qz.dequantize(qt), args.reps)
        bound, by = chip_smoke.quant_bound(x.numel(), gs, x.element_size())
        out = {run: {"quantize_min_ms": min(tq[run]),
                     "quantize_max_ms": max(tq[run]),
                     "quantize_of_bound": bound / min(tq[run]),
                     "dequantize_min_ms": min(td[run]),
                     "dequantize_max_ms": max(td[run]),
                     "dequantize_of_bound": bound / min(td[run])}
               for run in libs}
        results["shapes"][cname] = {
            "shape": list(shape), "group_size": gs, "dtype": dtype,
            "bits": bits, "symmetric": sym, "bound_ms": bound,
            "bound_by": by, "wrapper_host_loop_ms": {
                "quantize": host_q, "dequantize": host_d},
            "builds": out}
        print(f"{cname} {list(shape)} groups of {gs} {dtype} {bits}-bit: "
              f"bound {bound:.4f} ms ({by}); wrapper in a host loop "
              f"quantize {host_q:.4f} ms, dequantize {host_d:.4f} ms",
              flush=True)
        for run, r in out.items():
            print(f"  {run}: quantize {r['quantize_min_ms']:.4f}/"
                  f"{r['quantize_max_ms']:.4f} ms "
                  f"({r['quantize_of_bound']:.1%} of bound), dequantize "
                  f"{r['dequantize_min_ms']:.4f}/{r['dequantize_max_ms']:.4f}"
                  f" ms ({r['dequantize_of_bound']:.1%})", flush=True)
        del x, calls, qt
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
