#!/usr/bin/env python3
"""Time the port's ragged paged-attention kernels (#9 over bf16 pages, #8
over int8 and e4m3 pages) on one GPU, with other builds of the same C
entry point in the same process.

    python3 scripts/bench_paged_attn.py [--ablations] [--check-only]
                                        [--variant NAME=PATH ...]
                                        [--reps 20] [--out FILE]

``kernel`` is ``ops/csrc/ragged_paged_attn.cu`` as committed.
``--variant`` adds another source of ``dstpu_ragged_paged_attn`` (for
example the parent commit's, from ``git show HEAD:...`` into a
git-ignored directory); a source without split scratch, or without the
carry operand, is called with its older argument list (no carry is
passed: the timed shapes have none).  ``--ablations`` adds builds of
the committed source with one design choice changed each: ``stages2`` (a ring of two
stages for every page type instead of three for bf16 and four for
1-byte pages) and ``one_warp`` (one warp per 16 rows at decode, so three
of four idle, instead of all four sharing the keys); and ``no_split``,
the committed build called with one split for every shape.  Every build
is checked against the plain versions (``ref_paged_attention``,
``ref_paged_attention_quant``) within ``chip_smoke.py``'s phase-5 limits
(2e-3 absolute plus 2e-2 relative), padding rows exactly 0, and two calls
bit-identical; ``--check-only`` stops there.  Then all are timed in turns
(A B .. B A) at the smoke's decode shape (16 x 1 token over 128..2048
keys), its mixed shape (8 decode tokens and a 512-token chunk over 1500
keys), a few-sequence decode (2 x 2048 keys) and a long decode (16 x
8192 keys), H32/8 D128 with 64-row pages, over bf16, int8 and e4m3
pages.  Device time is a CUDA graph of ``--reps`` calls replayed
(``chip_smoke.graph_ms``: the wrapper's Python checks, allocation and
ctypes call are not in it); the committed kernel is also timed through
its wrapper in a host loop (``chip_smoke.time_ms``), which is what an
uncaptured caller sees.  It prints the card's name and
power limit, min and max ms per build, and the share of the bound from
``chip_smoke.paged_bound``; ``--out`` writes them as JSON.  Needs a CUDA
GPU.
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

PAGED_ATOL, PAGED_RTOL = 2e-3, 2e-2          # chip_smoke.py phase 5
# (old, new) text of the committed source for each ablation build
ABLATIONS = {
    "stages2": [(
        "  static constexpr int STAGES = sizeof(typename P::T) == 2 ? 3 : 4;",
        "  static constexpr int STAGES = 2;")],
    "one_warp": [(
        "  const int kw = u.live_rows <= WM ? 4 : u.live_rows <= 2 * WM ? 2 "
        ": 1;", "  const int kw = 1;")],
}
DECODE = ([1] * 16, [128 * (j + 1) for j in range(16)])
MIXED = ([1] * 8 + [512], [128 + 256 * j for j in range(8)] + [1500])
TIMED = {
    "decode": (DECODE, {}),
    "mixed": (MIXED, {}),
    "few_decode": (([1, 1], [2048, 2048]), {}),
    "long_decode": (([1] * 16, [8192] * 16), {}),
}
# more shapes for the checks: windows and holes across split boundaries,
# kv_len at a split boundary and one key past it, D 64 with 16-row pages,
# 128-row pages
CHECKS = {
    "window": (MIXED, {"window": 256}),
    "decode_window": (DECODE, {"window": 300}),
    "holes": (([1] * 4 + [200], [700, 900, 1000, 1300, 1500]),
              {"holes": True, "pad": 7}),
    "holes_decode": (([1], [1000]), {"holes": True}),
    "boundary": (([1] * 4, [256, 257, 512, 513]), {}),
    "one_long": (([1] * 7 + [1], [1] * 7 + [2048]), {}),
    "d64_page16": (([1] * 8 + [40], [100 * (j + 1) for j in range(9)]),
                   {"D": 64, "H": 16, "Hkv": 4, "page": 16, "pad": 3}),
    "page128": (([1] * 6 + [3], [300 * (j + 1) for j in range(7)]),
                {"page": 128}),
}
PDTYPES = ("bfloat16", "int8", "float8_e4m3fn")


def card_name() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()


def build(sources):
    """One library per (name, source text), all nvcc started together;
    returns {name: (lib, abi)}."""
    from deepspeed_tpu_torch.ops import builder

    out_dir = builder.BUILD_DIR / "bench_paged_attn"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = out_dir / f"{name}.cu"
        src.write_text(text)
        cmd = [builder.nvcc(), *builder._flags("ragged_paged_attn"), "-I",
               str(builder.CSRC), "-o", str(out_dir / f"lib{name}.so"),
               str(src)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                       stderr=subprocess.STDOUT, text=True)
    libs = {}
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lines = log.splitlines()
        mma = [f"{ln.split('Function properties for ')[1]}: "
               f"{lines[i + 1].strip()}; {lines[i + 2].split(': ')[-1]}"
               for i, ln in enumerate(lines)
               if "Function properties" in ln and "rpa_simt" not in ln]
        warn = [ln for ln in lines if "warning" in ln]
        print(f"[{name}] ptxas, bf16-query kernels: {mma}; warnings: "
              f"{warn}", flush=True)
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        # 0: no split scratch, 1: split scratch, 2: and the carry operand
        abi = (2 if "carry_acc" in sources[name] else
               1 if "part_acc" in sources[name] else 0)
        lib.dstpu_ragged_paged_attn.argtypes = (
            [ptr] * (8 + 3 * abi) + [i32] * (10 + 2 * (abi > 0)) +
            [ctypes.c_float, ptr])
        lib.dstpu_ragged_paged_attn.restype = i32
        libs[name] = (lib, abi)
    return libs


class Call:
    """One build's call on fixed inputs, outputs and scratch allocated
    once, so that it can be captured in a CUDA graph."""

    def __init__(self, lib, abi, q, pages, scales, meta, window,
                 plan=None):
        from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

        T, H, D = q.shape
        _, page, combined, _ = pages.shape
        S, pp = meta[1].shape
        self.o = torch.empty_like(q)
        splits, stages = plan or rpa.split_plan(T, S, H, combined // 2, pp,
                                                page)
        self.stats = None
        parts = []
        if abi:
            parts = [None] * (3 * abi)
            if splits > 1:
                n = splits * T * H
                self.stats = torch.empty(n * (D + 2), device=q.device)
                parts[:3] = [self.stats[:n].data_ptr(),
                             self.stats[n:2 * n].data_ptr(),
                             self.stats[2 * n:].data_ptr()]
        head = [q.data_ptr(), pages.data_ptr(),
                None if scales is None else scales.data_ptr(),
                self.o.data_ptr(), *(m.data_ptr() for m in meta), *parts,
                0, rpa._PAGE_DTYPES[pages.dtype], T, H, combined // 2, D,
                S, pp, page, window or 0]
        self.args = head + ([splits, stages] if abi else [])
        self.fn = lib.dstpu_ragged_paged_attn
        self.scale = D ** -0.5
        self.splits = splits if abi else 1

    def __call__(self):
        stream = torch.cuda.current_stream().cuda_stream
        err = self.fn(*self.args, self.scale, stream)
        if err:
            raise RuntimeError(f"launch failed: error {err}")
        return self.o


def make_case(name, spec, pdtype, seed):
    import chip_smoke

    (q_lens, kv_lens), opt = spec
    opt = dict(opt)
    window = opt.pop("window", None)
    q, pages, scales, meta = chip_smoke.paged_case(
        seed, q_lens, kv_lens, pdtype=getattr(torch, pdtype), **opt)
    return q, pages, scales, meta, window, q_lens, kv_lens


def plain(q, pages, scales, meta, window):
    from deepspeed_tpu_torch.inference import paged

    sm = q.shape[-1] ** -0.5
    if scales is None:
        return paged.ref_paged_attention(q, pages, *meta, sm_scale=sm,
                                         sliding_window=window)
    return paged.ref_paged_attention_quant(q, pages, scales, *meta,
                                           sm_scale=sm,
                                           sliding_window=window)


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
        print("bench_paged_attn: no CUDA GPU available", file=sys.stderr)
        return 2
    import chip_smoke
    from deepspeed_tpu_torch.ops import builder
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    card = card_name()
    print(card, flush=True)
    committed = (builder.CSRC / "ragged_paged_attn.cu").read_text()
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
    # (build, plan override): no_split is the committed build, one split
    runs = {name: (name, None) for name in libs}
    if args.ablations:
        runs["no_split"] = ("kernel", "one")

    def call_of(run, case):
        lib, abi = libs[runs[run][0]]
        q, pages, scales, meta, window = case[:5]
        plan = None
        if runs[run][1] == "one":
            plan = (1, -(-meta[1].shape[1] * pages.shape[1] // 64))
        return Call(lib, abi, q, pages, scales, meta, window, plan)

    failed = []
    shapes = {**TIMED, **CHECKS}
    for i, (sname, spec) in enumerate(shapes.items()):
        for pd in PDTYPES:
            case = make_case(sname, spec, pd, i)
            want = plain(*case[:5]).float()
            n_real = sum(case[5])
            for run in runs:
                call = call_of(run, case)
                got = call().clone()
                again = call()
                torch.cuda.synchronize()
                err = (got.float() - want).abs()
                ok = bool((err <= PAGED_ATOL + PAGED_RTOL * want.abs()).all())
                ok &= bool(torch.isfinite(got.float()).all())
                ok &= bool((got[n_real:] == 0).all())
                ok &= torch.equal(got, again)
                print(f"check {sname} {pd} [{run}] splits {call.splits}: "
                      f"max|o-plain| {err.max().item():.3e} "
                      f"{'ok' if ok else 'FAILED'}", flush=True)
                if not ok:
                    failed.append((sname, pd, run))
            del case, want
    if failed:
        print(f"FAILED against plain: {failed}", flush=True)
        return 1
    if args.check_only:
        return 0

    order = list(runs) + list(runs)[::-1]
    results = {"card": card, "reps": args.reps, "shapes": {}}
    for i, (sname, spec) in enumerate(TIMED.items()):
        for pd in PDTYPES:
            case = make_case(sname, spec, pd, i)
            q, pages, scales, meta, window, q_lens, kv_lens = case
            calls = {run: call_of(run, case) for run in runs}
            times = {run: [] for run in runs}
            for run in order:
                times[run].append(chip_smoke.graph_ms(calls[run], args.reps))
            fn = rpa.ragged_paged_attention if scales is None else \
                rpa.ragged_paged_attention_quant
            extra = () if scales is None else (scales,)
            host = chip_smoke.time_ms(lambda: fn(q, pages, *extra, *meta,
                                                 sm_scale=q.shape[-1] ** -0.5),
                                      args.reps)
            bound, by = chip_smoke.paged_bound(
                q_lens, kv_lens, meta[1].cpu(), q.shape[1],
                pages.shape[2] // 2, q.shape[2], pages.shape[1], q.dtype,
                getattr(torch, pd), window)
            out = {run: {"min_ms": min(t), "max_ms": max(t),
                         "splits": calls[run].splits,
                         "of_bound": bound / min(t)}
                   for run, t in times.items()}
            results["shapes"][f"{sname}.{pd}"] = {
                "q_lens": q_lens, "kv_lens": kv_lens, "bound_ms": bound,
                "bound_by": by, "wrapper_host_loop_ms": host, "builds": out}
            print(f"{sname} {pd}: bound {bound:.4f} ms ({by}); wrapper in a "
                  f"host loop {host:.4f} ms", flush=True)
            for run, r in out.items():
                print(f"  {run} (splits {r['splits']}): {r['min_ms']:.4f}/"
                      f"{r['max_ms']:.4f} ms, {r['of_bound']:.1%} of bound",
                      flush=True)
            del case, q, pages, scales, meta, calls
            torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
