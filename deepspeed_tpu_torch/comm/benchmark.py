"""Collective micro-benchmark (``ds_bench`` equivalent).

Counterpart of ``deepspeed_tpu/comm/benchmark.py``: times each collective
of ``deepspeed_tpu_torch.comm`` across message sizes and reports
algorithmic and bus bandwidth (the formulas of ``comms_logging.get_bw``).
A size is the per-rank message in bytes (fp32 elements), the ds_bench
convention.  CUDA collectives are timed with CUDA events around a run of
``trials`` calls, CPU (gloo) ones on the host clock.

Run one process per GPU::

    torchrun --nproc_per_node=N -m deepspeed_tpu_torch.comm.benchmark \\
        [--ops all_reduce ...] [--maxsize 26]

or ``--device cpu`` for gloo over CPU processes.
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

import deepspeed_tpu_torch.comm as dist
from deepspeed_tpu_torch.comm.comms_logging import get_bw

OPS = ("all_reduce", "all_gather", "reduce_scatter", "all_to_all",
       "broadcast")


def _run_op(op: str, x: torch.Tensor, group):
    fn = getattr(dist, op)
    if op == "broadcast":
        return fn(x, src=0, group=group)
    return fn(x, group=group)


def time_collective(op: str, nbytes: int, group=None, trials: int = 20,
                    warmups: int = 5, device: str = "cuda"
                    ) -> Dict[str, float]:
    world = dist.get_world_size(group)
    # reduce_scatter and all_to_all cut the message into world pieces
    n = max(nbytes // 4 // world, 1) * world
    dev = torch.device("cuda", dist.get_local_rank()) \
        if device == "cuda" else torch.device("cpu")
    x = torch.ones(n, dtype=torch.float32, device=dev)
    for _ in range(warmups):
        _run_op(op, x, group)
    if dev.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        for _ in range(trials):
            _run_op(op, x, group)
        end.record()
        end.synchronize()
        dt = start.elapsed_time(end) / 1e3 / trials
    else:
        t0 = time.perf_counter()
        for _ in range(trials):
            _run_op(op, x, group)
        dt = (time.perf_counter() - t0) / trials
    bws = get_bw(op, n * 4, dt, world)
    return {"size_bytes": n * 4, "latency_us": dt * 1e6,
            "algbw_gbps": bws["algbw"], "busbw_gbps": bws["busbw"]}


def run_benchmark(ops: List[str], max_log_size: int = 24,
                  min_log_size: int = 12, trials: int = 20,
                  device: str = "cuda") -> None:
    dist.init_distributed(device=device)
    topo = dist.get_topology()
    rank0 = dist.get_rank() == 0
    if rank0:
        print(f"# comms benchmark: {topo.describe()}")
    for op in ops:
        if rank0:
            print(f"\n## {op}")
            print(f"{'size':>12} {'latency(us)':>14} {'algbw(GB/s)':>12} "
                  f"{'busbw(GB/s)':>12}")
        for p in range(min_log_size, max_log_size + 1, 2):
            r = time_collective(op, 1 << p, trials=trials, device=device)
            if rank0:
                print(f"{r['size_bytes']:>12} {r['latency_us']:>14.1f} "
                      f"{r['algbw_gbps']:>12.2f} {r['busbw_gbps']:>12.2f}")
    dist.destroy_process_group()


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ops", nargs="*", default=["all_reduce"],
                   choices=list(OPS) + ["all"])
    p.add_argument("--maxsize", type=int, default=24,
                   help="log2 of the largest message in bytes")
    p.add_argument("--minsize", type=int, default=12)
    p.add_argument("--trials", type=int, default=20)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args()
    ops = list(OPS) if "all" in args.ops else args.ops
    run_benchmark(ops, args.maxsize, args.minsize, args.trials, args.device)


if __name__ == "__main__":
    main()
