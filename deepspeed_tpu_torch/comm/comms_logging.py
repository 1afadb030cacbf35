"""Communication op logging.

Counterpart of ``deepspeed_tpu/comm/comms_logging.py`` (the reference's
``deepspeed/utils/comms_logging.py:67`` ``CommsLogger`` and ``get_bw``):
every collective issued through ``deepspeed_tpu_torch.comm`` is recorded
(name, message size, group size, latency) while the logger is enabled,
and ``log_summary`` prints the per-op table with algorithmic and bus
bandwidth.

A collective on CUDA tensors is timed by two CUDA events around it on the
current stream (NCCL orders its stream after and before that one), so
recording it reads nothing on the host; the events are read when a
summary or a mean latency is asked for.  A CPU (gloo) collective returns
when it is done and is timed on the host clock.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

from deepspeed_tpu_torch.utils.logging import logger


def get_bw(comm_op: str, size_bytes: int, duration_s: float,
           n: int) -> Dict[str, float]:
    """Algorithmic / bus bandwidth in GB/s (reference ``get_bw``)."""
    if duration_s <= 0:
        return {"algbw": 0.0, "busbw": 0.0}
    tput = size_bytes / duration_s
    if comm_op in ("all_to_all", "all_to_all_single", "all_gather",
                   "all_gather_into_tensor", "reduce_scatter",
                   "reduce_scatter_tensor"):
        busbw = tput * ((n - 1) / n) if n > 0 else tput
    elif comm_op in ("all_reduce",):
        busbw = tput * (2 * (n - 1) / n) if n > 0 else tput
    else:
        busbw = tput
    return {"algbw": tput / 1e9, "busbw": busbw / 1e9}


def calc_bw_log(comm_op: str, size: int, duration: float, n: int):
    bws = get_bw(comm_op, size, duration, n)
    return bws["algbw"], bws["busbw"]


def convert_size(size_bytes: int) -> str:
    if size_bytes == 0:
        return "0B"
    names = ("B", "KB", "MB", "GB", "TB", "PB")
    i = int(math.floor(math.log(size_bytes, 1024)))
    p = math.pow(1024, i)
    return f"{round(size_bytes / p, 2)} {names[i]}"


class EventPair:
    """A CUDA collective's start and end events; ``seconds()`` waits for
    the end event and reads the time between them."""

    __slots__ = ("start", "end")

    def __init__(self, start, end):
        self.start, self.end = start, end

    def seconds(self) -> float:
        self.end.synchronize()
        return self.start.elapsed_time(self.end) / 1e3


def _seconds(lat) -> float:
    return lat.seconds() if isinstance(lat, EventPair) else float(lat)


class CommsLogger:
    """Per-op record book (reference ``CommsLogger``)."""

    def __init__(self, enabled: bool = False, verbose: bool = False,
                 prof_all: bool = True, debug: bool = False,
                 prof_ops: Optional[List[str]] = None):
        self.enabled = enabled
        self.verbose = verbose
        self.prof_all = prof_all
        self.debug = debug
        self.prof_ops = prof_ops or []
        # name -> msg_size -> [count, latencies, world, op]
        self.comms_dict: Dict[str, Dict[int, list]] = {}

    def configure(self, config) -> None:
        self.enabled = config.enabled
        self.verbose = config.verbose
        self.prof_all = config.prof_all
        self.debug = config.debug
        self.prof_ops = list(config.prof_ops)

    def should_profile(self, op_name: str) -> bool:
        if not self.enabled:
            return False
        if self.prof_ops:
            return op_name in self.prof_ops
        return self.prof_all

    def append(self, op_name: str, size: int, world: int, latency=None,
               log_name: Optional[str] = None) -> None:
        """Record one call; ``latency`` is seconds, an :class:`EventPair`
        or ``None``."""
        if not self.should_profile(op_name):
            return
        key = log_name or op_name
        rec = self.comms_dict.setdefault(key, {}).setdefault(
            size, [0, [], world, op_name])
        rec[0] += 1
        if latency is not None:
            rec[1].append(latency)
        rec[2] = world
        if self.verbose:
            logger.info(f"comm op: {key} ({op_name}) | msg size: "
                        f"{convert_size(size)} | world: {world}")

    def counts(self) -> Dict[str, int]:
        """``{name: calls}`` over every message size."""
        return {name: sum(rec[0] for rec in sizes.values())
                for name, sizes in self.comms_dict.items()}

    def per_op_mean_latency(self) -> Dict[str, Dict[str, float]]:
        """``{name: {"mean_s", "count"}}`` over every timed call, all
        message sizes pooled: the local half of the cross-rank straggler
        aggregation."""
        out: Dict[str, Dict[str, float]] = {}
        for name, sizes in self.comms_dict.items():
            lats = [_seconds(x) for rec in sizes.values() for x in rec[1]]
            if lats:
                out[name] = {"mean_s": sum(lats) / len(lats),
                             "count": len(lats)}
        return out

    @staticmethod
    def render_straggler_report(report: Dict[str, Dict]) -> str:
        """Human-readable lines for a cross-rank straggler report."""
        lines = ["cross-rank straggler report:"]
        if not report:
            lines.append("  (no cross-rank timing data)")
        for op, rec in sorted(report.items()):
            per_rank = ", ".join(f"r{i}={m:.2f}" for i, m in
                                 enumerate(rec["per_rank_ms"]))
            if rec["straggler_rank"] is not None:
                lines.append(
                    f"  {op}: STRAGGLER rank {rec['straggler_rank']} — "
                    f"peers wait {rec['spread_ms']:.2f} ms for it "
                    f"(per-rank mean ms: {per_rank})")
            else:
                lines.append(f"  {op}: no straggler (spread "
                             f"{rec['spread_ms']:.2f} ms; per-rank mean "
                             f"ms: {per_rank})")
        return "\n".join(lines)

    def log_summary(self, show_straggler: bool = False) -> str:
        lines = [f"{'Comm. Op':<25}{'Message Size':<18}{'Count':<8}"
                 f"{'Total Lat(ms)':<16}{'Avg Lat(ms)':<14}"
                 f"{'algbw(Gbps)':<14}{'busbw(Gbps)':<14}"]
        for name, sizes in sorted(self.comms_dict.items()):
            for size, (count, lats, world, op) in sorted(sizes.items()):
                if not lats:
                    lines.append(f"{name:<25}{convert_size(size):<18}"
                                 f"{count:<8}{'-':<16}{'-':<14}{'-':<14}"
                                 f"{'-':<14}")
                    continue
                secs = [_seconds(x) for x in lats]
                total = sum(secs)
                avg = total / len(secs)
                algbw, busbw = calc_bw_log(op, size, avg, world)
                lines.append(
                    f"{name:<25}{convert_size(size):<18}{count:<8}"
                    f"{total * 1000:<16.2f}{avg * 1000:<14.2f}"
                    f"{algbw * 8:<14.2f}{busbw * 8:<14.2f}")
                if show_straggler:
                    lines.append(f"{'':<25}{'straggler effect':<18}"
                                 f"{(max(secs) - avg) * 1000:.2f} ms")
        out = "\n".join(lines)
        logger.info("\n" + out)
        return out

    def reset(self) -> None:
        self.comms_dict = {}
