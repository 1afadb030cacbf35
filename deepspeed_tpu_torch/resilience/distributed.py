"""Distributed-health layer: cross-process failure detection.

Counterpart of ``deepspeed_tpu/resilience/distributed.py`` over
``torch.distributed``:

- :class:`CollectiveTimeout`, raised by the collective watchdog
  (``comm/watchdog.py``) when a collective exceeds its deadline instead
  of hanging until an outer harness kills the job;
- :class:`DesyncDetector`, a periodic cross-rank comparison of values
  that must be equal on every rank (loss, grad norm), raising
  :class:`~deepspeed_tpu_torch.resilience.guards.GradientAnomalyError`
  on a mismatch;
- :func:`build_straggler_report`, which names the straggler rank from
  cross-rank per-op collective timings (the rank everyone waits for
  arrives last and therefore waits least: the argmin of mean latency).

This module must not import ``deepspeed_tpu_torch.comm`` at module
scope: the watchdog imports :class:`CollectiveTimeout` from here.
"""
from __future__ import annotations

from typing import Any, Dict, List

import numpy as np
import torch.distributed as dist

from deepspeed_tpu_torch.resilience.guards import GradientAnomalyError

__all__ = ["CollectiveTimeout", "DesyncDetector", "build_straggler_report",
           "allgather_json"]


class CollectiveTimeout(RuntimeError):
    """A collective (or barrier) exceeded the watchdog deadline: a peer
    dropped the collective, died mid-collective, or the transport
    wedged.  The process must abort rather than hang."""


def _distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    return dist.get_rank() if _distributed() else 0


def allgather_json(obj: Any) -> List[Any]:
    """Gather one small picklable object per process (one
    ``all_gather_object``).  Without a process group: ``[obj]``."""
    if not _distributed() or dist.get_world_size() == 1:
        return [obj]
    out: List[Any] = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


class DesyncDetector:
    """Periodic cross-rank comparison of values that must be equal on
    every rank.  ``check`` exchanges named local scalars across processes
    and raises :class:`GradientAnomalyError` when any of them disagree
    beyond ``tolerance``.  Off by default; the engine builds one when
    ``resilience.comm.desync_interval > 0``."""

    def __init__(self, interval: int, tolerance: float = 0.0):
        assert interval > 0, "use interval > 0 (0 means: no detector)"
        self.interval = int(interval)
        self.tolerance = float(tolerance)
        self.checks = 0
        self.mismatches = 0

    def should_check(self, step: int) -> bool:
        return step > 0 and step % self.interval == 0

    def check(self, values: Dict[str, float], step: int) -> bool:
        """Cross-check ``{name: local_scalar}``; raises on divergence."""
        self.checks += 1
        per_rank = allgather_json({"rank": _rank(), "values": values})
        bad = []
        for name in values:
            vals = [float(r["values"][name]) for r in per_rank]
            good = [v for v in vals if np.isfinite(v)]
            spread = (max(good) - min(good)) if good else float("inf")
            if len(good) < len(vals) or spread > self.tolerance:
                bad.append((name, vals))
        if not bad:
            return True
        self.mismatches += 1
        detail = "; ".join(
            f"{name}: " + ", ".join(f"rank{i}={v:.6g}"
                                    for i, v in enumerate(vals))
            for name, vals in bad)
        raise GradientAnomalyError(
            f"cross-rank desync at step {step}: {detail} — ranks hold "
            "different values for replica-identical state (a corrupted "
            "collective or diverged host-side stream). Abort and resume "
            "from the last verified checkpoint "
            "(resilience.comm.desync_interval controls this check).")


def build_straggler_report(per_rank: List[Dict[str, Any]],
                           min_spread_s: float = 0.020,
                           min_ratio: float = 2.0) -> Dict[str, Dict]:
    """Name the straggler per op from cross-rank mean latencies.

    ``per_rank[r]`` maps ``op -> {"mean_s": float, "count": int}`` for
    rank ``r``.  The straggler is the rank with the SMALLEST mean wait.
    An op is flagged only when the max/min spread clears both an absolute
    floor (``min_spread_s``) and a ratio (``min_ratio``)."""
    ops = sorted({op for r in per_rank for op in r})
    report: Dict[str, Dict] = {}
    for op in ops:
        means = [float(r[op]["mean_s"]) if op in r else float("nan")
                 for r in per_rank]
        known = [(i, m) for i, m in enumerate(means) if np.isfinite(m)]
        if len(known) < 2:
            continue
        lo_rank, lo = min(known, key=lambda t: t[1])
        hi_rank, hi = max(known, key=lambda t: t[1])
        spread = hi - lo
        flagged = (spread >= min_spread_s
                   and hi >= min_ratio * max(lo, 1e-9))
        report[op] = {
            "straggler_rank": lo_rank if flagged else None,
            "spread_ms": round(spread * 1e3, 3),
            "min_ms": round(lo * 1e3, 3),
            "max_ms": round(hi * 1e3, 3),
            "slowest_peer_rank": hi_rank,
            "per_rank_ms": [round(m * 1e3, 3) for m in means],
        }
    return report
