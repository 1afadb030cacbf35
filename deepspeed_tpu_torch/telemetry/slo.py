"""SLO objectives, rolling-window error-budget burn, tail sampling.

An objective is a string like ``"ttft_ms_p99 <= 150"``: the ``_pNN``
suffix names the percentile target (99% of samples must satisfy the
threshold), so the error budget is ``1 - 0.99 = 1%``.  ``SLOSet``
keeps a rolling time window of per-sample pass/fail and reports the
classic burn rate::

    burn_rate = observed_error_rate / error_budget

``burn_rate <= 1`` means the objective is healthy at steady state; 10
means the budget burns 10x too fast.  Clock is injectable (tests pin a
``ManualClock``), window arithmetic is plain deque-pruning — no
background thread.

``TailSampler`` is the promotion policy for tail-based trace sampling
(``DSTPU_TRACE_SAMPLE``): every finished request asks ``should_promote``
and the tracer copies that request's spans from the always-on staging
rings into the retained ring only when the request breached an SLO,
errored, or fell in a deterministic 1-in-N sample (seeded injectable
RNG — replayable in tests).
"""
from __future__ import annotations

import random
import re
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple, Union

__all__ = ["Objective", "parse_objective", "SLOSet", "TailSampler"]

_OBJ_RE = re.compile(
    r"^\s*([A-Za-z][A-Za-z0-9_]*?)_p(\d{1,2}(?:\.\d+)?)\s*(<=?)\s*"
    r"([0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*$")


class Objective:
    """One parsed objective: ``metric`` samples must be ``<= threshold``
    for at least ``target`` (fraction) of the window."""

    __slots__ = ("name", "metric", "target", "threshold")

    def __init__(self, name: str, metric: str, target: float,
                 threshold: float):
        if not (0.0 < target < 1.0):
            raise ValueError(f"{name}: target must be in (0, 1)")
        self.name = name
        self.metric = metric
        self.target = target
        self.threshold = threshold

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def __repr__(self):
        return (f"Objective({self.name!r}: {self.metric} p"
                f"{self.target * 100:g} <= {self.threshold:g})")


def parse_objective(spec: Union[str, Objective]) -> Objective:
    """``"ttft_ms_p99 <= 150"`` -> Objective(metric="ttft_ms",
    target=0.99, threshold=150).  ``p99.9`` sets target 0.999."""
    if isinstance(spec, Objective):
        return spec
    m = _OBJ_RE.match(str(spec))
    if not m:
        raise ValueError(
            f"bad SLO objective {spec!r} (want e.g. 'ttft_ms_p99 <= 150')")
    metric, pct, _op, thr = m.groups()
    target = float(pct) / 100.0
    name = f"{metric}_p{pct}"
    return Objective(name, metric, target, float(thr))


class SLOSet:
    """Rolling-window evaluation of a set of objectives.

    ``record(metric, value)`` feeds one sample to every objective on
    that metric and returns the names of objectives whose *sample*
    breached its threshold (the per-request signal the tail sampler
    promotes on).  ``evaluate()`` returns the window-level state:
    error rate, remaining budget, burn rate.
    """

    def __init__(self, objectives: Sequence[Union[str, Objective]],
                 window_s: float = 300.0,
                 clock: Callable[[], float] = time.monotonic):
        self.objectives: List[Objective] = [parse_objective(o)
                                            for o in objectives]
        names = [o.name for o in self.objectives]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SLO objectives: {names}")
        self.window_s = float(window_s)
        self.clock = clock
        # per-objective deque of (t, breached) samples inside the window
        self._samples: Dict[str, deque] = {o.name: deque()
                                           for o in self.objectives}
        self.total_samples = 0
        self.total_breaches = 0

    def _prune(self, dq: deque, now: float) -> None:
        horizon = now - self.window_s
        while dq and dq[0][0] < horizon:
            dq.popleft()

    def record(self, metric: str, value: float) -> List[str]:
        """Feed one sample; returns names of objectives this sample
        breached (empty when healthy or when no objective watches
        ``metric``)."""
        breached: List[str] = []
        now = self.clock()
        for o in self.objectives:
            if o.metric != metric:
                continue
            bad = value > o.threshold
            dq = self._samples[o.name]
            dq.append((now, bad))
            self._prune(dq, now)
            self.total_samples += 1
            if bad:
                self.total_breaches += 1
                breached.append(o.name)
        return breached

    def record_request(self, rec: Dict[str, Any]) -> List[str]:
        """Feed every numeric field of a per-request summary dict (the
        ``RequestLatencyTracker.on_finish`` return value); missing
        metrics are skipped."""
        breached: List[str] = []
        seen = set()
        for o in self.objectives:
            if o.metric in seen:        # record() covers every objective
                continue                # on the metric in one call
            seen.add(o.metric)
            v = rec.get(o.metric)
            if isinstance(v, (int, float)) and not isinstance(v, bool):
                breached.extend(self.record(o.metric, float(v)))
        return breached

    def evaluate(self) -> Dict[str, Dict[str, Any]]:
        """Window-level state per objective (all scalars — monitor and
        export_json embed it directly)."""
        now = self.clock()
        out: Dict[str, Dict[str, Any]] = {}
        for o in self.objectives:
            dq = self._samples[o.name]
            self._prune(dq, now)
            n = len(dq)
            bad = sum(1 for _t, b in dq if b)
            err = (bad / n) if n else 0.0
            budget = o.budget
            if budget > 0:
                burn = err / budget
            else:                      # pragma: no cover - target<1 enforced
                burn = float("inf") if bad else 0.0
            out[o.name] = {
                "metric": o.metric,
                "threshold": o.threshold,
                "target": o.target,
                "window_s": self.window_s,
                "samples": n,
                "breaches": bad,
                "error_rate": round(err, 6),
                "error_budget": round(budget, 6),
                "burn_rate": round(burn, 6),
                "ok": burn <= 1.0,
            }
        return out

    def flat_summary(self) -> Dict[str, Any]:
        """One level of scalars for ``serving_stages()["slo"]`` (the
        MonitorMaster flattening contract)."""
        out: Dict[str, Any] = {}
        for name, st in self.evaluate().items():
            out[f"{name}_burn_rate"] = st["burn_rate"]
            out[f"{name}_error_rate"] = st["error_rate"]
            out[f"{name}_samples"] = st["samples"]
            out[f"{name}_breaches"] = st["breaches"]
            out[f"{name}_ok"] = int(st["ok"])
        return out


class TailSampler:
    """Promotion policy: breach / error always promote; otherwise a
    deterministic 1-in-N draw on the injected RNG (``n <= 0`` disables
    the random arm — only breaches/errors are retained)."""

    def __init__(self, n: int = 0, seed: int = 0,
                 rng: Optional[random.Random] = None):
        self.n = int(n)
        self.rng = rng if rng is not None else random.Random(seed)
        self.decisions = 0
        self.promoted_breach = 0
        self.promoted_error = 0
        self.promoted_sample = 0
        self.dropped = 0

    def should_promote(self, breached: bool = False, errored: bool = False
                       ) -> Tuple[bool, str]:
        """Returns ``(promote, reason)``; reason in
        {"slo_breach", "error", "sample", ""}.  The RNG is consumed on
        *every* decision (even breach-promoted ones) so the 1-in-N
        stream stays aligned with the request stream — decision k for a
        given seed is the same regardless of interleaved breaches."""
        self.decisions += 1
        draw = self.rng.random() if self.n > 0 else 1.0
        if breached:
            self.promoted_breach += 1
            return True, "slo_breach"
        if errored:
            self.promoted_error += 1
            return True, "error"
        if self.n > 0 and draw * self.n < 1.0:
            self.promoted_sample += 1
            return True, "sample"
        self.dropped += 1
        return False, ""

    def counters(self) -> Dict[str, int]:
        return {
            "decisions": self.decisions,
            "promoted_breach": self.promoted_breach,
            "promoted_error": self.promoted_error,
            "promoted_sample": self.promoted_sample,
            "dropped": self.dropped,
        }
