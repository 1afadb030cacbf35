"""Per-request serving latency: TTFT / TPOT / queue-wait / spill-stall.

Copy of ``deepspeed_tpu/telemetry/requests.py`` without its
metrics-registry feed and the replica and phase labels that only feed it
(they come with the telemetry port, ROADMAP A10).
The engine feeds the tracker from its lifecycle hooks (submit -> admit ->
token folds -> reap); ``summary()`` derives nearest-rank p50/p90/p99 over
completed requests and returns a FLAT dict.

Token timestamps are taken when the host folds device tokens back into
request state: the host cannot observe a token earlier than that.

- ``ttft``: first harvested token - submit (clamped at submit)
- ``tpot``: (last - first token) / (tokens - 1), requests with >= 2 tokens
- ``queue_wait``: first admit - submit
- ``router_queue_wait``: first admit - router accept (requests that came
  through a scale-out router; its own series)
- ``spill_stall``: accumulated restore-bracket seconds per request
- ``prefill``: admit -> prefill-complete span, plus per-request counts of
  prefill tokens computed vs skipped via a prefix cache
"""
from __future__ import annotations

import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional

__all__ = ["RequestLatencyTracker", "percentile"]


def percentile(values: List[float], q: float) -> Optional[float]:
    """Nearest-rank percentile (ceil(q/100 * n)-th smallest) — hand
    computable for test fixtures; no interpolation."""
    if not values:
        return None
    vs = sorted(values)
    n = len(vs)
    rank = max(1, -(-int(q * n) // 100))          # ceil(q*n/100), >= 1
    return vs[min(rank, n) - 1]


class _Rec:
    __slots__ = ("uid", "submit_t", "admit_t", "first_token_t",
                 "last_token_t", "tokens", "spill_stall_s", "spills",
                 "finish_t", "prefill_end_t", "prefill_computed",
                 "prefill_cached", "errors", "router_accept_t",
                 "handoff_stall_s", "handoffs")

    def __init__(self, uid: Any, submit_t: float):
        self.uid = uid
        self.submit_t = submit_t
        self.router_accept_t: Optional[float] = None
        self.admit_t: Optional[float] = None
        self.first_token_t: Optional[float] = None
        self.last_token_t: Optional[float] = None
        self.tokens = 0
        self.spill_stall_s = 0.0
        self.spills = 0
        self.finish_t: Optional[float] = None
        self.prefill_end_t: Optional[float] = None
        self.prefill_computed = 0
        self.prefill_cached = 0
        self.errors = 0
        self.handoff_stall_s = 0.0
        self.handoffs = 0


class RequestLatencyTracker:
    """Lifecycle-fed latency percentiles, keyed by request uid."""

    PCTS = (50, 90, 99)

    def __init__(self, clock: Callable[[], float] = time.perf_counter,
                 max_completed: int = 4096):
        self.clock = clock
        self._live: Dict[Any, _Rec] = {}
        self._done: deque = deque(maxlen=max_completed)
        self.submitted = 0
        self.finished = 0
        self.cancelled = 0
        self.handed_off = 0

    # -- lifecycle hooks (called by the engine) --------------------------

    def on_submit(self, uid: Any) -> None:
        self._live[uid] = _Rec(uid, self.clock())
        self.submitted += 1

    def note_router_accept(self, uid: Any, accept_t: float) -> None:
        """Router-level accept timestamp (same clock as the tracker)."""
        r = self._live.get(uid)
        if r is not None and r.router_accept_t is None:
            r.router_accept_t = float(accept_t)

    def on_admit(self, uid: Any) -> None:
        r = self._live.get(uid)
        if r is not None and r.admit_t is None:   # first admit only:
            r.admit_t = self.clock()              # re-admits after evict
                                                  # are not queue wait

    def on_tokens(self, uid: Any, total_tokens: int) -> None:
        """``total_tokens`` is the request's cumulative generated count
        (idempotent — repeated calls with an unchanged count are no-ops)."""
        r = self._live.get(uid)
        if r is None or total_tokens <= r.tokens:
            return
        now = max(self.clock(), r.submit_t)
        if r.first_token_t is None:
            r.first_token_t = now
        r.last_token_t = now
        r.tokens = total_tokens

    def on_prefill_done(self, uid: Any, computed_tokens: int,
                        cached_tokens: int = 0) -> None:
        """Prefill finished for ``uid``: ``computed_tokens`` went through
        the model, ``cached_tokens`` were skipped.  First call wins
        (evict/re-prefill churn keeps the original span)."""
        r = self._live.get(uid)
        if r is None or r.prefill_end_t is not None:
            return
        r.prefill_end_t = max(self.clock(), r.submit_t)
        r.prefill_computed = int(computed_tokens)
        r.prefill_cached = int(cached_tokens)

    def on_spill(self, uid: Any) -> None:
        r = self._live.get(uid)
        if r is not None:
            r.spills += 1

    def on_restore_stall(self, uid: Any, seconds: float) -> None:
        r = self._live.get(uid)
        if r is not None:
            r.spill_stall_s += float(seconds)

    def on_handoff_stall(self, uid: Any, seconds: float) -> None:
        r = self._live.get(uid)
        if r is not None:
            r.handoff_stall_s += float(seconds)
            r.handoffs += 1

    def on_handoff_out(self, uid: Any) -> Optional[Dict[str, Any]]:
        """Donor-side handoff: closes the record here."""
        r = self._live.pop(uid, None)
        if r is None:
            return None
        r.finish_t = self.clock()
        self._done.append(r)
        self.handed_off += 1
        return self._rec_summary(r)

    def on_error(self, uid: Any) -> None:
        r = self._live.get(uid)
        if r is not None:
            r.errors += 1

    def on_cancel(self, uid: Any) -> None:
        """Cancelled mid-flight: drop the live record WITHOUT feeding the
        percentile series — a cancelled request's truncated TTFT/TPOT
        would skew the tails.  Only the count survives."""
        if self._live.pop(uid, None) is not None:
            self.cancelled += 1

    def on_finish(self, uid: Any) -> Optional[Dict[str, Any]]:
        """Completes ``uid`` and returns its summary record — None if the
        uid was never submitted."""
        r = self._live.pop(uid, None)
        if r is None:
            return None
        r.finish_t = self.clock()
        self._done.append(r)
        self.finished += 1
        return self._rec_summary(r)

    # -- derived metrics -------------------------------------------------

    @staticmethod
    def _rec_summary(r: _Rec) -> Dict[str, Any]:
        """Per-request scalars; fields absent from the lifecycle stay
        None."""
        ttft = ((r.first_token_t - r.submit_t) * 1e3
                if r.first_token_t is not None else None)
        tpot = ((r.last_token_t - r.first_token_t) * 1e3 / (r.tokens - 1)
                if r.tokens >= 2 and r.first_token_t is not None else None)
        return {
            "uid": r.uid,
            "submit_t": r.submit_t,
            "finish_t": r.finish_t,
            "ttft_ms": ttft,
            "tpot_ms": tpot,
            "queue_wait_ms": ((r.admit_t - r.submit_t) * 1e3
                              if r.admit_t is not None else None),
            "router_queue_wait_ms": (
                (r.admit_t - r.router_accept_t) * 1e3
                if r.admit_t is not None
                and r.router_accept_t is not None else None),
            "spill_stall_ms": (r.spill_stall_s * 1e3 if r.spills > 0
                               else None),
            "prefill_ms": ((r.prefill_end_t - r.admit_t) * 1e3
                           if r.prefill_end_t is not None
                           and r.admit_t is not None else None),
            "handoff_stall_ms": (r.handoff_stall_s * 1e3
                                 if r.handoffs > 0 else None),
            "tokens": r.tokens,
            "spills": r.spills,
            "handoffs": r.handoffs,
            "errors": r.errors,
        }

    def completed(self) -> List[Dict[str, Any]]:
        """Summary records for the retained completed-request window."""
        return [self._rec_summary(r) for r in self._done]

    def summary(self) -> Dict[str, Any]:
        """Flat percentile summary over completed requests (ms)."""
        done = list(self._done)
        series: Dict[str, List[float]] = {
            "ttft_ms": [(r.first_token_t - r.submit_t) * 1e3 for r in done
                        if r.first_token_t is not None],
            "tpot_ms": [(r.last_token_t - r.first_token_t) * 1e3
                        / (r.tokens - 1) for r in done
                        if r.tokens >= 2 and r.first_token_t is not None],
            "queue_wait_ms": [(r.admit_t - r.submit_t) * 1e3 for r in done
                              if r.admit_t is not None],
            "router_queue_wait_ms": [
                (r.admit_t - r.router_accept_t) * 1e3 for r in done
                if r.admit_t is not None
                and r.router_accept_t is not None],
            "spill_stall_ms": [r.spill_stall_s * 1e3 for r in done
                               if r.spills > 0],
            "prefill_ms": [(r.prefill_end_t - r.admit_t) * 1e3
                           for r in done
                           if r.prefill_end_t is not None
                           and r.admit_t is not None],
            "handoff_stall_ms": [r.handoff_stall_s * 1e3 for r in done
                                 if r.handoffs > 0],
        }
        out: Dict[str, Any] = {"completed": len(done),
                               "submitted": self.submitted,
                               "cancelled": self.cancelled,
                               "handed_off": self.handed_off,
                               "in_flight": len(self._live),
                               "prefill_computed_tokens": sum(
                                   r.prefill_computed for r in done),
                               "prefill_cached_tokens": sum(
                                   r.prefill_cached for r in done)}
        for name, vals in series.items():
            for q in self.PCTS:
                v = percentile(vals, q)
                out[f"{name}_p{q}"] = (None if v is None
                                       else round(v, 4))
        return out
