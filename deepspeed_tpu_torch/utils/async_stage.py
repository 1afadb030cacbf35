"""Bounded-async-stage substrate for the host-side pipelines.

Counterpart of ``deepspeed_tpu/utils/async_stage.py`` (``StageTimers``,
``BoundedAsyncStage`` and ``HostBufferPool``), host-only Python copied and
adapted, not imported.
The serving host path is its first user here: a pipelined v2 decode loop
keeps at most ``async_depth`` decode blocks in flight, each tracked as
one op whose waiter synchronizes the block's ``torch.cuda.Event``.

``BoundedAsyncStage``
    a bounded window of keyed in-flight async operations.  Submitting
    past the window's depth first joins the oldest op (back-pressure).
    ``drain()`` is the forced-drain point: it joins EVERYTHING, collects
    results and raises the first error only after every op is reaped.
    ``pop`` joins exactly one keyed op.

``StageTimers``
    per-stage wall timers and counters; ``snapshot()`` gives
    ``{"<stage>_s": seconds}`` floats plus the raw counters, the shape
    the engines' ``serving_stages()`` report.

``HostBufferPool``
    a fixed ring of 4096-byte aligned host staging buffers (the O_DIRECT
    requirement), page-locked when asked so that copies between them and
    the card run asynchronously: the KV tiers' NVMe read-ahead ring.  A
    slot is reissued only after its previous tenant released it.

The KV tiers (:mod:`~deepspeed_tpu_torch.inference.kv_tiering`) are the
substrate's second user: their NVMe write-back and read-ahead windows
and the digest side pool (:mod:`~deepspeed_tpu_torch.resilience.sdc`).
The replica feeds of :mod:`~deepspeed_tpu_torch.serving.replica_set` are
its third, with :meth:`BoundedAsyncStage.abandon` for a wedged replica.
With the tracer on, every bracket lands as a span, and with the metrics
registry on, in the ``dstpu_stage_seconds`` histogram.  The substrate
has no worker thread of its own:
asynchrony comes from what the caller submits (CUDA work already
enqueued, AIO ops, futures); the substrate only bounds, times and drains
it.
"""
from __future__ import annotations

import time
from collections import OrderedDict
from contextlib import contextmanager
from typing import Any, Callable, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.telemetry import trace
from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics

__all__ = ["BoundedAsyncStage", "HostBufferPool", "StageTimers"]


class StageTimers:
    """Accumulating wall timers and counters, one bucket per stage name.
    With the tracer enabled every bracket also lands as a span (``cat``
    labels the subsystem's row in the exported trace)."""

    def __init__(self, cat: str = "host") -> None:
        self.seconds: Dict[str, float] = {}
        self.counters: Dict[str, int] = {}
        self.cat = cat
        self._hists: Dict[str, Any] = {}
        self._hist_fam = None

    def _hist(self, name: str):
        h = self._hists.get(name)
        if h is None or self._hist_fam is not _metrics.get(
                "dstpu_stage_seconds"):
            self._hist_fam = _metrics.histogram(
                "dstpu_stage_seconds",
                "Async-pipeline stage bracket durations (s)",
                labels=("cat", "stage"))
            h = self._hist_fam.labels(cat=self.cat, stage=name)
            self._hists[name] = h
        return h

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0, t0)

    def add(self, name: str, seconds: float,
            t0: Optional[float] = None) -> None:
        """Account an externally bracketed interval (``t0``: its start on
        ``time.perf_counter``'s clock, now - ``seconds`` if not given)."""
        self.seconds[name] = self.seconds.get(name, 0.0) + seconds
        if trace.enabled:
            trace.add_complete(name, time.perf_counter() - seconds
                               if t0 is None else t0, seconds, cat=self.cat)
        if _metrics.enabled:
            self._hist(name).observe(seconds)

    def count(self, name: str, n: int = 1) -> None:
        self.counters[name] = self.counters.get(name, 0) + n

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {f"{k}_s": round(v, 6)
                               for k, v in sorted(self.seconds.items())}
        out.update(sorted(self.counters.items()))
        return out

    def reset(self) -> None:
        self.seconds.clear()
        self.counters.clear()


class BoundedAsyncStage:
    """Bounded window of keyed in-flight async operations.

    ``waiter(op) -> result`` joins one submitted op (for a decode block:
    synchronize its event); it is the ONLY way an op completes.
    ``depth``: most ops in flight; ``submit`` past it first joins the
    oldest op, timed under the ``submit_wait`` stage.  ``timers``: a
    shared :class:`StageTimers` (one is made if absent).
    """

    def __init__(self, waiter: Callable[[Any], Any], depth: int = 2,
                 timers: Optional[StageTimers] = None,
                 name: str = "stage") -> None:
        self._waiter = waiter
        self.depth = max(1, int(depth))
        self.name = name
        self.timers = timers if timers is not None else StageTimers()
        # key -> (op, on_done) in submission order: oldest-first joins
        self._inflight: "OrderedDict[Any, Tuple[Any, Any]]" = OrderedDict()

    @property
    def in_flight(self) -> int:
        return len(self._inflight)

    def keys(self) -> List[Any]:
        return list(self._inflight)

    def __contains__(self, key: Any) -> bool:
        return key in self._inflight

    def submit(self, key: Any, op: Any,
               on_done: Optional[Callable[[Any], Any]] = None) -> None:
        """Track ``op`` under ``key``, joining the oldest op first while
        the window is full.  ``on_done(result)`` runs at join time and its
        return value is the op's result.  A live key is joined before it
        is reused (two ops on one logical slot would race)."""
        if key in self._inflight:
            self.pop(key)
        while len(self._inflight) >= self.depth:
            with self.timers.stage("submit_wait"):
                self._finish(self._inflight.popitem(last=False)[1])
        self._inflight[key] = (op, on_done)
        self.timers.count("submitted")

    def pop(self, key: Any, default: Any = None) -> Any:
        """Join exactly ``key``'s op (if live) and return its result."""
        ent = self._inflight.pop(key, None)
        if ent is None:
            return default
        return self._finish(ent)

    def drain(self) -> List[Any]:
        """Join every op in submission order.  Every op is reaped even
        when one fails; the first error is raised after the sweep."""
        results, first_err = [], None
        with self.timers.stage("drain"):
            while self._inflight:
                _, ent = self._inflight.popitem(last=False)
                try:
                    results.append(self._finish(ent))
                except BaseException as e:   # noqa: BLE001 (re-raised)
                    if first_err is None:
                        first_err = e
        if first_err is not None:
            raise first_err
        return results

    def discard(self, key: Any) -> bool:
        """Drop exactly one keyed op without joining it (no waiter, no
        ``on_done``): for an op whose backing device just failed, which
        joining could wedge.  Returns whether the key was in flight."""
        return self._inflight.pop(key, None) is not None

    def abandon(self) -> int:
        """Discard every in-flight op WITHOUT joining (no waiter, no
        ``on_done``): the hung-replica escape hatch, since a wedged
        worker's futures may never resolve.  Returns the ops dropped.
        Only correct when their side effects are written off."""
        n = len(self._inflight)
        self._inflight.clear()
        return n

    def _finish(self, ent: Tuple[Any, Any]) -> Any:
        op, on_done = ent
        res = self._waiter(op)
        self.timers.count("completed")
        if on_done is not None:
            res = on_done(res)
        return res


class HostBufferPool:
    """Fixed ring of 4096-byte aligned host staging buffers, page-locked
    when ``pinned`` (needs CUDA).

    Reuse invariant: ``acquire`` hands a slot out only after its previous
    tenant's ``release``; it raises when every slot is checked out, so a
    bounded pipeline (window depth < pool size) can never scribble over
    bytes an in-flight op still owns.
    """

    def __init__(self, count: int, nbytes: int,
                 pinned: bool = False) -> None:
        from deepspeed_tpu_torch.io.aio import DIRECT_ALIGN, aligned_empty

        self.count = max(1, int(count))
        self.nbytes = int(nbytes)
        self.pinned = bool(pinned)
        self._bufs = [aligned_empty(self.nbytes, pinned=self.pinned)
                      for _ in range(self.count)]
        assert all(b.ctypes.data % DIRECT_ALIGN == 0 for b in self._bufs), (
            "staging buffers must be 4096-byte aligned for O_DIRECT")
        self._free = list(range(self.count))

    @property
    def free(self) -> int:
        return len(self._free)

    def acquire(self) -> Tuple[int, Any]:
        """``(slot, buffer)``; the buffer is the caller's until
        ``release(slot)``."""
        if not self._free:
            raise RuntimeError(
                f"HostBufferPool exhausted ({self.count} slots all "
                "checked out): the in-flight window must drain before a "
                "staging buffer is reused")
        slot = self._free.pop()
        return slot, self._bufs[slot]

    def peek(self, slot: int) -> Any:
        """The slot's buffer (the holder's view while checked out)."""
        return self._bufs[slot]

    def release(self, slot: int) -> None:
        if slot in self._free:
            raise RuntimeError(f"HostBufferPool slot {slot} double-freed")
        self._free.append(slot)
