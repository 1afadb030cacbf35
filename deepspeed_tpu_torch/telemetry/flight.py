"""Flight recorder: postmortem timeline dumps on hard-failure paths.

The tracer's bounded per-thread rings double as a black box.  When a
hard failure fires (``CollectiveTimeout``, ``SwapCorruptionError``,
``KVRestoreError``, ``GradientAnomalyError``, SIGTERM preemption), the
raise site calls :func:`dump_on_fault` and the recent spans + events
land in a self-describing JSONL next to the emergency checkpoint — a
chaos kill leaves a timeline, not just counters.

File format (one JSON object per line):

    {"record": "flight", "version": 1, "reason": ..., "exception":
     {"type": ..., "message": ...}, "pid": ..., "host": ..., ...}
    {"ph": "X", "name": "swap_in_wait", "ts": ..., "dur": ..., ...}
    ...
    {"record": "end", "events": N}

The trailing ``end`` line carries the event count, so a truncated dump
(process killed mid-write) is detectable: ``chaos_train`` exits
nonzero when the end line is missing or the count disagrees.

Dump location: explicit ``dir`` argument > ``DSTPU_FLIGHT_DIR`` env >
``<tempdir>/dstpu_flight``.  Dumps NEVER raise — a broken disk on a
failure path must not mask the original fault.
"""
from __future__ import annotations

import itertools
import json
import os
import re
import socket
import tempfile
import time
from typing import Any, Dict, List, Optional, Tuple

from deepspeed_tpu_torch.telemetry.tracer import trace
from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics

__all__ = ["dump_on_fault", "flight_dir", "last_dump_path",
           "read_flight_record"]

_SCHEMA_VERSION = 1
_seq = itertools.count()
_last_dump: Optional[str] = None
_DUMPED_ATTR = "_dstpu_flight_dump"


def flight_dir(dir: Optional[str] = None) -> str:
    """Resolve the dump directory (arg > env > tempdir fallback)."""
    return (dir or os.environ.get("DSTPU_FLIGHT_DIR")
            or os.path.join(tempfile.gettempdir(), "dstpu_flight"))


def last_dump_path() -> Optional[str]:
    """Path of the most recent dump this process wrote (tests/chaos)."""
    return _last_dump


def dump_on_fault(reason: str, exc: Optional[BaseException] = None,
                  dir: Optional[str] = None,
                  extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Dump the flight-recorder ring; returns the path or None.

    Re-dumping the SAME exception instance into the SAME directory is
    suppressed (a fault that unwinds through several handlers — raise
    site, engine handler — writes once per destination, so the engine
    can still place a copy next to the emergency checkpoint by passing
    an explicit ``dir``).
    """
    global _last_dump
    try:
        out_dir = flight_dir(dir)
        if exc is not None:
            dumped = getattr(exc, _DUMPED_ATTR, None)
            if dumped is not None and out_dir in dumped:
                return dumped[out_dir]
        os.makedirs(out_dir, exist_ok=True)
        tag = re.sub(r"[^A-Za-z0-9_.-]+", "_", reason)[:64] or "fault"
        path = os.path.join(
            out_dir, f"flight_{tag}_{os.getpid()}_{next(_seq)}.jsonl")
        events = trace.snapshot()
        header = {
            "record": "flight", "version": _SCHEMA_VERSION,
            "reason": reason, "pid": os.getpid(),
            "host": socket.gethostname(), "unix_time": time.time(),
            "clock": "perf_counter_us_since_tracer_epoch",
            "events": len(events),
            "exception": (None if exc is None else
                          {"type": type(exc).__name__,
                           "message": str(exc)[:2000]}),
        }
        if extra:
            header["extra"] = extra
        try:
            # cumulative counters + SLO state ride along with the span
            # ring, so a postmortem has the "how long has this been
            # going on" axis, not just the last few seconds
            if _metrics.enabled:
                header["metrics"] = _metrics.export_json()
        except Exception:
            pass                # metrics must never break a fault dump
        with open(path, "w", encoding="utf-8") as f:
            f.write(json.dumps(header) + "\n")
            for ev in events:
                f.write(json.dumps(ev) + "\n")
            f.write(json.dumps({"record": "end",
                                "events": len(events)}) + "\n")
        if exc is not None:
            dumped = getattr(exc, _DUMPED_ATTR, None) or {}
            dumped[out_dir] = path
            try:
                setattr(exc, _DUMPED_ATTR, dumped)
            except Exception:
                pass            # exceptions with __slots__: re-dump is fine
        _last_dump = path
        return path
    except Exception:
        return None             # never mask the original fault


def read_flight_record(path: str) -> Tuple[Dict[str, Any],
                                           List[Dict[str, Any]]]:
    """Parse + validate a dump; raises ``ValueError`` on a malformed or
    truncated file.  Returns ``(header, events)``."""
    with open(path, "r", encoding="utf-8") as f:
        lines = [ln for ln in f.read().splitlines() if ln.strip()]
    if not lines:
        raise ValueError(f"{path}: empty flight record")
    header = json.loads(lines[0])
    if header.get("record") != "flight":
        raise ValueError(f"{path}: missing flight header")
    tail = json.loads(lines[-1])
    if tail.get("record") != "end":
        raise ValueError(f"{path}: truncated (no end line)")
    events = [json.loads(ln) for ln in lines[1:-1]]
    if tail.get("events") != len(events) or header.get(
            "events") != len(events):
        raise ValueError(
            f"{path}: event count mismatch (header={header.get('events')} "
            f"end={tail.get('events')} actual={len(events)})")
    snap = header.get("metrics")
    if snap is not None:
        from deepspeed_tpu_torch.telemetry.metrics import validate_metrics_doc
        problems = validate_metrics_doc(snap)
        if problems:
            raise ValueError(
                f"{path}: bad embedded metrics snapshot: "
                + "; ".join(problems[:5]))
    return header, events
