"""torch.profiler bridge: device seconds by kernel name.

Counterpart of ``deepspeed_tpu/telemetry/profiler.py``, which reads the
newest XPlane trace of ``jax.profiler`` and sums device time per jitted
program.  Here the source is a ``torch.profiler`` run: either the
profiler object itself (its ``key_averages()``) or a Chrome trace it
exported (``prof.export_chrome_trace(path)``), whose CUDA kernel
events (``"cat": "kernel"``) carry the device durations.  The host
brackets around a pipelined dispatch measure handoff, not execution, so
a bench row splits them against these device seconds with
:func:`split_host_device`.

A run with no device activity (a CPU-only run) gives ``{}``.  A
missing or malformed trace raises: a reader of device metrics that
answered ``{}`` there would pass a broken trace off as an idle device.
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any, Dict, Optional

__all__ = ["device_seconds_by_kernel", "device_seconds_matching",
           "split_host_device"]

# Chrome-trace categories of device work in torch.profiler's export
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _from_profile(prof: Any) -> Dict[str, float]:
    """``{kernel: seconds}`` from a finished ``torch.profiler.profile``:
    its events with device time (``device_time_total`` in µs, the
    older ``cuda_time_total`` where that is what the build has)."""
    out: Dict[str, float] = {}
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total", None)
        if us is None:
            us = getattr(ev, "self_cuda_time_total", 0.0)
        if us and str(getattr(ev, "device_type", "")).endswith("CUDA"):
            out[ev.key] = out.get(ev.key, 0.0) + float(us) / 1e6
    return out


def _from_chrome_trace(path: str) -> Dict[str, float]:
    """``{kernel: seconds}`` from an exported Chrome trace's device
    events (``dur`` in µs)."""
    with open(path) as f:
        doc = json.load(f)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: no traceEvents list in the trace")
    out: Dict[str, float] = {}
    for ev in events:
        if not isinstance(ev, dict):
            raise ValueError(f"{path}: trace event {ev!r} is not an object")
        if ev.get("ph") == "X" and ev.get("cat") in _DEVICE_CATS:
            name = str(ev["name"])
            out[name] = out.get(name, 0.0) + float(ev["dur"]) / 1e6
    return out


def device_seconds_by_kernel(source: Any) -> Dict[str, float]:
    """``{kernel_name: device_seconds}``.  ``source``: a finished
    ``torch.profiler.profile``, a Chrome-trace JSON path, or a directory
    (its newest ``*.json``, searched recursively).  ``{}`` when the
    trace holds no device activity; ``FileNotFoundError`` when there is
    no trace and ``ValueError``/``KeyError`` when it is malformed."""
    if isinstance(source, (str, os.PathLike)):
        path = os.fspath(source)
        if os.path.isdir(path):
            paths = sorted(glob.glob(os.path.join(path, "**", "*.json"),
                                     recursive=True),
                           key=os.path.getmtime)
            if not paths:
                raise FileNotFoundError(f"no *.json trace under {path}")
            path = paths[-1]
        return _from_chrome_trace(path)
    return _from_profile(source)


def device_seconds_matching(kernels: Dict[str, float], substr: str) -> float:
    """Sum device seconds over kernels whose name contains ``substr``
    (template instantiations mangle names, so exact match is brittle)."""
    return sum(v for k, v in kernels.items() if substr in k)


def split_host_device(host_s: float, device_s: Optional[float]
                      ) -> Dict[str, Optional[float]]:
    """Render a host-bracketed interval against its attributed device
    time.  ``host_other_s`` is the bracket residual (scheduling, Python,
    transfer setup); negative residuals clamp to 0 — under the pipelined
    dispatch the host bracket releases before the device finishes, so
    device > bracket is expected, not an error."""
    if device_s is None:
        return {"host_s": host_s, "device_s": None, "host_other_s": None}
    return {"host_s": host_s, "device_s": device_s,
            "host_other_s": max(0.0, host_s - device_s)}
