"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py`` (the reference's
``deepspeed/utils/timer.py``: ``SynchronizedWallClockTimer`` at :44,
``ThroughputTimer`` at :199) on CUDA events.  A :class:`Timer` records an
event on the current stream at ``start`` and ``stop`` and reads the
elapsed device time only when asked (``elapsed``, ``mean``), so timing a
step adds no host sync to it; on the CPU it uses the host clock.  The
engine's timer names are the JAX engine's (``batch_prep``, ``step``).

As the JAX ``Timer`` does, every recorded interval is observed into the
``dstpu_engine_seconds{timer=...}`` histogram when the metrics registry is
on and lands as a ``cat="engine"`` tracer span when the tracer is on.  On
the card both happen where the timer drains its events (``elapsed``,
``mean``), which adds no sync to the step: the span starts at the host
time of ``start`` and lasts the device interval.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from deepspeed_tpu_torch.telemetry import trace
from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics
from deepspeed_tpu_torch.utils.logging import logger

FORWARD_MICRO_TIMER = "fwd_microstep"
FORWARD_GLOBAL_TIMER = "fwd"
BACKWARD_MICRO_TIMER = "bwd_microstep"
BACKWARD_GLOBAL_TIMER = "bwd"
STEP_MICRO_TIMER = "step_microstep"
STEP_GLOBAL_TIMER = "step"


class Timer:
    """A named timer accumulating intervals: pairs of CUDA events when a
    GPU is present, host-clock intervals otherwise."""

    def __init__(self, name: str, use_cuda: Optional[bool] = None):
        self.name = name
        self.use_cuda = (torch.cuda.is_available() if use_cuda is None
                         else use_cuda)
        self.started = False
        self._start = None
        self._host_start = 0.0
        # (start, stop, host start, recorded) per interval not yet read
        self._pending: List = []
        self._elapsed = 0.0
        self._record_count = 0
        self.last_interval = 0.0
        self._hist = None
        self._hist_fam = None

    def _mark(self):
        if self.use_cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def start(self) -> None:
        if self.started:
            raise RuntimeError(f"timer {self.name} already started")
        self._host_start = time.perf_counter()
        self._start = self._mark()
        self.started = True

    def stop(self, record: bool = True) -> None:
        if not self.started:
            raise RuntimeError(f"timer {self.name} not started")
        end = self._mark()
        self.started = False
        if self.use_cuda:
            self._pending.append((self._start, end, self._host_start,
                                  record))
        else:
            self._add(end - self._start, self._host_start, record)
        if record:
            self._record_count += 1

    def discard(self) -> None:
        """Abandon an in-flight interval without recording it."""
        self.started = False

    def record(self, seconds: float) -> None:
        """Account an interval measured elsewhere (an offload tier's stage
        seconds)."""
        self._add(seconds, time.perf_counter() - seconds, True)
        self._record_count += 1

    def _observe(self, seconds: float) -> None:
        if self._hist is None or self._hist_fam is not _metrics.get(
                "dstpu_engine_seconds"):
            self._hist_fam = _metrics.histogram(
                "dstpu_engine_seconds",
                "Engine wall-clock timer intervals (s)",
                labels=("timer",))
            self._hist = self._hist_fam.labels(timer=self.name)
        self._hist.observe(seconds)

    def _add(self, seconds: float, host_start: float,
             recorded: bool) -> None:
        self.last_interval = seconds
        self._elapsed += seconds
        if not recorded:
            return
        if trace.enabled:
            trace.add_complete(self.name, host_start, seconds, cat="engine")
        if _metrics.enabled:
            self._observe(seconds)

    def _drain(self) -> None:
        for start, end, host_start, recorded in self._pending:
            end.synchronize()
            self._add(start.elapsed_time(end) / 1e3, host_start, recorded)
        self._pending.clear()

    def reset(self) -> None:
        self.started = False
        self._pending.clear()
        self._elapsed = 0.0
        self._record_count = 0

    def elapsed(self, reset: bool = True) -> float:
        """Elapsed seconds of the recorded intervals (waits for their
        events)."""
        self._drain()
        out = self._elapsed
        if reset:
            self.reset()
        return out

    def mean(self) -> float:
        self._drain()
        if self._record_count == 0:
            return 0.0
        return self._elapsed / self._record_count


class SynchronizedWallClockTimer:
    """Group of named timers; mirrors the reference API (`timer.py:44`)."""

    def __init__(self):
        self.timers: Dict[str, Timer] = {}

    def __call__(self, name: str) -> Timer:
        if name not in self.timers:
            self.timers[name] = Timer(name)
        return self.timers[name]

    def has_timer(self, name: str) -> bool:
        return name in self.timers

    @staticmethod
    def memory_usage() -> str:
        if not torch.cuda.is_available():
            return "Device memory stats unavailable"
        in_use = torch.cuda.memory_allocated() / 2**30
        peak = torch.cuda.max_memory_allocated() / 2**30
        return f"Device mem in use {in_use:.2f} GB | peak {peak:.2f} GB"

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True, memory_breakdown: bool = False) -> None:
        if normalizer <= 0.0:
            raise ValueError("normalizer must be > 0")
        parts = [f"{n}: {self.timers[n].elapsed(reset=reset) * 1e3 / normalizer:.2f}ms"
                 for n in names if n in self.timers]
        msg = "time (ms) | " + " | ".join(parts)
        if memory_breakdown:
            msg += " | " + self.memory_usage()
        logger.info(msg)

    def get_mean(self, names: List[str], normalizer: float = 1.0
                 ) -> Dict[str, float]:
        if normalizer <= 0.0:
            raise ValueError("normalizer must be > 0")
        return {n: self.timers[n].mean() * 1e3 / normalizer
                for n in names if n in self.timers}


class ThroughputTimer:
    """Samples/s over global steps after ``start_step`` (reference
    ``timer.py:199``), on the host clock around a device sync."""

    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50):
        self.batch_size = max(1, batch_size)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.start_time = 0.0
        self.started = False
        self.micro_step_count = 0
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0

    @staticmethod
    def _sync() -> None:
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def start(self) -> None:
        self.started = True
        if self.global_step_count >= self.start_step:
            self._sync()
            self.start_time = time.perf_counter()

    def stop(self, global_step: bool = False, report_speed: bool = True
             ) -> None:
        if not self.started:
            return
        self.started = False
        self.micro_step_count += 1
        if global_step:
            self.global_step_count += 1
        if self.start_time > 0:
            self._sync()
            duration = time.perf_counter() - self.start_time
            self.total_elapsed_time += duration
            self.step_elapsed_time += duration
            self.start_time = 0.0
            if global_step and report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                logger.info(
                    f"global_step={self.global_step_count}, "
                    f"RunningAvgSamplesPerSec={self.avg_samples_per_sec():.2f}, "
                    f"CurrSamplesPerSec="
                    f"{self.batch_size * self.steps_per_output / self.step_elapsed_time:.2f}")
                self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        if self.global_step_count > self.start_step and \
                self.total_elapsed_time > 0:
            return (self.batch_size *
                    (self.global_step_count - self.start_step) /
                    self.total_elapsed_time)
        return 0.0
