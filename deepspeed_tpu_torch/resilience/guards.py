"""Runtime training guards.

Copy of ``deepspeed_tpu/resilience/guards.py``: detectors that turn
"silently wrong forever" failure modes into loud, actionable aborts.
"""
from __future__ import annotations

from deepspeed_tpu_torch.utils.logging import logger


class SwapCorruptionError(RuntimeError):
    """Silent data corruption detected in the NVMe offload hot path: a
    swapped moment bucket failed its checksum and the blocking re-reads
    could not produce clean bytes (the corruption is on the media, not
    transient host-buffer noise).  The swap file is quarantined before
    this raises.  The engine saves the torn state only as a postmortem
    copy (``emergency_step<N>.torn``, which ``latest`` never names) and
    re-raises, so the job restarts from the last whole checkpoint
    instead of training on garbage (``runtime/swap_tensor.py``)."""


class GradientAnomalyError(RuntimeError):
    """Training aborted because every recent step produced non-finite
    gradients — the run is spinning the loss scaler, not learning."""


class SkippedStepGuard:
    """Counts CONSECUTIVE overflow-skipped steps and aborts past a bound.

    The fp16 dynamic loss scaler recovers from isolated overflows by
    halving the scale; what it cannot recover from is a genuinely
    divergent model (NaN weights, poisoned data), where it halves the
    scale forever while every step is skipped.  The reference engine
    trains on silently in that state — this guard raises
    :class:`GradientAnomalyError` after ``bound`` consecutive skips
    (``resilience.max_consecutive_skips``; 0 disables)."""

    def __init__(self, bound: int):
        assert bound > 0, "use bound > 0 (0 means: do not build the guard)"
        self.bound = int(bound)
        self.consecutive = 0

    def update(self, overflowed: bool, step: int) -> None:
        if overflowed:
            from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics
            if _metrics.enabled:
                _metrics.counter(
                    "dstpu_skipped_steps_total",
                    "Optimizer steps skipped on gradient overflow").inc()
        if not overflowed:
            if self.consecutive:
                logger.info(f"step {step}: finite gradients after "
                            f"{self.consecutive} consecutive skips")
            self.consecutive = 0
            return
        self.consecutive += 1
        if self.consecutive >= self.bound:
            err = GradientAnomalyError(
                f"{self.consecutive} consecutive steps produced non-finite "
                f"gradients (through step {step}); the loss scaler cannot "
                "recover from a divergent model. Inspect the data/loss and "
                "resume from the last verified checkpoint "
                "(resilience.max_consecutive_skips bounds this abort).")
            from deepspeed_tpu_torch.telemetry import flight
            from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics

            if _metrics.enabled:
                _metrics.counter(
                    "dstpu_gradient_anomalies_total",
                    "Aborts on consecutive non-finite gradients").inc()
            flight.dump_on_fault("gradient_anomaly", err,
                                 extra={"step": int(step),
                                        "consecutive": self.consecutive})
            raise err
