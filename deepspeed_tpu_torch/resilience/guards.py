"""Runtime training guards.

Copy of ``deepspeed_tpu/resilience/guards.py`` without the telemetry
counters and the flight recorder (ROADMAP A10): detectors that turn
"silently wrong forever" failure modes into loud, actionable aborts.
"""
from __future__ import annotations

from deepspeed_tpu_torch.utils.logging import logger


class GradientAnomalyError(RuntimeError):
    """Training aborted because every recent step produced non-finite
    gradients — the run is spinning the loss scaler, not learning."""


class SkippedStepGuard:
    """Counts CONSECUTIVE overflow-skipped steps and aborts past a bound.

    The fp16 dynamic loss scaler recovers from isolated overflows by
    halving the scale; what it cannot recover from is a genuinely
    divergent model (NaN weights, poisoned data), where it halves the
    scale forever while every step is skipped.  This guard raises
    :class:`GradientAnomalyError` after ``bound`` consecutive skips
    (``resilience.max_consecutive_skips``; 0 disables)."""

    def __init__(self, bound: int):
        assert bound > 0, "use bound > 0 (0 means: do not build the guard)"
        self.bound = int(bound)
        self.consecutive = 0

    def update(self, overflowed: bool, step: int) -> None:
        if not overflowed:
            if self.consecutive:
                logger.info(f"step {step}: finite gradients after "
                            f"{self.consecutive} consecutive skips")
            self.consecutive = 0
            return
        self.consecutive += 1
        if self.consecutive >= self.bound:
            raise GradientAnomalyError(
                f"{self.consecutive} consecutive steps produced non-finite "
                f"gradients (through step {step}); the loss scaler cannot "
                "recover from a divergent model. Inspect the data/loss and "
                "resume from the last verified checkpoint "
                "(resilience.max_consecutive_skips bounds this abort).")
