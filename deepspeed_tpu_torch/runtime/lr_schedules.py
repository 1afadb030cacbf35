"""Learning-rate schedules.

Copy of ``deepspeed_tpu/runtime/lr_schedules.py`` (pure Python).  It
re-implements the reference schedule zoo (``deepspeed/runtime/lr_schedules.py``:
``LRRangeTest``, ``OneCycle``, ``WarmupLR``, ``WarmupDecayLR``,
``WarmupCosineLR``) as pure ``step -> lr`` functions compatible with optax,
plus thin stateful class wrappers exposing the reference's
``step()/get_lr()/state_dict()`` API for the engine.  Params keep the
reference JSON names (``warmup_min_lr``, ``cycle_first_step_size``, ...).
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Optional

LR_SCHEDULE_NAMES = ("LRRangeTest", "OneCycle", "WarmupLR", "WarmupDecayLR",
                     "WarmupCosineLR")

ScheduleFn = Callable[[int], float]


# ---------------------------------------------------------------------------
# Pure schedule builders
# ---------------------------------------------------------------------------


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_ignored) -> ScheduleFn:
    def fn(step: int) -> float:
        interval = (step // lr_range_test_step_size if lr_range_test_staircase
                    else step / lr_range_test_step_size)
        return lr_range_test_min_lr * (1.0 + lr_range_test_step_rate * interval)
    return fn


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 0.001,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_ignored) -> ScheduleFn:
    warmup_num_steps = max(2, warmup_num_steps)

    def fn(step: int) -> float:
        if step >= warmup_num_steps:
            return warmup_max_lr
        if warmup_type == "log":
            frac = math.log(step + 1) / math.log(warmup_num_steps)
        else:
            frac = step / warmup_num_steps
        frac = min(max(frac, 0.0), 1.0)
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * frac
    return fn


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 0.001, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_ignored) -> ScheduleFn:
    wl = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps, warmup_type)

    def fn(step: int) -> float:
        if step < warmup_num_steps:
            return wl(step)
        # linear decay to 0 over the remaining steps (reference WarmupDecayLR)
        span = max(1, total_num_steps - warmup_num_steps)
        frac = max(0.0, 1.0 - (step - warmup_num_steps) / span)
        return warmup_max_lr * frac
    return fn


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     warmup_type: str = "log", lr: float = 1.0,
                     **_ignored) -> ScheduleFn:
    """Cosine decay from peak ``lr`` to ``lr * cos_min_ratio`` after warmup
    from ``lr * warmup_min_ratio`` (reference ``WarmupCosineLR``)."""
    warmup_num_steps = max(2, warmup_num_steps)

    def fn(step: int) -> float:
        if step < warmup_num_steps:
            if warmup_type == "log":
                frac = math.log(step + 1) / math.log(warmup_num_steps)
            else:
                frac = step / warmup_num_steps
            ratio = warmup_min_ratio + (1.0 - warmup_min_ratio) * min(max(frac, 0.0), 1.0)
            return lr * ratio
        span = max(1, total_num_steps - warmup_num_steps)
        progress = min(1.0, (step - warmup_num_steps) / span)
        cos = 0.5 * (1.0 + math.cos(math.pi * progress))
        ratio = cos_min_ratio + (1.0 - cos_min_ratio) * cos
        return lr * ratio
    return fn


def one_cycle(cycle_min_lr: float = 0.0, cycle_max_lr: float = 0.001,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              cycle_first_stair_count: int = 0,
              cycle_second_stair_count: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_ignored) -> ScheduleFn:
    """Triangular cycle then optional decay (reference ``OneCycle``; momentum
    cycling is not applicable — optax momentum is part of the transform)."""
    second = cycle_second_step_size or cycle_first_step_size
    total_cycle = cycle_first_step_size + second

    def fn(step: int) -> float:
        if step < cycle_first_step_size:
            frac = step / cycle_first_step_size
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        if step < total_cycle:
            frac = (step - cycle_first_step_size) / second
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac
        # decay phase
        if decay_step_size > 0:
            decay_steps = (step - total_cycle) / decay_step_size
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        return cycle_min_lr
    return fn


_BUILDERS: Dict[str, Callable[..., ScheduleFn]] = {
    "LRRangeTest": lr_range_test,
    "OneCycle": one_cycle,
    "WarmupLR": warmup_lr,
    "WarmupDecayLR": warmup_decay_lr,
    "WarmupCosineLR": warmup_cosine_lr,
}


def get_schedule_fn(name: Optional[str], params: Dict[str, Any],
                    base_lr: Optional[float] = None) -> ScheduleFn:
    """Build a ``step -> lr`` fn from a reference-style scheduler config."""
    if name is None:
        lr = base_lr if base_lr is not None else 1e-3
        return lambda step: lr
    if name not in _BUILDERS:
        raise ValueError(f"Unknown scheduler type {name!r}; expected one of "
                         f"{LR_SCHEDULE_NAMES}")
    kwargs = dict(params)
    if name == "WarmupCosineLR" and base_lr is not None:
        kwargs.setdefault("lr", base_lr)
    return _BUILDERS[name](**kwargs)


# ---------------------------------------------------------------------------
# Stateful wrapper (reference class API)
# ---------------------------------------------------------------------------


class LRScheduler:
    """Stateful view over a schedule fn, exposing the reference's
    ``step()/get_lr()/get_last_lr()/state_dict()/load_state_dict()``."""

    def __init__(self, schedule_fn: ScheduleFn, last_batch_iteration: int = -1):
        self.schedule_fn = schedule_fn
        self.last_batch_iteration = last_batch_iteration

    def get_lr(self) -> List[float]:
        return [self.schedule_fn(max(0, self.last_batch_iteration))]

    def get_last_lr(self) -> List[float]:
        return self.get_lr()

    def step(self, last_batch_iteration: Optional[int] = None) -> None:
        if last_batch_iteration is None:
            last_batch_iteration = self.last_batch_iteration + 1
        self.last_batch_iteration = last_batch_iteration

    def state_dict(self) -> Dict[str, Any]:
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.last_batch_iteration = sd["last_batch_iteration"]
