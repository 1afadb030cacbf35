"""Jittered exponential-backoff retry for transient I/O failures.

Copy of ``deepspeed_tpu/resilience/retry.py``.

The reusable half of the fault-tolerance layer (resilience/): checkpoint
blob/index writes, the NVMe moment-file swap path, and the elastic
agent's restart loop all share this one backoff policy instead of each
growing an ad-hoc ``time.sleep`` loop.

Determinism for tests: the wait primitive is the module-level ``_sleep``
(monkeypatch it with a fake clock — no resilience test may really
sleep), and the jitter draws from an injectable ``random.Random``.
"""
from __future__ import annotations

import functools
import random
import time
from typing import Callable, Iterator, Optional, Tuple, Type

from deepspeed_tpu_torch.utils.logging import logger

# the injectable clock: tests replace this with a recording fake so
# backoff paths stay tier-1-fast while still exercising real delays
_sleep = time.sleep


def backoff_delays(attempts: int, base_s: float, cap_s: float = 30.0,
                   jitter: float = 0.5,
                   rng: Optional[random.Random] = None
                   ) -> Iterator[float]:
    """The ``attempts - 1`` delays between ``attempts`` tries:
    ``min(cap, base * 2**i) * (1 + jitter * u)``, ``u ~ U[0, 1)``.

    Jitter is additive-only (delays never shrink below the exponential
    floor) so a fleet of restarting workers decorrelates without any
    of them retrying early."""
    rng = rng or random.Random()
    for i in range(max(attempts - 1, 0)):
        yield min(cap_s, base_s * (2.0 ** i)) * (1.0 + jitter * rng.random())


def retriable(attempts: int = 4, base_s: float = 0.05, cap_s: float = 2.0,
              retry_on: Tuple[Type[BaseException], ...] = (OSError,),
              jitter: float = 0.5, rng: Optional[random.Random] = None,
              sleep: Optional[Callable[[float], None]] = None):
    """Decorator: retry ``fn`` on ``retry_on`` with jittered exponential
    backoff, re-raising the last failure once ``attempts`` is spent.

    The decorated function must be idempotent under partial completion
    (checkpoint writers qualify: every retry rewrites the staged file
    from the start)."""

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            delays = backoff_delays(attempts, base_s, cap_s, jitter, rng)
            attempt = 1
            while True:
                try:
                    return fn(*args, **kwargs)
                except retry_on as e:
                    delay = next(delays, None)
                    if delay is None:
                        raise              # budget spent: re-raise e
                    logger.warning(
                        f"{fn.__qualname__}: transient failure "
                        f"(attempt {attempt}/{attempts}): {e!r}; "
                        f"retrying in {delay:.2f}s")
                    (sleep or _sleep)(delay)
                    attempt += 1
        return wrapper
    return deco


def call_with_retries(fn: Callable, *args, **retry_kw):
    """One-off form of :func:`retriable` for call sites that can't be
    decorated (e.g. wrapping ``shutil.copy2``)."""
    return retriable(**retry_kw)(fn)(*args)
