"""Collective watchdog: collectives under a deadline.

Counterpart of ``deepspeed_tpu/comm/watchdog.py``.  A dropped or wedged
collective (a peer died mid-collective, a peer skipped the call, the
transport hangs) blocks every surviving rank.  When armed with a
deadline, each guarded collective runs on a daemon thread while the
caller waits at most ``deadline_s``; on expiry the caller gets
:class:`~deepspeed_tpu_torch.resilience.distributed.CollectiveTimeout`.
The wedged thread is abandoned (a blocked gloo or NCCL wait cannot be
interrupted from Python); being a daemon, it does not hold the process
at exit.

An NCCL collective returns once it is enqueued on the device, so the
deadline bounds its enqueue and the host-side rendezvous; a gloo
collective returns when it is done, so the deadline bounds all of it.

Disabled (the default, ``deadline_s == 0``) the guard is a direct call.
Armed by ``resilience.comm.collective_timeout_s`` in the config (the
engine calls :func:`configure`) or ``DSTPU_COLLECTIVE_TIMEOUT_S``.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable

from deepspeed_tpu_torch.resilience.distributed import CollectiveTimeout
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["CollectiveWatchdog", "CollectiveTimeout", "configure",
           "get_watchdog", "guard"]


class CollectiveWatchdog:
    """Deadline enforcement for blocking collective calls.  ``timeouts``
    counts expiries."""

    def __init__(self, deadline_s: float = 0.0):
        self.deadline_s = float(deadline_s)
        self.timeouts = 0

    @property
    def enabled(self) -> bool:
        return self.deadline_s > 0

    def guard(self, fn: Callable[[], Any], what: str = "collective") -> Any:
        """Run ``fn`` under the deadline: inline when disabled, else on a
        daemon thread, raising :class:`CollectiveTimeout` on expiry (and
        re-raising what ``fn`` raised)."""
        if not self.enabled:
            return fn()
        box: dict = {}

        def run():
            try:
                box["out"] = fn()
            except BaseException as e:      # handed to the caller below
                box["err"] = e

        t = threading.Thread(target=run, daemon=True,
                             name="dstpu-collective-wd")
        t.start()
        t.join(self.deadline_s)
        if t.is_alive():
            self.timeouts += 1
            logger.error(f"collective watchdog: {what} exceeded "
                         f"{self.deadline_s:.1f}s deadline — failing fast")
            raise CollectiveTimeout(
                f"{what} exceeded the {self.deadline_s:.1f}s collective "
                "deadline (a peer rank dropped the collective, died "
                "mid-collective, or the transport wedged); "
                "resilience.comm.collective_timeout_s bounds this wait")
        if "err" in box:
            raise box["err"]
        return box.get("out")


_WATCHDOG = CollectiveWatchdog(
    float(os.environ.get("DSTPU_COLLECTIVE_TIMEOUT_S", "0") or 0))


def configure(deadline_s: float) -> None:
    """Set the process-wide collective deadline (0 disables)."""
    _WATCHDOG.deadline_s = float(deadline_s)


def get_watchdog() -> CollectiveWatchdog:
    return _WATCHDOG


def guard(fn: Callable[[], Any], what: str = "collective") -> Any:
    return _WATCHDOG.guard(fn, what)
