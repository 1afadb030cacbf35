"""Logging utilities.

Counterpart of ``deepspeed_tpu/utils/logging.py`` (the reference's
``deepspeed/utils/logging.py``: ``logger``, ``log_dist(message,
ranks=[...])``).  The process index comes from ``torch.distributed`` when
a process group is initialised, else 0.
"""
from __future__ import annotations

import logging
import os
import sys

import torch.distributed as dist

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "DeepSpeedTPUTorch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        fmt = logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s",
            datefmt="%Y-%m-%d %H:%M:%S",
        )
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(fmt)
        lg.addHandler(handler)
    env_level = os.environ.get("DSTPU_LOG_LEVEL", "").lower()
    if env_level in LOG_LEVELS:
        lg.setLevel(LOG_LEVELS[env_level])
    return lg


logger = _create_logger()


def _process_index() -> int:
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def log_dist(message: str, ranks=None, level: int = logging.INFO) -> None:
    """Log ``message`` only on the given process indices.

    ``ranks=None`` or ``ranks=[-1]`` logs on every process (matching the
    reference semantics of ``log_dist`` in ``deepspeed/utils/logging.py``).
    """
    my_rank = _process_index()
    if ranks is None or -1 in ranks or my_rank in ranks:
        logger.log(level, f"[Rank {my_rank}] {message}")


def print_rank_0(message: str) -> None:
    if _process_index() == 0:
        logger.info(message)


def warning_once(message: str, _seen=set()) -> None:  # noqa: B006 - intentional cache
    if message not in _seen:
        _seen.add(message)
        logger.warning(message)


def get_log_level_from_string(s: str) -> int:
    return LOG_LEVELS.get(s.lower(), logging.INFO)
