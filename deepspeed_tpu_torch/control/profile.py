"""Per-host serving profiles: the offline sweep and its persistence.

Counterpart of ``deepspeed_tpu/control/profile.py``.  The offline sweep
reuses the ``autotuning/`` ExperimentScheduler machinery
(:func:`autotune_serving` wraps
:func:`~deepspeed_tpu_torch.autotuning.scheduler.tune_space`) to search
the serving knob space, then persists the winner as a JSON profile keyed
by a **host fingerprint** (core count, the engine device's name, NVMe
present), so the online controller on the same class of host starts
from a known-good point instead of the shipped defaults.  A profile
from a *different* fingerprint is rejected at load time: knob optima
do not transfer across host shapes (a 1-core dev container's optimum
is nothing like an 8-core NVMe bench host's).  The format is the JAX
package's, version 1, in the same file names under the same directory
(``DSTPU_PROFILE_DIR``, else ``~/.cache/deepspeed_tpu``), so that either
package reads the other's profile on one fingerprint.

Profile format (one JSON object)::

    {
      "version": 1,
      "fingerprint": {"cores": 8, "device": "cpu", "nvme": true},
      "knobs": {"engine.harvest_interval": 4, "engine.async_depth": 2},
      "metric": 1234.5,          # the sweep's objective at the winner
      "metric_name": "tok_per_s",
      "source": "sweep",
      "created": 1754300000.0
    }
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import asdict, dataclass, field
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.utils.logging import logger

__all__ = ["HostProfile", "host_fingerprint", "fingerprint_key",
           "save_profile", "load_profile", "autotune_serving"]

PROFILE_VERSION = 1


def _has_nvme() -> bool:
    try:
        return any(e.startswith("nvme")
                   for e in os.listdir("/sys/class/nvme"))
    except OSError:
        return False


def host_fingerprint(device: DeviceLike = None) -> Dict[str, Any]:
    """The profile key: what actually moves serving knob optima.
    ``device`` is the engine's: its name is ``torch.cuda.get_device_name``
    on ``cuda`` (the default, which raises without a GPU) and ``"cpu"``
    only when the device is the CPU."""
    dev = resolve_device(device)
    device = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu")
    return {"cores": int(os.cpu_count() or 1),
            "device": device.lower().replace(" ", "-"),
            "nvme": _has_nvme()}


def fingerprint_key(fp: Optional[Dict[str, Any]] = None) -> str:
    fp = fp or host_fingerprint()
    return (f"{fp['cores']}c_{fp['device']}_"
            f"{'nvme' if fp['nvme'] else 'nonvme'}")


@dataclass
class HostProfile:
    knobs: Dict[str, Any]
    fingerprint: Dict[str, Any] = field(default_factory=host_fingerprint)
    metric: Optional[float] = None
    metric_name: str = ""
    source: str = "sweep"
    created: float = 0.0
    version: int = PROFILE_VERSION

    @property
    def key(self) -> str:
        return fingerprint_key(self.fingerprint)


def _default_dir() -> str:
    return os.environ.get(
        "DSTPU_PROFILE_DIR",
        os.path.join(os.path.expanduser("~"), ".cache", "deepspeed_tpu"))


def _profile_path(path: Optional[str],
                  fp: Optional[Dict[str, Any]] = None) -> str:
    """A file path stays a file path; a directory (or None — the
    default cache dir) resolves to the fingerprint-keyed file name."""
    if path is not None and not os.path.isdir(path) \
            and path.endswith(".json"):
        return path
    base = path if path is not None else _default_dir()
    return os.path.join(base,
                        f"control_profile_{fingerprint_key(fp)}.json")


def save_profile(profile: HostProfile,
                 path: Optional[str] = None) -> str:
    """Write the profile; returns the resolved path."""
    if not profile.created:
        profile.created = time.time()
    out = _profile_path(path, profile.fingerprint)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump(asdict(profile), f, indent=2, sort_keys=True)
    os.replace(tmp, out)
    return out


def load_profile(path: Optional[str] = None, *,
                 fingerprint: Optional[Dict[str, Any]] = None,
                 strict: bool = True) -> Optional[HostProfile]:
    """Load the profile for this host (or ``fingerprint``); ``None``
    when absent, unreadable, or, with ``strict``, keyed to a different
    host shape (logged, never half-applied)."""
    fp = fingerprint or host_fingerprint()
    target = _profile_path(path, fp)
    try:
        with open(target) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return None
    if not isinstance(doc, dict) or "knobs" not in doc:
        return None
    prof = HostProfile(
        knobs=dict(doc.get("knobs") or {}),
        fingerprint=dict(doc.get("fingerprint") or {}),
        metric=doc.get("metric"),
        metric_name=str(doc.get("metric_name") or ""),
        source=str(doc.get("source") or ""),
        created=float(doc.get("created") or 0.0),
        version=int(doc.get("version") or 0))
    if strict and prof.fingerprint != fp:
        logger.info(f"control profile {target} is for host "
                    f"{prof.fingerprint}, not {fp}: ignored")
        return None
    return prof


def autotune_serving(runner: Callable[[Dict[str, Any]], float],
                     space: Dict[str, Sequence], *,
                     tuner: str = "gridsearch",
                     metric_name: str = "tok_per_s",
                     n_trials: int = 1000,
                     early_stopping: Optional[int] = None,
                     exps_dir: Optional[str] = None,
                     seed: int = 0,
                     save_to: Optional[str] = None,
                     device: DeviceLike = None
                     ) -> Optional[HostProfile]:
    """Offline knob sweep on the autotuning substrate.

    ``runner(point)`` measures one knob assignment (``point`` maps knob
    name → candidate value) and returns the metric (higher is better);
    exceptions quarantine that point, exactly like a crashed training
    experiment.  Returns the winning :class:`HostProfile` (saved to
    ``save_to`` — a file, a directory, or the default cache dir when
    ``""`` — if requested), or ``None`` when every point failed.
    The profile is keyed by ``host_fingerprint(device)``, the measured
    engine's device (``cuda`` by default).
    """
    from deepspeed_tpu_torch.autotuning.scheduler import tune_space

    best = tune_space(
        {}, dict(space),
        lambda cfg: runner(dict(cfg.get("_tuning_point") or {})),
        tuner=tuner, n_trials=n_trials, early_stopping=early_stopping,
        exps_dir=exps_dir, seed=seed)
    if best is None or best.metric_val is None:
        return None
    prof = HostProfile(
        knobs=dict(best.ds_config.get("_tuning_point") or {}),
        fingerprint=host_fingerprint(device),
        metric=float(best.metric_val), metric_name=metric_name,
        source=f"sweep:{tuner}", created=time.time())
    if save_to is not None:
        save_profile(prof, save_to or None)
    return prof
