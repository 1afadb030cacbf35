"""SLO objectives: ``Objective`` and ``parse_objective``.

Copied from ``deepspeed_tpu/telemetry/slo.py`` for the inference config's
``v2.slo`` validation.  An objective is a string like
``"ttft_ms_p99 <= 150"``: the ``_pNN`` suffix names the percentile target
(99% of samples must satisfy the threshold), so the error budget is
``1 - 0.99 = 1%``.  The rolling-window ``SLOSet`` and the ``TailSampler``
arrive with the telemetry port.
"""
from __future__ import annotations

import re
from typing import Union

__all__ = ["Objective", "parse_objective"]

_OBJ_RE = re.compile(
    r"^\s*([A-Za-z][A-Za-z0-9_]*?)_p(\d{1,2}(?:\.\d+)?)\s*(<=?)\s*"
    r"([0-9]*\.?[0-9]+(?:[eE][+-]?[0-9]+)?)\s*$")


class Objective:
    """One parsed objective: ``metric`` samples must be ``<= threshold``
    for at least ``target`` (fraction) of the window."""

    __slots__ = ("name", "metric", "target", "threshold")

    def __init__(self, name: str, metric: str, target: float,
                 threshold: float):
        if not (0.0 < target < 1.0):
            raise ValueError(f"{name}: target must be in (0, 1)")
        self.name = name
        self.metric = metric
        self.target = target
        self.threshold = threshold

    @property
    def budget(self) -> float:
        return 1.0 - self.target

    def __repr__(self):
        return (f"Objective({self.name!r}: {self.metric} p"
                f"{self.target * 100:g} <= {self.threshold:g})")


def parse_objective(spec: Union[str, Objective]) -> Objective:
    """``"ttft_ms_p99 <= 150"`` -> Objective(metric="ttft_ms",
    target=0.99, threshold=150).  ``p99.9`` sets target 0.999."""
    if isinstance(spec, Objective):
        return spec
    m = _OBJ_RE.match(str(spec))
    if not m:
        raise ValueError(
            f"bad SLO objective {spec!r} (want e.g. 'ttft_ms_p99 <= 150')")
    metric, pct, _op, thr = m.groups()
    target = float(pct) / 100.0
    name = f"{metric}_p{pct}"
    return Objective(name, metric, target, float(thr))
