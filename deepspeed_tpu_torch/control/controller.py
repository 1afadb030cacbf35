"""The online controller: reads the signal plane, drives the knobs.

Counterpart of ``deepspeed_tpu/control/controller.py``, copied: the same
rules, hill-climb, hysteresis and oscillation guard, so that one signal
trace gives the JAX controller's decision log.

One :class:`Controller` runs on the serving/training host loop (the
engine ticks it every ``interval`` steps — no thread of its own, so
arming it changes nothing structurally when it never decides).  Each
tick it

1. reads a signal snapshot (a plain ``{name: float}`` dict from an
   injectable feed — :func:`engine_signal_feed` composes one from
   ``host_stats`` deltas, pool pressure, tiering counters, pipeline
   ``submit_wait`` and SLO burn rates),
2. runs the **rule layer**: hard signal→knob reactions (prefetch on
   under spill pressure, earlier router deferral under SLO burn) with
   per-rule cooldowns,
3. runs the **hill-climb layer**: one in-flight *trial* at a time —
   step one knob, let the system settle ``settle`` ticks, then judge
   the objective against the trial's baseline with hysteresis:
   clear improvement → accept and keep climbing; clear regression →
   revert and flip direction; neither → quiet revert.  Repeated
   regressions on one knob within ``guard_window`` ticks trip the
   **oscillation guard**: the knob is frozen for ``freeze`` ticks
   (the revert-on-regression + frozen-knob penalty window).

Every decision is emitted as a ``cat="control"`` trace event plus
``dstpu_control_*`` metrics series, so ``trace_summarize --control``
can reconstruct the full decision log from any chrome/flight export,
and every knob change names the signal that motivated it.
"""
from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch.control.knobs import KnobRegistry
from deepspeed_tpu_torch.telemetry import trace
from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics

__all__ = ["Controller", "Rule", "engine_signal_feed", "prefetch_rule",
           "slo_shed_rule"]


@dataclass
class Rule:
    """Hard signal→knob reaction, evaluated every tick before the
    hill-climb.  ``predicate(signal_value)`` true and the knob not at
    ``value`` → apply it, attributed to ``signal``."""

    knob: str
    signal: str
    predicate: Callable[[float], bool]
    value: Any
    cooldown: int = 8
    name: str = ""

    def __post_init__(self) -> None:
        if not self.name:
            self.name = f"{self.signal}->{self.knob}"


def prefetch_rule(knob: str = "kv.prefetch",
                  signal: str = "tiering_spill_rate",
                  threshold: float = 0.5) -> Rule:
    """Spill pressure with prefetch off: restores kick back to the
    critical path — turn read-ahead on."""
    return Rule(knob=knob, signal=signal,
                predicate=lambda v: v >= threshold, value=True)


def slo_shed_rule(knob: str = "router.burn_defer",
                  signal: str = "slo_burn_max",
                  threshold: float = 1.5, defer_at: float = 1.0) -> Rule:
    """SLO error budget burning: lower the router's deferral threshold
    so low-priority load queues instead of competing — shedding rides
    the router's existing admission hooks from there."""
    return Rule(knob=knob, signal=signal,
                predicate=lambda v: v >= threshold, value=defer_at)


class Controller:
    """Rule + hill-climb knob policy with hysteresis and an
    oscillation guard.  Deterministic given its signal feed and clock
    (both injectable — the unit-test contract)."""

    def __init__(self, knobs: KnobRegistry,
                 signals: Callable[[], Dict[str, float]],
                 objective: str = "throughput", *,
                 clock: Callable[[], float] = time.monotonic,
                 settle: int = 2, hysteresis: float = 0.05,
                 cooldown: int = 4, guard_window: int = 16,
                 guard_reverts: int = 2, freeze: int = 32,
                 smooth: float = 1.0,
                 rules: Optional[List[Rule]] = None,
                 name: str = "control") -> None:
        if objective.startswith("-"):
            self._obj_key, self._obj_sign = objective[1:], -1.0
        else:
            self._obj_key, self._obj_sign = objective, 1.0
        self.knobs = knobs
        self.name = name
        self._signals = signals
        self._clock = clock
        self._settle = max(1, int(settle))
        self._hysteresis = float(hysteresis)
        self._cooldown = max(0, int(cooldown))
        self._guard_window = max(1, int(guard_window))
        self._guard_reverts = max(1, int(guard_reverts))
        self._freeze = max(1, int(freeze))
        self._smooth = min(1.0, max(0.0, float(smooth)))
        self._rules = list(rules or [])
        self._tick = 0
        self._obj: Optional[float] = None
        self._trial: Optional[Dict[str, Any]] = None
        self._rr = 0                             # round-robin cursor
        # per-knob policy state
        self._kstate: Dict[str, Dict[str, Any]] = {}
        self._rule_until: Dict[str, int] = {}
        self.decision_log: List[Dict[str, Any]] = []
        self.counts: Dict[str, int] = {
            "ticks": 0, "decisions": 0, "probes": 0, "accepts": 0,
            "reverts": 0, "settles": 0, "rules": 0, "freezes": 0,
            "unfreezes": 0, "guard_violations": 0}

    # -- state helpers ---------------------------------------------------

    def _ks(self, name: str) -> Dict[str, Any]:
        st = self._kstate.get(name)
        if st is None:
            st = {"dir": 1, "cooldown_until": 0, "frozen_until": 0,
                  "reverts": deque()}
            self._kstate[name] = st
        return st

    def _blocked(self, name: str) -> bool:
        st = self._ks(name)
        return (self._tick < st["frozen_until"]
                or self._tick < st["cooldown_until"])

    def frozen(self) -> List[str]:
        return [n for n, st in self._kstate.items()
                if self._tick < st["frozen_until"]]

    # -- the tick --------------------------------------------------------

    def tick(self) -> List[Dict[str, Any]]:
        """One control evaluation; returns the decisions it made (also
        appended to ``decision_log`` and emitted to trace/metrics)."""
        t0 = time.perf_counter()
        self._tick += 1
        self.counts["ticks"] += 1
        sig = dict(self._signals() or {})
        raw = sig.get(self._obj_key)
        if raw is not None:
            v = self._obj_sign * float(raw)
            self._obj = (v if self._obj is None else
                         self._smooth * v
                         + (1.0 - self._smooth) * self._obj)
        decisions: List[Dict[str, Any]] = []
        self._expire_freezes(decisions)
        self._run_rules(sig, decisions)
        if self._trial is not None:
            self._judge_trial(decisions)
        elif self._obj is not None:
            self._start_trial(decisions)
        self._emit(decisions, t0)
        return decisions

    # -- layers ----------------------------------------------------------

    def _expire_freezes(self, decisions: List[Dict[str, Any]]) -> None:
        for kname, st in self._kstate.items():
            if st["frozen_until"] and self._tick >= st["frozen_until"]:
                st["frozen_until"] = 0
                st["reverts"].clear()
                val = self.knobs.value(kname)
                decisions.append(self._decision(
                    "unfreeze", kname, val, val, signal="guard"))

    def _run_rules(self, sig: Dict[str, float],
                   decisions: List[Dict[str, Any]]) -> None:
        for rule in self._rules:
            if rule.knob not in self.knobs or rule.signal not in sig:
                continue
            if self._tick < self._rule_until.get(rule.name, 0):
                continue
            st = self._ks(rule.knob)
            if self._tick < st["frozen_until"]:
                continue
            if not rule.predicate(float(sig[rule.signal])):
                continue
            old, new = self.knobs.set(rule.knob, rule.value)
            if new == old:
                continue
            # a rule override aborts any trial probing the same knob
            if self._trial is not None and \
                    self._trial["knob"] == rule.knob:
                self._trial = None
            self._rule_until[rule.name] = self._tick + rule.cooldown
            decisions.append(self._decision(
                "rule", rule.knob, old, new, signal=rule.signal))

    def _start_trial(self, decisions: List[Dict[str, Any]]) -> None:
        candidates = [k for k in self.knobs.tunable()
                      if k.kind != "bool"]
        if not candidates:
            return
        for off in range(len(candidates)):
            knob = candidates[(self._rr + off) % len(candidates)]
            if self._blocked(knob.name):
                continue
            st = self._ks(knob.name)
            cur = knob.get()
            new = knob.clamp(cur + st["dir"] * knob.step)
            if new == cur:                    # at a bound: turn around
                st["dir"] = -st["dir"]
                new = knob.clamp(cur + st["dir"] * knob.step)
                if new == cur:
                    continue                  # degenerate range
            self._rr = (self._rr + off + 1) % len(candidates)
            self.knobs.set(knob.name, new)
            self._trial = {"knob": knob.name, "old": cur, "new": new,
                           "baseline": self._obj,
                           "start": self._tick}
            decisions.append(self._decision(
                "probe", knob.name, cur, new, signal=self._obj_key))
            return

    def _judge_trial(self, decisions: List[Dict[str, Any]]) -> None:
        trial = self._trial
        if self._tick - trial["start"] < self._settle:
            return
        self._trial = None
        kname = trial["knob"]
        knob = self.knobs.get(kname)
        st = self._ks(kname)
        base = trial["baseline"]
        obj = self._obj
        gain = ((obj - base) / max(abs(base), 1e-9)
                if (obj is not None and base is not None) else 0.0)
        if gain >= self._hysteresis:
            # clearly better: keep it and keep climbing this direction
            # (no cooldown — momentum while improving)
            decisions.append(self._decision(
                "accept", kname, trial["old"], trial["new"],
                signal=self._obj_key, gain=round(gain, 4)))
            return
        # not clearly better: put the old value back
        self.knobs.set(kname, trial["old"])
        cool = self._cooldown + knob.cooldown
        st["cooldown_until"] = self._tick + cool
        if gain <= -self._hysteresis:
            # clear regression: oscillation-guard bookkeeping
            st["dir"] = -st["dir"]
            st["reverts"].append(self._tick)
            while (st["reverts"] and
                   st["reverts"][0] <= self._tick - self._guard_window):
                st["reverts"].popleft()
            decisions.append(self._decision(
                "revert", kname, trial["new"], trial["old"],
                signal=self._obj_key, gain=round(gain, 4)))
            if len(st["reverts"]) >= self._guard_reverts:
                st["frozen_until"] = self._tick + self._freeze
                st["reverts"].clear()
                val = self.knobs.value(kname)
                decisions.append(self._decision(
                    "freeze", kname, val, val, signal="guard",
                    until=st["frozen_until"]))
        else:
            # neutral: quiet revert, try the other direction later
            st["dir"] = -st["dir"]
            decisions.append(self._decision(
                "settle", kname, trial["new"], trial["old"],
                signal=self._obj_key, gain=round(gain, 4)))

    # -- emission --------------------------------------------------------

    _COUNT_KEY = {"probe": "probes", "accept": "accepts",
                  "revert": "reverts", "settle": "settles",
                  "rule": "rules", "freeze": "freezes",
                  "unfreeze": "unfreezes"}

    def _decision(self, action: str, knob: str, old: Any, new: Any,
                  *, signal: str, **extra: Any) -> Dict[str, Any]:
        d = {"tick": self._tick, "action": action, "knob": knob,
             "old": old, "new": new, "signal": signal,
             "objective": (round(self._obj, 6)
                           if self._obj is not None else None)}
        d.update(extra)
        return d

    def _emit(self, decisions: List[Dict[str, Any]],
              t0: float) -> None:
        for d in decisions:
            self.decision_log.append(d)
            self.counts["decisions"] += 1
            key = self._COUNT_KEY.get(d["action"])
            if key:
                self.counts[key] += 1
            if trace.enabled:
                trace.event("control_decision", cat="control", **d)
            if _metrics.enabled:
                _metrics.counter(
                    "dstpu_control_decisions_total",
                    "Control-plane decisions by knob and action",
                    labels=("knob", "action")).labels(
                        knob=d["knob"], action=d["action"]).inc()
                if d["new"] is not None and d["action"] != "probe" \
                        and not isinstance(d["new"], bool):
                    _metrics.gauge(
                        "dstpu_control_knob",
                        "Current control-plane knob values",
                        labels=("knob",)).labels(
                            knob=d["knob"]).set(float(d["new"]))
        if trace.enabled and decisions:
            trace.add_complete("control_tick", t0,
                               time.perf_counter() - t0, cat="control",
                               tick=self._tick,
                               decisions=len(decisions))
        if _metrics.enabled:
            _metrics.counter("dstpu_control_ticks_total",
                             "Control-plane evaluation ticks").inc()

    # -- reporting -------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        return {**self.counts,
                "objective": (round(self._obj, 6)
                              if self._obj is not None else None),
                "frozen": self.frozen(),
                "knobs": self.knobs.snapshot()}


def engine_signal_feed(engine,
                       clock: Callable[[], float] = time.monotonic
                       ) -> Callable[[], Dict[str, float]]:
    """Compose the ragged engine's signal plane into one flat snapshot
    per tick: ``host_stats`` counter *rates* over the inter-tick
    window (throughput = decode ticks/s — the objective), per-dispatch
    efficiency ratios, KV pool pressure, tiering spill/restore rates,
    pipeline ``submit_wait`` share, and the max SLO burn rate.

    The port's engine counts ``ticks``, ``dispatches`` and
    ``blocking_gets`` on the host as it enqueues work: under the
    pipelined loop a block's ticks count when it is dispatched, not when
    the device finishes it, so ``throughput`` is the dispatch rate of
    decode ticks, bounded by the window's back-pressure
    (``submit_wait``)."""
    state: Dict[str, Any] = {}

    def _delta(key: str, cur: float) -> float:
        prev = state.get(key, 0.0)
        state[key] = cur
        return cur - prev

    def read() -> Dict[str, float]:
        now = clock()
        st = engine.host_stats
        out: Dict[str, float] = {}
        dt = now - state.get("t", now)
        state["t"] = now
        dticks = _delta("ticks", st.ticks)
        ddisp = _delta("dispatches", st.dispatches)
        dgets = _delta("blocking_gets", st.blocking_gets)
        dwait = _delta("submit_wait",
                       engine._pipe_timers.seconds.get("submit_wait",
                                                       0.0))
        if dt > 0:
            out["throughput"] = dticks / dt
            out["dispatch_rate"] = ddisp / dt
            out["submit_wait_frac"] = min(1.0, dwait / dt)
        out["blocking_gets_per_dispatch"] = dgets / max(ddisp, 1)
        alloc = getattr(engine, "allocator", None)
        if alloc is not None:
            # the engine's own pressure definition: in-use fraction
            # plus the queued-request overload term
            usable = max(engine.num_pages - 1, 1)
            in_use = usable - alloc.free_pages
            out["pool_pressure"] = (in_use / usable
                                    + len(engine.waiting))
        tiering = getattr(engine, "tiering", None)
        if tiering is not None:
            tc = tiering.counters
            dspills = _delta("spills", float(tc.get("spills", 0)))
            drestores = _delta("restores", float(tc.get("restores", 0)))
            dfall = _delta("spill_fallbacks",
                           float(tc.get("spill_fallbacks", 0)))
            if dt > 0:
                out["tiering_spill_rate"] = dspills / dt
                out["tiering_restore_rate"] = drestores / dt
                out["tiering_fallback_rate"] = dfall / dt
        slo = getattr(engine, "slo", None)
        if slo is not None:
            try:
                burns = [float(v.get("burn_rate") or 0.0)
                         for v in slo.evaluate().values()]
                out["slo_burn_max"] = max(burns) if burns else 0.0
            except Exception:
                pass
        return out

    return read
