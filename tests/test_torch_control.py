"""The port's closed-loop control plane (``deepspeed_tpu_torch.control``
and the v2 engine's attach points) against the JAX package's, on the CPU.

- Copies of ``tests/unit/test_control.py``'s fake-driven suites against
  the port: the typed knob surface, the hill-climb's convergence, the
  oscillation guard, the rules, the trace events and metrics
  (``scripts/trace_summarize.py --control`` renders and validates the
  port's export), profiles and the offline sweep, the kill switch.
- One seeded synthetic signal trace, on a manual clock, through both
  packages' ``Controller``s over the same knobs and rules: the same
  decision log (tick, action, knob, old, new, signal, objective, gain)
  and counts, exactly.
- A profile saved by either package loads in the other under one
  explicit fingerprint, and is refused under another; ``autotune_serving``
  picks the JAX package's winner on the same runner.
- The v2 engine on the tiny fp32 Llama of ``test_torch_serving_pipeline``:
  ``knob_registry()`` equal to the JAX engine's in names, bounds, kinds
  and ``recompiles`` with tiering and speculation on and off; greedy
  tokens with ``control`` armed equal to control off and to the JAX
  engine's with ``control`` armed; the reference's mid-run knob change;
  a profile seeding ``decode_block_size`` before any block; and
  ``serving_stages()["control"]``'s keys equal to the JAX engine's.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from deepspeed_tpu import control as jctl
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.control import (Controller, HostProfile, Knob,
                                         KnobRegistry, autotune_serving,
                                         control_enabled, engine_signal_feed,
                                         fingerprint_key, host_fingerprint,
                                         load_profile, prefetch_rule,
                                         router_knobs, save_profile,
                                         slo_shed_rule)
from deepspeed_tpu_torch.telemetry import metrics as metrics_mod
from deepspeed_tpu_torch.telemetry import tracer as tracer_mod
from test_torch_serving_pipeline import (BASE, PIPE, _jax_cfg, _prompts,
                                         assert_same, port_engine, serve,
                                         weights)  # noqa: F401 (fixture)
import torch_cpu  # noqa: F401  (one torch thread a process)

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# one explicit fingerprint: this CPU's, as the engines on it key theirs
FP = host_fingerprint("cpu")
CTL = {"interval": 1, "settle": 1, "cooldown": 0}


class ManualClock:
    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def registry():
    """The port's process metrics singleton, owned for the test."""
    reg = metrics_mod.metrics
    prev = (reg.enabled, reg.clock, reg.slo)
    reg.reset()
    reg.configure(enabled=True)
    reg.slo = None
    yield reg
    reg.reset()
    reg.configure(enabled=prev[0], clock=prev[1])
    reg.slo = prev[2]


@pytest.fixture
def global_trace():
    tr = tracer_mod.trace
    prev = (tr.enabled, tr.buffer_size, tr.clock, tr.annotate)
    tr.clear()
    yield tr
    tr.configure(enabled=prev[0], buffer_size=prev[1], clock=prev[2],
                 annotate=prev[3])
    tr.clear()


def _int_knob(state, name="t.x", lo=1, hi=8, step=1, knob=Knob, **kw):
    return knob(name, lambda: state["x"],
                lambda v: state.__setitem__("x", v),
                lo=lo, hi=hi, step=step, kind="int", **kw)


def _registry(state, reg_cls=KnobRegistry, knob=Knob, **kw):
    reg = reg_cls()
    reg.register(_int_knob(state, knob=knob, **kw))
    return reg


# -- KnobRegistry: the typed write path ----------------------------------------

class TestKnobRegistry:
    def test_set_clamps_types_and_bounds(self):
        state = {"x": 4}
        reg = _registry(state, lo=1, hi=8)
        assert reg.set("t.x", 99) == (4, 8)
        assert state["x"] == 8
        assert reg.set("t.x", -3) == (8, 1)
        assert reg.set("t.x", 3.7) == (1, 4)
        assert isinstance(state["x"], int)

    def test_bool_kind_casts(self):
        state = {"on": False}
        reg = KnobRegistry()
        reg.register(Knob("t.on", lambda: state["on"],
                          lambda v: state.__setitem__("on", v),
                          kind="bool"))
        assert reg.set("t.on", 1) == (False, True)
        assert state["on"] is True

    def test_apply_skipped_when_unchanged(self):
        calls = []
        state = {"x": 4}
        reg = KnobRegistry()
        reg.register(Knob("t.x", lambda: state["x"], calls.append,
                          lo=1, hi=8, kind="int"))
        reg.set("t.x", 4)
        assert calls == []
        reg.set("t.x", 5)
        assert calls == [5]

    def test_recompiling_knob_is_fenced(self):
        state = {"x": 4}
        reg = _registry(state, recompiles=True)
        with pytest.raises(RuntimeError, match="recompiles"):
            reg.set("t.x", 5)
        assert state["x"] == 4
        reg.set("t.x", 5, allow_recompile=True)
        assert state["x"] == 5
        assert reg.tunable() == []

    def test_duplicate_register_raises(self):
        state = {"x": 1}
        reg = _registry(state)
        with pytest.raises(ValueError):
            reg.register(_int_knob(state))

    def test_merge_and_profile_seeding(self):
        a, b = {"x": 2}, {"y": 1.0}
        reg = _registry(a)
        other = KnobRegistry()
        other.register(Knob("t.y", lambda: b["y"],
                            lambda v: b.__setitem__("y", v),
                            lo=0.0, hi=4.0, step=0.5, kind="float"))
        reg.merge(other)
        assert reg.names() == ["t.x", "t.y"]
        applied = reg.apply_profile({"t.x": 6, "t.y": 2.5, "gone.knob": 99})
        assert applied == {"t.x": 6, "t.y": 2.5}
        assert (a["x"], b["y"]) == (6, 2.5)


# -- Controller: hill-climb, hysteresis, guard (fake feed, manual clock) -------

def _climb(state, optimum, *, start, objective="throughput", sign=1.0,
           **ctl_kw):
    state["x"] = start
    reg = _registry(state)

    def feed():
        v = 100.0 - 5.0 * (state["x"] - optimum) ** 2
        return {objective.lstrip("-"): sign * v}

    ctl_kw.setdefault("settle", 1)
    ctl_kw.setdefault("cooldown", 0)
    ctl_kw.setdefault("clock", ManualClock())
    return Controller(reg, feed, objective=objective, **ctl_kw)


class TestHillClimb:
    def test_converges_within_3x_steady_state(self):
        state = {}
        ctl = _climb(state, optimum=6, start=2, settle=1)
        for _ in range(3 * 4 * 2):
            ctl.tick()
        assert state["x"] == 6
        assert ctl.counts["accepts"] >= 4

    def test_minimize_objective_sign(self):
        state = {}
        ctl = _climb(state, optimum=3, start=7, objective="-lat_ms",
                     sign=-1.0)
        for _ in range(3 * 4 * 2):
            ctl.tick()
        assert state["x"] == 3

    def test_no_decisions_without_objective_signal(self):
        state = {"x": 4}
        ctl = Controller(_registry(state), lambda: {"other": 1.0},
                         clock=ManualClock())
        for _ in range(10):
            ctl.tick()
        assert state["x"] == 4
        assert ctl.decision_log == []


class TestOscillationGuard:
    def _hostile(self, state, **kw):
        state["x"] = 4

        def feed():
            return {"throughput": 100.0 - 50.0 * abs(state["x"] - 4)}

        kw.setdefault("settle", 1)
        kw.setdefault("cooldown", 2)
        kw.setdefault("guard_window", 16)
        kw.setdefault("guard_reverts", 2)
        kw.setdefault("freeze", 6)
        return Controller(_registry(state), feed, clock=ManualClock(), **kw)

    def test_regressions_revert_then_freeze(self):
        state = {}
        ctl = self._hostile(state)
        for _ in range(30):
            ctl.tick()
        assert state["x"] == 4
        assert ctl.counts["reverts"] >= 2
        assert ctl.counts["freezes"] >= 1
        acts = [d["action"] for d in ctl.decision_log]
        assert "freeze" in acts and "unfreeze" in acts
        assert acts[:acts.index("freeze")].count("revert") == 2

    def test_frozen_knob_is_not_probed(self):
        state = {}
        ctl = self._hostile(state, freeze=8)
        frozen_ticks = []
        for _ in range(30):
            ctl.tick()
            if ctl.frozen():
                frozen_ticks.append(ctl._tick)
        assert frozen_ticks, "guard never engaged"
        probes = [d["tick"] for d in ctl.decision_log
                  if d["action"] == "probe"]
        assert not set(probes) & set(frozen_ticks)

    def test_cooldown_blocks_immediate_reprobe(self):
        state = {}
        ctl = self._hostile(state, cooldown=4, guard_reverts=99)
        for _ in range(24):
            ctl.tick()
        last_block = None
        for d in ctl.decision_log:
            if d["action"] == "probe":
                assert last_block is None or d["tick"] >= last_block + 4
            elif d["action"] in ("revert", "settle"):
                last_block = d["tick"]

    def test_neutral_change_settles_quietly(self):
        state = {"x": 4}
        ctl = Controller(_registry(state), lambda: {"throughput": 100.0},
                         settle=1, hysteresis=0.05, cooldown=0,
                         clock=ManualClock())
        for _ in range(8):
            ctl.tick()
        assert state["x"] == 4
        assert ctl.counts["settles"] >= 1
        assert ctl.counts["reverts"] == 0
        assert ctl.counts["freezes"] == 0


def _bool_reg(state, name="kv.prefetch"):
    reg = KnobRegistry()
    reg.register(Knob(name, lambda: state["on"],
                      lambda v: state.__setitem__("on", v), kind="bool"))
    return reg


class TestRules:
    def test_prefetch_rule_fires_and_names_signal(self):
        state = {"on": False}
        sig = {"tiering_spill_rate": 0.0, "throughput": 1.0}
        ctl = Controller(_bool_reg(state), lambda: dict(sig),
                         rules=[prefetch_rule()], clock=ManualClock())
        ctl.tick()
        assert state["on"] is False
        sig["tiering_spill_rate"] = 2.0
        decisions = ctl.tick()
        assert state["on"] is True
        rule_d = [d for d in decisions if d["action"] == "rule"]
        assert rule_d and rule_d[0]["signal"] == "tiering_spill_rate"
        assert rule_d[0]["knob"] == "kv.prefetch"

    def test_rule_cooldown(self):
        state = {"on": False}
        rule = prefetch_rule()
        rule.cooldown = 5
        ctl = Controller(_bool_reg(state), lambda: {"tiering_spill_rate": 2.0},
                         rules=[rule], clock=ManualClock())
        fire_ticks = []
        for _ in range(12):
            fire_ticks += [d["tick"] for d in ctl.tick()
                           if d["action"] == "rule"]
            state["on"] = False
        assert fire_ticks
        assert all(b - a >= 5 for a, b in zip(fire_ticks, fire_ticks[1:]))

    def test_slo_shed_rule_lowers_router_deferral(self):
        class FakeRouter:
            burn_defer = 2.0
            burn_shed = 4.0
            queue_cap = 8

        router = FakeRouter()
        ctl = Controller(router_knobs(router), lambda: {"slo_burn_max": 3.0},
                         rules=[slo_shed_rule(threshold=1.5, defer_at=1.0)],
                         clock=ManualClock())
        ctl.tick()
        assert router.burn_defer == 1.0


def _load_summarize():
    path = os.path.join(REPO_ROOT, "scripts", "trace_summarize.py")
    spec = importlib.util.spec_from_file_location("_ts_mod", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class TestEmission:
    def test_decisions_hit_trace_and_metrics(self, registry, global_trace,
                                             tmp_path, capsys):
        global_trace.configure(enabled=True)
        state = {}
        ctl = _climb(state, optimum=6, start=4)
        for _ in range(10):
            ctl.tick()
        assert ctl.decision_log
        snap = registry.scalar_summary()
        assert snap.get("dstpu_control_ticks_total") == 10
        total = sum(v for k, v in snap.items()
                    if k.startswith("dstpu_control_decisions_total"))
        assert total == len(ctl.decision_log)
        out = tmp_path / "ctl.json"
        global_trace.export(str(out))
        doc = json.loads(out.read_text())
        evs = [e for e in doc["traceEvents"]
               if e.get("cat") == "control"
               and e.get("name") == "control_decision"]
        assert len(evs) == len(ctl.decision_log)
        assert all(e["args"].get("signal") for e in evs)
        ts = _load_summarize()
        assert ts.main(["--control", str(out)]) == 0
        rendered = capsys.readouterr().out
        assert "control decision" in rendered and "t.x" in rendered
        assert ts.main(["--validate", str(out)]) == 0


# -- one seeded trace through both controllers ---------------------------------

def _twin(pkg_knob, pkg_reg, pkg_ctl, rules_fn, seed):
    """A controller of one package over three knobs (int, float, bool) and
    a feed whose objective depends on the knobs plus seeded noise and
    whose spill signal toggles the prefetch rule."""
    state = {"x": 3, "y": 1.0, "on": False}
    reg = pkg_reg()
    reg.register(pkg_knob("t.x", lambda: state["x"],
                          lambda v: state.__setitem__("x", v),
                          lo=1, hi=8, step=1, kind="int"))
    reg.register(pkg_knob("t.y", lambda: state["y"],
                          lambda v: state.__setitem__("y", v),
                          lo=0.0, hi=4.0, step=0.5, kind="float",
                          cooldown=2))
    reg.register(pkg_knob("kv.prefetch", lambda: state["on"],
                          lambda v: state.__setitem__("on", v),
                          kind="bool"))
    rng = np.random.default_rng(seed)
    clock = ManualClock()

    def feed():
        clock.t += 0.25
        noise = float(rng.normal(0.0, 3.0))
        if rng.random() < 0.1:
            state["on"] = False           # something turned it off
        return {"throughput": (100.0 - 4.0 * (state["x"] - 6) ** 2
                               - 6.0 * (state["y"] - 2.5) ** 2 + noise),
                "tiering_spill_rate": float(rng.random() < 0.3)}

    return pkg_ctl(reg, feed, clock=clock, settle=2, hysteresis=0.03,
                   cooldown=1, guard_window=12, guard_reverts=2, freeze=6,
                   smooth=0.6, rules=rules_fn()), state


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_decision_log_equals_jax_controller(seed):
    port, ps = _twin(Knob, KnobRegistry, Controller,
                     lambda: [prefetch_rule()], seed)
    ref, rs = _twin(jctl.Knob, jctl.KnobRegistry, jctl.Controller,
                    lambda: [jctl.prefetch_rule()], seed)
    for _ in range(120):
        assert port.tick() == ref.tick()
        assert ps == rs
    assert port.decision_log == ref.decision_log
    assert port.counts == ref.counts
    acts = {d["action"] for d in port.decision_log}
    assert {"probe", "rule"} <= acts and len(acts) >= 4, acts
    assert port.stats() == ref.stats()


# -- profiles and the offline sweep --------------------------------------------

class TestProfiles:
    def test_round_trip_and_fingerprint_gate(self, tmp_path):
        prof = HostProfile(knobs={"engine.harvest_interval": 4,
                                  "engine.async_depth": 2},
                           fingerprint=FP, metric=123.0,
                           metric_name="tok_per_s")
        path = save_profile(prof, str(tmp_path))
        assert os.path.basename(path) == \
            f"control_profile_{fingerprint_key(FP)}.json"
        got = load_profile(str(tmp_path), fingerprint=FP)
        assert got is not None and got.knobs == prof.knobs
        assert got.metric == 123.0
        other = dict(FP, cores=FP["cores"] + 64)
        assert load_profile(str(tmp_path), fingerprint=other) is None
        assert load_profile(path, fingerprint=other) is None
        assert load_profile(path, fingerprint=other,
                            strict=False) is not None

    def test_missing_or_garbage_is_none(self, tmp_path):
        assert load_profile(str(tmp_path), fingerprint=FP) is None
        p = tmp_path / f"control_profile_{fingerprint_key(FP)}.json"
        p.write_text("{not json")
        assert load_profile(str(tmp_path), fingerprint=FP) is None

    def test_fingerprint_names_the_device(self, monkeypatch):
        assert FP["device"] == "cpu"
        monkeypatch.setattr("torch.cuda.is_available", lambda: False)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            host_fingerprint()

    @pytest.mark.parametrize("writer", ["port", "jax"])
    def test_profiles_cross_packages(self, tmp_path, writer):
        """Either package's profile loads in the other under one explicit
        fingerprint, and is refused under another."""
        fp = {"cores": 8, "device": "nvidia-h100-80gb-hbm3", "nvme": False}
        knobs = {"engine.decode_block_size": 4, "engine.harvest_interval": 2}
        save, load = ((save_profile, jctl.load_profile) if writer == "port"
                      else (jctl.save_profile, load_profile))
        cls = HostProfile if writer == "port" else jctl.HostProfile
        path = save(cls(knobs=knobs, fingerprint=fp, metric=7.5,
                        metric_name="tok_per_s"), str(tmp_path))
        assert os.path.basename(path) == \
            f"control_profile_{jctl.fingerprint_key(fp)}.json"
        got = load(str(tmp_path), fingerprint=fp)
        assert got is not None and got.knobs == knobs and got.version == 1
        assert got.metric == 7.5
        assert load(str(tmp_path), fingerprint=dict(fp, nvme=True)) is None

    def test_autotune_serving_sweeps_and_persists(self, tmp_path, registry):
        def runner(point):
            if point["engine.async_depth"] == 3:
                raise RuntimeError("boom")
            return (10.0 * point["engine.harvest_interval"]
                    - point["engine.async_depth"])

        prof = autotune_serving(
            runner, {"engine.harvest_interval": [2, 4],
                     "engine.async_depth": [1, 3]},
            save_to=str(tmp_path), device="cpu")
        assert prof is not None and prof.fingerprint == FP
        assert prof.knobs == {"engine.harvest_interval": 4,
                              "engine.async_depth": 1}
        assert prof.metric == 39.0
        got = load_profile(str(tmp_path), fingerprint=FP)
        assert got is not None and got.knobs == prof.knobs
        snap = registry.scalar_summary()
        assert snap.get(
            'dstpu_autotune_experiments_total{status="ok"}') == 2
        assert snap.get(
            'dstpu_autotune_experiments_total{status="error"}') == 2
        assert snap.get("dstpu_autotune_best_metric") == 39.0

    @pytest.mark.parametrize("tuner", ["gridsearch", "random",
                                       "model_based"])
    def test_autotune_serving_picks_the_jax_winner(self, tuner):
        space = {"engine.decode_block_size": [2, 4, 8, 16],
                 "engine.harvest_interval": [1, 2, 4]}

        def runner(point):
            b, h = point["engine.decode_block_size"], \
                point["engine.harvest_interval"]
            if b == 16 and h == 1:
                raise MemoryError("synthetic")
            return 50.0 - (b - 8) ** 2 - 3.0 * (h - 2) ** 2

        got = autotune_serving(runner, space, tuner=tuner, n_trials=8,
                               seed=3, device="cpu")
        ref = jctl.autotune_serving(runner, space, tuner=tuner, n_trials=8,
                                    seed=3)
        assert got.knobs == ref.knobs and got.metric == ref.metric
        assert got.source == ref.source


class TestKillSwitch:
    def test_env_disables(self, monkeypatch):
        monkeypatch.delenv("DSTPU_CONTROL", raising=False)
        assert control_enabled()
        monkeypatch.setenv("DSTPU_CONTROL", "0")
        assert not control_enabled()
        monkeypatch.setenv("DSTPU_CONTROL", "1")
        assert control_enabled()


# -- the v2 engine's attach points ---------------------------------------------

def _jax_engine(weights, pipeline=True, **kw):
    return JaxEngine(jax_llama.LlamaForCausalLM(_jax_cfg()),
                     params=weights["params"], pipeline=pipeline,
                     **{**BASE, **PIPE, **kw})


def _knob_rows(reg):
    return [(k.name, k.lo, k.hi, k.step, k.kind, k.cooldown, k.recompiles)
            for k in (reg.get(n) for n in reg.names())]


@pytest.mark.parametrize("tiering", [False, True], ids=["flat", "tiered"])
@pytest.mark.parametrize("spec", ["off", "ngram"])
def test_knob_registry_equals_jax(weights, tiering, spec):
    kw = dict(speculation=spec)
    if tiering:
        kw["kv_tiering"] = {"host_pages": 16}
    port = port_engine(weights["state"], True, **PIPE, **kw)
    ref = _jax_engine(weights, **kw)
    preg, rreg = port.knob_registry(), ref.knob_registry()
    assert _knob_rows(preg) == _knob_rows(rreg)
    assert preg.snapshot() == rreg.snapshot()
    assert [k.name for k in preg.tunable()] == [k.name
                                                for k in rreg.tunable()]
    port.close()
    ref.close()


@pytest.fixture(scope="module")
def jax_armed(weights):
    eng = _jax_engine(weights, control=CTL)
    outs = eng.generate_all(_prompts([5, 11, 3, 7], 3), max_new_tokens=12)
    return outs, eng.serving_stages()["control"]


def test_armed_greedy_equals_off_and_jax(weights, jax_armed, monkeypatch):
    """The controller probes the online knobs while it serves: greedy
    tokens equal control off and the JAX engine's with control armed."""
    monkeypatch.delenv("DSTPU_CONTROL", raising=False)
    prompts = _prompts([5, 11, 3, 7], 3)
    on = port_engine(weights["state"], True, control=CTL, **PIPE)
    got = on.generate_all(prompts, max_new_tokens=12)
    off = port_engine(weights["state"], True, **PIPE).generate_all(
        prompts, max_new_tokens=12)
    ctl = on.serving_stages()["control"]
    assert ctl["ticks"] > 0 and ctl["probes"] > 0
    assert on._controller.decision_log
    assert_same(got, off)
    assert_same(got, jax_armed[0])


def test_control_stage_keys_equal_jax(weights, jax_armed, monkeypatch):
    monkeypatch.delenv("DSTPU_CONTROL", raising=False)
    eng = port_engine(weights["state"], True, control=CTL, **PIPE)
    eng.generate_all(_prompts([5, 11, 3, 7], 3), max_new_tokens=12)
    got, want = eng.serving_stages()["control"], jax_armed[1]
    assert sorted(got) == sorted(want)
    assert sorted(got["knobs"]) == sorted(want["knobs"])
    assert "control" not in port_engine(weights["state"], True,
                                        **PIPE).serving_stages()


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "static"])
def test_greedy_parity_across_midrun_knob_change(weights, graph):
    """harvest_interval and async_depth only move work between the host's
    and the device's timelines: changing them mid-run through the knob
    registry leaves greedy outputs bit-identical."""
    cfg = {"enable_cuda_graph": True} if graph else None
    prompts = _prompts([5, 11, 3], 3)
    base = serve(port_engine(weights["state"], True, config=cfg, **PIPE),
                 prompts, max_new_tokens=20)
    eng = port_engine(weights["state"], True, config=cfg, **PIPE)
    for p in prompts:
        eng.put_request(p, max_new_tokens=20)
    reg = eng.knob_registry()
    outs, step = {}, 0
    while eng.has_work():
        if step == 2:
            reg.set("engine.harvest_interval", 1)
            reg.set("engine.async_depth", 4)
        elif step == 4:
            reg.set("engine.harvest_interval", 16)
            reg.set("engine.async_depth", 1)
        eng.step()
        outs.update(eng.get_outputs())
        step += 1
    outs.update(eng.get_outputs())
    assert step > 4, "run too short to exercise both changes"
    assert_same(base, outs)


def test_block_knobs_rebuild_the_block(weights):
    """A knob that a captured block bakes in is offline only; set between
    runs, it drops the block's graphs and harvest rings, and the next run
    serves the new block length with the same greedy tokens."""
    prompts = _prompts([5, 11, 3], 3)
    eng = port_engine(weights["state"], True, speculation="ngram", **PIPE)
    want = eng.generate_all(prompts, max_new_tokens=12)
    reg = eng.knob_registry()
    with pytest.raises(RuntimeError, match="recompiles"):
        reg.set("engine.decode_block_size", 2)
    assert eng._rings
    reg.set("engine.decode_block_size", 2, allow_recompile=True)
    reg.set("engine.spec_k", 2, allow_recompile=True)
    assert (eng.decode_block_size, eng.spec_k) == (2, 2)
    assert not eng._rings and not eng._graphs.graphs
    got = eng.generate_all(prompts, max_new_tokens=12)
    assert_same(dict(zip(range(3), want.values())),
                dict(zip(range(3), got.values())))
    rows = {r[0].shape[1] for r in eng._rings.values()}
    assert rows <= {2, 2 * 3}            # K ticks, K (k+1) spec rows


def test_profile_seeds_decode_block_size(weights, tmp_path, monkeypatch):
    """A profile for this host seeds the engine's knobs at construction,
    before any block runs (``decode_block_size`` included); a profile of
    another host is ignored."""
    monkeypatch.delenv("DSTPU_CONTROL", raising=False)
    save_profile(HostProfile(knobs={"engine.decode_block_size": 2,
                                    "engine.harvest_interval": 5},
                             fingerprint=FP), str(tmp_path))
    eng = port_engine(weights["state"], True,
                      control={"profile": str(tmp_path), "interval": 4},
                      **PIPE)
    assert (eng.decode_block_size, eng.harvest_interval) == (2, 5)
    prompts = _prompts([5, 11, 3], 3)
    got = eng.generate_all(prompts, max_new_tokens=10)
    want = port_engine(weights["state"], True, **PIPE).generate_all(
        prompts, max_new_tokens=10)
    assert_same(got, want)
    foreign = tmp_path / "foreign"
    save_profile(HostProfile(knobs={"engine.decode_block_size": 2},
                             fingerprint=dict(FP, cores=FP["cores"] + 1)),
                 str(foreign))
    path = os.path.join(str(foreign), os.listdir(foreign)[0])
    eng = port_engine(weights["state"], True, control={"profile": path},
                      **PIPE)
    assert eng.decode_block_size == PIPE["decode_block_size"]


def test_signal_feed_reads_the_engine(weights):
    """``engine_signal_feed`` reads the port's counters: throughput from
    the ticks dispatched, pool pressure, the window's submit_wait share."""
    eng = port_engine(weights["state"], True, **PIPE)
    clock = ManualClock()
    feed = engine_signal_feed(eng, clock=clock)
    assert set(feed()) == {"blocking_gets_per_dispatch", "pool_pressure"}
    for p in _prompts([5, 11], 3):
        eng.put_request(p, max_new_tokens=64)
    for _ in range(6):
        eng.step()
    assert eng.has_work()
    clock.t = 2.0
    sig = feed()
    assert sig["throughput"] == eng.host_stats.ticks / 2.0 > 0
    assert 0.0 <= sig["submit_wait_frac"] <= 1.0
    assert sig["pool_pressure"] > 0
    assert sig["pool_pressure"] == pytest.approx(
        eng.serving_stages()["pool"]["pressure"], abs=1e-4)
