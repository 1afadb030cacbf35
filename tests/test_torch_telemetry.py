"""The telemetry port against its reference: copies of the JAX package's
``tests/unit/test_telemetry.py`` (tracer, percentiles, the request
latency tracker, the flight recorder) and ``tests/unit/test_metrics_slo.py``
(the metrics registry, SLO burn rates, tail sampling), pointed at
``deepspeed_tpu_torch.telemetry``; then the port's v2 engine with SLOs and
tail sampling armed, and its lifecycle events and latency records against
the JAX engine's on the same traffic.

Left out: the reference's monitor bridge (``MonitorMaster`` is not
ported) and its zero-new-compilations guard, which needs jax's
compilation counter.
"""
import json
import os
import threading

import pytest

from deepspeed_tpu_torch.telemetry import (RequestLatencyTracker, flight,
                                           percentile, read_flight_record)
from deepspeed_tpu_torch.telemetry import metrics as metrics_mod
from deepspeed_tpu_torch.telemetry import tracer as tracer_mod
from deepspeed_tpu_torch.telemetry.metrics import (MetricsRegistry,
                                                   exponential_buckets,
                                                   validate_metrics_doc)
from deepspeed_tpu_torch.telemetry.slo import (SLOSet, TailSampler,
                                               parse_objective)
from deepspeed_tpu_torch.telemetry.tracer import Tracer
import torch_cpu  # noqa: F401  (one torch thread a process)


class ManualClock:
    """Injectable monotonic source the tests advance by hand."""

    def __init__(self, t: float = 0.0):
        self.t = t

    def __call__(self) -> float:
        return self.t


@pytest.fixture
def global_trace():
    """The process singleton, restored to its prior configuration."""
    tr = tracer_mod.trace
    prev = (tr.enabled, tr.buffer_size, tr.clock, tr.annotate)
    tr.clear()
    yield tr
    tr.configure(enabled=prev[0], buffer_size=prev[1], clock=prev[2],
                 annotate=prev[3])
    tr.clear()


# ---------------------------------------------------------------------------
# Tracer
# ---------------------------------------------------------------------------


class TestTracer:
    def test_disabled_span_is_shared_singleton(self):
        """The disabled fast path allocates nothing: every span() call
        returns the SAME no-op object, events/add_complete are no-ops."""
        tr = Tracer(enabled=False)
        s1 = tr.span("a")
        s2 = tr.span("b", big_attr="x" * 1000)
        assert s1 is s2
        assert s1 is tracer_mod._NULL_SPAN
        with s1:
            pass
        tr.event("never", uid=1)
        tr.add_complete("never", 0.0, 1.0)
        assert tr.snapshot() == []

    def test_span_records_complete_event(self):
        clk = ManualClock()
        tr = Tracer(enabled=True, clock=clk)
        clk.t = 2.0
        with tr.span("swap_in_wait", cat="swap", bucket=3):
            clk.t = 2.5
        (ev,) = tr.snapshot()
        assert ev["ph"] == "X"
        assert ev["name"] == "swap_in_wait"
        assert ev["cat"] == "swap"
        assert ev["ts"] == pytest.approx(2.0e6)       # us since epoch=0
        assert ev["dur"] == pytest.approx(0.5e6)
        assert ev["args"] == {"bucket": 3}
        assert ev["tid"] == threading.get_ident()

    def test_span_nesting_is_contained(self):
        clk = ManualClock()
        tr = Tracer(enabled=True, clock=clk)
        clk.t = 1.0
        with tr.span("outer"):
            clk.t = 2.0
            with tr.span("inner"):
                clk.t = 3.0
            clk.t = 5.0
        inner, outer = tr.snapshot()    # ts-sorted: outer@1.0 first
        assert (inner["name"], outer["name"]) == ("outer", "inner")
        inner, outer = outer, inner
        assert inner["ts"] >= outer["ts"]
        assert inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]
        assert inner["dur"] == pytest.approx(1.0e6)
        assert outer["dur"] == pytest.approx(4.0e6)

    def test_span_exception_tags_error_and_propagates(self):
        tr = Tracer(enabled=True, clock=ManualClock())
        with pytest.raises(KeyError):
            with tr.span("doomed", cat="swap"):
                raise KeyError("boom")
        (ev,) = tr.snapshot()
        assert ev["args"]["error"] == "KeyError"

    def test_event_is_instant(self):
        clk = ManualClock(t=0.0)
        tr = Tracer(enabled=True, clock=clk)
        clk.t = 1.5
        tr.event("request_submit", cat="request", uid=7)
        (ev,) = tr.snapshot()
        assert ev["ph"] == "i"
        assert ev["cat"] == "request"
        assert ev["args"] == {"uid": 7}
        assert ev["ts"] == pytest.approx(1.5e6)

    def test_add_complete_shares_clock(self):
        """Adapters hand in externally bracketed (t0, dt) pairs read
        from the SAME clock; ts/dur must line up with span() output."""
        clk = ManualClock()
        tr = Tracer(enabled=True, clock=clk)
        tr.add_complete("bucket_update", start=4.0, dur_s=0.25,
                        cat="swap", bytes=123)
        (ev,) = tr.snapshot()
        assert ev["ts"] == pytest.approx(4.0e6)
        assert ev["dur"] == pytest.approx(0.25e6)
        assert ev["args"]["bytes"] == 123

    def test_per_thread_rings_are_bounded_and_isolated(self):
        tr = Tracer(enabled=True, buffer_size=16, clock=ManualClock())
        # keep every worker alive until all have recorded — a finished
        # thread's ident can be reused, which would merge two timelines
        barrier = threading.Barrier(3)

        def work(i):
            for k in range(30):
                with tr.span(f"thread{i}", idx=k):
                    pass
            barrier.wait()

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        evs = tr.snapshot()
        by_tid = {}
        for ev in evs:
            by_tid.setdefault(ev["tid"], []).append(ev)
        assert len(by_tid) == 3
        for tid, tevs in by_tid.items():
            assert len(tevs) == 16          # ring dropped the oldest 14
            names = {ev["name"] for ev in tevs}
            assert len(names) == 1          # no cross-thread bleed
            # the ring keeps the most RECENT events
            assert {ev["args"]["idx"] for ev in tevs} == set(range(14, 30))

    def test_configure_mutates_singleton_in_place(self, global_trace):
        """Modules import ``trace`` by value at import time; configure
        must mutate that same object, never rebind it."""
        tr = global_trace
        before = id(tr)
        clk = ManualClock()
        assert tracer_mod.configure(enabled=True, buffer_size=4,
                                    clock=clk) is tr
        assert id(tracer_mod.trace) == before
        for i in range(9):
            tr.event("e", i=i)
        assert len(tr.snapshot()) == 4
        tr.configure(enabled=False)
        tr.event("after_disable")
        assert len(tr.snapshot()) == 4

    def test_export_chrome_trace_schema(self, tmp_path):
        clk = ManualClock()
        tr = Tracer(enabled=True, clock=clk)
        clk.t = 1.0
        with tr.span("apply", cat="swap", buckets=2):
            clk.t = 1.75
        tr.event("request_submit", cat="request", uid=1)
        path = str(tmp_path / "trace.json")
        assert tr.export(path) == path
        with open(path) as f:
            doc = json.load(f)
        assert doc["displayTimeUnit"] == "ms"
        evs = doc["traceEvents"]
        assert isinstance(evs, list)
        phs = {"X": 0, "i": 0, "M": 0}
        for ev in evs:
            assert ev["ph"] in phs
            phs[ev["ph"]] += 1
            assert isinstance(ev["name"], str) and ev["name"]
            if ev["ph"] == "M":
                continue
            assert ev["pid"] == os.getpid()
            assert isinstance(ev["ts"], (int, float))
            assert isinstance(ev["tid"], int)
            if ev["ph"] == "X":
                assert ev["dur"] >= 0
        assert phs == {"X": 1, "i": 1, "M": 2}   # process + 1 thread name
        names = {ev["name"]: ev for ev in evs}
        assert names["apply"]["args"] == {"buckets": 2}
        assert names["process_name"]["args"]["name"].startswith(
            "deepspeed_tpu")


# ---------------------------------------------------------------------------
# Percentiles + request latency
# ---------------------------------------------------------------------------


class TestPercentile:
    def test_nearest_rank_hand_fixture(self):
        vals = [50.0, 15.0, 35.0, 20.0, 40.0]     # sorted: 15 20 35 40 50
        assert percentile(vals, 50) == 35.0       # rank ceil(2.5) = 3
        assert percentile(vals, 90) == 50.0       # rank ceil(4.5) = 5
        assert percentile(vals, 99) == 50.0
        assert percentile(vals, 1) == 15.0        # rank floors at 1
        decade = list(range(10, 101, 10))
        assert percentile(decade, 50) == 50
        assert percentile(decade, 90) == 90
        assert percentile(decade, 99) == 100      # rank ceil(9.9) = 10

    def test_edge_cases(self):
        assert percentile([], 50) is None
        assert percentile([7.0], 50) == 7.0
        assert percentile([7.0], 99) == 7.0
        assert percentile([3.0, 1.0], 100) == 3.0


class TestRequestLatencyTracker:
    def test_hand_computed_percentiles(self):
        clk = ManualClock()
        tk = RequestLatencyTracker(clock=clk)
        # uid 1: queue 10ms, ttft 50ms, 5 tokens -> tpot (130-50)/4 = 20ms
        clk.t = 0.000
        tk.on_submit(1)
        clk.t = 0.010
        tk.on_admit(1)
        clk.t = 0.050
        tk.on_tokens(1, 1)
        clk.t = 0.130
        tk.on_tokens(1, 5)
        tk.on_finish(1)
        # uid 2: queue 0ms, ttft 20ms, 2 tokens -> tpot 20ms, one spill
        # stalling 30ms
        clk.t = 0.200
        tk.on_submit(2)
        tk.on_admit(2)
        clk.t = 0.220
        tk.on_tokens(2, 1)
        tk.on_spill(2)
        tk.on_restore_stall(2, 0.030)
        clk.t = 0.240
        tk.on_tokens(2, 2)
        tk.on_finish(2)
        s = tk.summary()
        assert s["completed"] == 2
        assert s["submitted"] == 2
        assert s["in_flight"] == 0
        # n=2: p50 rank 1 (min), p99 rank 2 (max)
        assert s["ttft_ms_p50"] == pytest.approx(20.0)
        assert s["ttft_ms_p99"] == pytest.approx(50.0)
        assert s["queue_wait_ms_p50"] == pytest.approx(0.0)
        assert s["queue_wait_ms_p99"] == pytest.approx(10.0)
        assert s["tpot_ms_p50"] == pytest.approx(20.0)
        assert s["tpot_ms_p99"] == pytest.approx(20.0)
        # only the spilled request contributes a stall sample
        assert s["spill_stall_ms_p50"] == pytest.approx(30.0)

    def test_summary_is_flat_and_none_safe(self):
        """write_serving_health flattens one level and keeps numeric
        scalars; an empty tracker must be flat with None percentiles."""
        s = RequestLatencyTracker().summary()
        assert all(not isinstance(v, dict) for v in s.values())
        assert s["ttft_ms_p50"] is None
        assert s["completed"] == 0

    def test_token_hook_idempotent_and_first_admit_wins(self):
        clk = ManualClock()
        tk = RequestLatencyTracker(clock=clk)
        tk.on_submit(1)
        clk.t = 0.005
        tk.on_admit(1)
        clk.t = 0.500
        tk.on_admit(1)                 # re-admit after evict: not queue wait
        clk.t = 0.600
        tk.on_tokens(1, 3)
        clk.t = 0.700
        tk.on_tokens(1, 3)             # unchanged cumulative count: no-op
        clk.t = 0.800
        tk.on_tokens(1, 4)
        tk.on_finish(1)
        s = tk.summary()
        assert s["queue_wait_ms_p50"] == pytest.approx(5.0)
        assert s["ttft_ms_p50"] == pytest.approx(600.0)
        # tpot spans first->last token over 3 increments... tokens=4,
        # (0.8 - 0.6) / (4 - 1) s
        assert s["tpot_ms_p50"] == pytest.approx(200.0 / 3)

    def test_completed_window_is_bounded(self):
        clk = ManualClock()
        tk = RequestLatencyTracker(clock=clk, max_completed=8)
        for uid in range(50):
            tk.on_submit(uid)
            tk.on_finish(uid)
        s = tk.summary()
        assert s["completed"] == 8
        assert s["submitted"] == 50


# ---------------------------------------------------------------------------
# Flight recorder
# ---------------------------------------------------------------------------


def _fault_instances():
    # the reference's swap_corruption case waits for the swap path
    # (ROADMAP A11); the port's hard-failure classes are these three
    from deepspeed_tpu_torch.inference.kv_tiering import KVRestoreError
    from deepspeed_tpu_torch.resilience.distributed import CollectiveTimeout
    from deepspeed_tpu_torch.resilience.guards import GradientAnomalyError
    return [
        ("collective_timeout", CollectiveTimeout("all_reduce deadline")),
        ("kv_restore_error", KVRestoreError(7, 2, "page 2 digest")),
        ("gradient_anomaly", GradientAnomalyError("4 consecutive skips")),
    ]


@pytest.mark.faults
class TestFlightRecorder:
    def test_dump_roundtrip_and_ring_bound(self, tmp_path, global_trace):
        global_trace.configure(enabled=True, buffer_size=32,
                               clock=ManualClock())
        for i in range(100):
            global_trace.event("tick", i=i)
        path = flight.dump_on_fault("unit_test", dir=str(tmp_path),
                                    extra={"step": 12})
        assert path is not None and os.path.dirname(path) == str(tmp_path)
        assert flight.last_dump_path() == path
        header, events = read_flight_record(path)
        assert header["reason"] == "unit_test"
        assert header["version"] == 1
        assert header["extra"] == {"step": 12}
        assert header["exception"] is None
        assert len(events) == 32               # the ring bound, not 100
        assert [ev["args"]["i"] for ev in events] == list(range(68, 100))

    @pytest.mark.parametrize("reason,exc",
                             _fault_instances(),
                             ids=lambda v: v if isinstance(v, str) else "")
    def test_dump_per_exception_class(self, tmp_path, global_trace,
                                      reason, exc):
        global_trace.configure(enabled=True, clock=ManualClock())
        global_trace.event("before_fault", cat="swap")
        path = flight.dump_on_fault(reason, exc, dir=str(tmp_path))
        assert os.path.basename(path).startswith(f"flight_{reason}_")
        header, events = read_flight_record(path)
        assert header["reason"] == reason
        assert header["exception"]["type"] == type(exc).__name__
        assert str(exc) in header["exception"]["message"]
        assert any(ev["name"] == "before_fault" for ev in events)

    def test_dedupe_per_exception_per_destination(self, tmp_path,
                                                  global_trace):
        from deepspeed_tpu_torch.inference.kv_tiering import KVRestoreError
        err = KVRestoreError(3, 0, "once")
        a, b = str(tmp_path / "a"), str(tmp_path / "b")
        p1 = flight.dump_on_fault("kv_restore_error", err, dir=a)
        p2 = flight.dump_on_fault("kv_restore_error", err, dir=a)
        p3 = flight.dump_on_fault("kv_restore_error", err, dir=b)
        assert p1 == p2                 # same exc + same dir: one file
        assert p3 != p1                 # engine copy next to the
        assert os.path.dirname(p3) == b     # emergency checkpoint
        assert len(os.listdir(a)) == 1

    def test_truncated_dump_is_detected(self, tmp_path, global_trace):
        global_trace.configure(enabled=True, clock=ManualClock())
        global_trace.event("tick")
        path = flight.dump_on_fault("trunc", dir=str(tmp_path))
        read_flight_record(path)        # intact: parses
        with open(path) as f:
            lines = f.read().splitlines()
        with open(path, "w") as f:
            f.write("\n".join(lines[:-1]))     # kill mid-write
        with pytest.raises(ValueError, match="truncated"):
            read_flight_record(path)
        # count mismatch is also caught
        with open(path, "w") as f:
            f.write("\n".join(lines[:1] + lines[2:]) + "\n")
        with pytest.raises(ValueError, match="count mismatch"):
            read_flight_record(path)

    def test_dump_never_raises(self, tmp_path, global_trace):
        bad = str(tmp_path / "file_not_dir")
        with open(bad, "w") as f:
            f.write("x")
        assert flight.dump_on_fault("broken", dir=bad) is None

    def test_guard_raise_leaves_parseable_dump(self, tmp_path,
                                               monkeypatch, global_trace):
        """End-to-end: the skipped-step guard's raise site dumps into
        DSTPU_FLIGHT_DIR without any engine plumbing."""
        from deepspeed_tpu_torch.resilience.guards import (GradientAnomalyError,
                                                     SkippedStepGuard)
        monkeypatch.setenv("DSTPU_FLIGHT_DIR", str(tmp_path))
        guard = SkippedStepGuard(bound=2)
        guard.update(True, step=1)
        with pytest.raises(GradientAnomalyError):
            guard.update(True, step=2)
        dumps = [f for f in os.listdir(tmp_path)
                 if f.startswith("flight_gradient_anomaly_")]
        assert len(dumps) == 1
        header, _ = read_flight_record(str(tmp_path / dumps[0]))
        assert header["extra"] == {"step": 2, "consecutive": 2}
        assert header["exception"]["type"] == "GradientAnomalyError"


@pytest.fixture
def registry():
    """The process singleton, emptied and restored around each test
    (emitters all feed the singleton, so tests must own its state)."""
    reg = metrics_mod.metrics
    prev = (reg.enabled, reg.clock, reg.slo)
    reg.reset()
    reg.configure(enabled=True)
    reg.slo = None
    yield reg
    reg.reset()
    reg.configure(enabled=prev[0], clock=prev[1])
    reg.slo = prev[2]


# ---------------------------------------------------------------------------
# Histogram fixtures (hand-computed)
# ---------------------------------------------------------------------------


class TestHistogram:
    def test_exponential_bucket_boundaries(self):
        assert exponential_buckets(1.0, 2.0, 4) == (1.0, 2.0, 4.0, 8.0)
        assert exponential_buckets(0.5, 4.0, 3) == (0.5, 2.0, 8.0)
        for bad in ((0.0, 2.0, 4), (1.0, 1.0, 4), (1.0, 2.0, 0)):
            with pytest.raises(ValueError):
                exponential_buckets(*bad)

    def test_observations_land_in_hand_computed_buckets(self):
        """Upper edges are inclusive (Prometheus ``le`` semantics)."""
        reg = MetricsRegistry()
        h = reg.histogram("h", buckets=(1.0, 2.0, 4.0, 8.0)).labels()
        for v in (0.5, 1.0, 1.5, 4.0, 9.0):
            h.observe(v)
        counts, hsum, n = h.merged()
        assert counts == [2, 1, 1, 0, 1]      # le=1,2,4,8,+Inf
        assert hsum == pytest.approx(16.0)
        assert n == 5

    def test_thread_shards_merge_exactly(self):
        """Each thread writes only its own shard (no lock on the record
        path); the merged read must still see every observation."""
        reg = MetricsRegistry()
        fam = reg.histogram("h", buckets=(1.0, 2.0, 4.0, 8.0))
        ctr = reg.counter("c")
        barrier = threading.Barrier(4)
        # thread i observes value (i+0.5) a hundred times: values 0.5,
        # 1.5, 2.5, 3.5 -> buckets 0, 1, 2, 2
        def work(i):
            barrier.wait()
            for _ in range(100):
                fam.observe(i + 0.5)
                ctr.inc()
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        counts, hsum, n = fam.labels().merged()
        assert counts == [100, 100, 200, 0, 0]
        assert n == 400
        assert hsum == pytest.approx(100 * (0.5 + 1.5 + 2.5 + 3.5))
        assert ctr.value() == 400

    def test_quantile_linear_interpolation(self):
        """target = q/100 * n; interpolate inside the crossing bucket by
        the fraction of its population below the target."""
        reg = MetricsRegistry()
        h = reg.histogram("h", buckets=(1.0, 2.0, 4.0, 8.0)).labels()
        for v in (0.5, 1.5, 3.0, 3.5):
            h.observe(v)
        # p50: target 2.0; bucket0 cum 1, bucket1 (1,2] crosses with
        # frac (2-1)/1 = 1 -> 1 + (2-1)*1 = 2.0
        assert h.quantile(50) == pytest.approx(2.0)
        # p75: target 3.0; cum after bucket1 = 2, bucket2 (2,4] holds 2,
        # frac (3-2)/2 = 0.5 -> 2 + (4-2)*0.5 = 3.0
        assert h.quantile(75) == pytest.approx(3.0)
        # p100: target 4.0 crosses in bucket2 at frac 1 -> 4.0
        assert h.quantile(100) == pytest.approx(4.0)

    def test_quantile_clamps_to_last_finite_bound(self):
        reg = MetricsRegistry()
        h = reg.histogram("h", buckets=(1.0, 2.0, 4.0, 8.0)).labels()
        h.observe(100.0)                      # +Inf bucket has no width
        assert h.quantile(99) == pytest.approx(8.0)

    def test_quantile_empty_is_none(self):
        reg = MetricsRegistry()
        assert reg.histogram("h", buckets=(1.0,)).quantile(50) is None

    def test_bucket_width_at(self):
        reg = MetricsRegistry()
        h = reg.histogram("h", buckets=(1.0, 2.0, 4.0, 8.0)).labels()
        assert h.bucket_width_at(0.3) == pytest.approx(1.0)
        assert h.bucket_width_at(3.0) == pytest.approx(2.0)
        assert h.bucket_width_at(50.0) == pytest.approx(4.0)  # last finite


class TestCounterGauge:
    def test_counter_monotonic(self):
        reg = MetricsRegistry()
        c = reg.counter("c").labels()
        c.inc()
        c.inc(2.5)
        assert c.value() == pytest.approx(3.5)
        with pytest.raises(ValueError):
            c.inc(-1)

    def test_set_total_is_monotonic_max(self):
        """Mirroring an external cumulative dict must never go backwards
        (a reset external counter keeps the high-water mark)."""
        reg = MetricsRegistry()
        c = reg.counter("c").labels()
        c.set_total(5)
        c.set_total(3)
        assert c.value() == 5.0
        c.set_total(9)
        assert c.value() == 9.0

    def test_gauge_last_write_wins_and_additive(self):
        reg = MetricsRegistry()
        g = reg.gauge("g").labels()
        g.set(3.0)
        g.set(1.5)
        assert g.value() == 1.5
        g2 = reg.gauge("g2").labels()
        g2.add(2.0)
        g2.add(3.0)
        assert g2.value() == 5.0

    def test_sync_counters_mirrors_numeric_entries(self):
        reg = MetricsRegistry()
        reg.sync_counters("pfx_", {"spills": 4, "ok": True, "x": "nope"})
        assert reg.get("pfx_spills_total").value() == 4.0
        assert reg.get("pfx_ok_total") is None       # bools skipped
        assert reg.get("pfx_x_total") is None
        reg.configure(enabled=False)
        reg.sync_counters("pfx_", {"spills": 9})
        assert reg.get("pfx_spills_total").value() == 4.0

    def test_kind_collision_raises(self):
        reg = MetricsRegistry()
        reg.counter("m")
        with pytest.raises(ValueError, match="already registered"):
            reg.gauge("m")


# ---------------------------------------------------------------------------
# Export formats
# ---------------------------------------------------------------------------


class TestExport:
    def test_exposition_histogram_lines(self):
        reg = MetricsRegistry(clock=ManualClock(7.0))
        h = reg.histogram("lat", help="latency",
                          buckets=(1.0, 2.0)).labels()
        for v in (0.5, 1.5, 9.0):
            h.observe(v)
        text = reg.export_text()
        lines = text.splitlines()
        assert "# HELP lat latency" in lines
        assert "# TYPE lat histogram" in lines
        assert 'lat_bucket{le="1"} 1' in lines       # cumulative
        assert 'lat_bucket{le="2"} 2' in lines
        assert 'lat_bucket{le="+Inf"} 3' in lines    # == count
        assert "lat_sum 11" in lines          # integral floats render bare
        assert "lat_count 3" in lines

    def test_exposition_label_escaping(self):
        reg = MetricsRegistry()
        reg.counter("c", labels=("who",)).labels(who='a"b\\c\nd').inc()
        line = [ln for ln in reg.export_text().splitlines()
                if ln.startswith("c{")][0]
        assert line == 'c{who="a\\"b\\\\c\\nd"} 1'

    def test_export_json_is_schema_valid_and_round_trips(self):
        reg = MetricsRegistry(clock=ManualClock(42.0))
        reg.counter("c", labels=("k",)).labels(k="v").inc(2)
        reg.gauge("g").set(1.25)
        h = reg.histogram("h", buckets=(1.0, 2.0)).labels()
        h.observe(0.5)
        h.observe(1.5)
        doc = json.loads(json.dumps(reg.export_json()))
        assert doc["record"] == "metrics"
        assert doc["unix_time"] == 42.0
        assert validate_metrics_doc(doc) == []
        (hist,) = doc["histograms"]
        assert hist["counts"] == [1, 1, 0]
        assert hist["count"] == 2
        assert hist["p50"] == pytest.approx(1.0)

    def test_validate_metrics_doc_catches_corruption(self):
        reg = MetricsRegistry()
        reg.histogram("h", buckets=(1.0, 2.0)).observe(0.5)
        good = reg.export_json()
        bad = json.loads(json.dumps(good))
        bad["histograms"][0]["counts"] = [1, 0]       # missing +Inf slot
        assert any("counts length" in p
                   for p in validate_metrics_doc(bad))
        bad = json.loads(json.dumps(good))
        bad["histograms"][0]["buckets"] = [2.0, 1.0]
        assert any("not increasing" in p
                   for p in validate_metrics_doc(bad))
        bad = json.loads(json.dumps(good))
        bad["histograms"][0]["count"] = 99
        assert any("sum(counts)" in p for p in validate_metrics_doc(bad))
        bad = json.loads(json.dumps(good))
        bad["record"] = "trace"
        assert any("record" in p for p in validate_metrics_doc(bad))
        assert validate_metrics_doc("nope") == [
            "metrics doc is not an object"]

    def test_scalar_summary_flattens(self):
        reg = MetricsRegistry()
        reg.counter("c").inc(3)
        h = reg.histogram("h", labels=("stage",), buckets=(1.0, 2.0))
        h.labels(stage="plan").observe(0.5)
        s = reg.scalar_summary()
        assert s["c"] == 3.0
        assert s['h{stage="plan"}_count'] == 1
        assert s['h{stage="plan"}_p50'] == pytest.approx(0.5)

    def test_reset_drops_families(self):
        reg = MetricsRegistry()
        reg.counter("c").inc()
        reg.reset()
        assert reg.get("c") is None
        assert reg.export_json()["counters"] == []


# ---------------------------------------------------------------------------
# SLO objectives & burn rate
# ---------------------------------------------------------------------------


class TestSLO:
    def test_parse_objective(self):
        o = parse_objective("ttft_ms_p99 <= 150")
        assert (o.metric, o.target, o.threshold) == ("ttft_ms", 0.99,
                                                     150.0)
        assert o.budget == pytest.approx(0.01)
        o = parse_objective("tpot_ms_p99.9<2.5")
        assert (o.metric, o.threshold) == ("tpot_ms", 2.5)
        assert o.target == pytest.approx(0.999)
        for bad in ("ttft_ms <= 150", "ttft_ms_p99 <=", "p99 <= 1",
                    "ttft_ms_p0 <= 1", "ttft_ms_p100 <= 1"):
            with pytest.raises(ValueError):
                parse_objective(bad)

    def test_burn_rate_hand_computed(self):
        """10 samples, 2 over threshold, p90 objective: error rate 0.2
        against a 0.1 budget = burn 2.0 (unhealthy)."""
        clk = ManualClock()
        s = SLOSet(["ttft_ms_p90 <= 100"], window_s=300.0, clock=clk)
        breaches = []
        for i, v in enumerate([50] * 8 + [200, 300]):
            clk.t = float(i)
            breaches += s.record("ttft_ms", v)
        assert breaches == ["ttft_ms_p90", "ttft_ms_p90"]
        st = s.evaluate()["ttft_ms_p90"]
        assert st["samples"] == 10 and st["breaches"] == 2
        assert st["error_rate"] == pytest.approx(0.2)
        assert st["burn_rate"] == pytest.approx(2.0)
        assert st["ok"] is False
        flat = s.flat_summary()
        assert flat["ttft_ms_p90_burn_rate"] == pytest.approx(2.0)
        assert flat["ttft_ms_p90_ok"] == 0

    def test_window_ages_samples_out(self):
        clk = ManualClock()
        s = SLOSet(["ttft_ms_p90 <= 100"], window_s=300.0, clock=clk)
        clk.t = 0.0
        s.record("ttft_ms", 500.0)            # breach at t=0
        clk.t = 200.0
        s.record("ttft_ms", 50.0)             # healthy at t=200
        clk.t = 250.0
        st = s.evaluate()["ttft_ms_p90"]
        assert st["samples"] == 2 and st["burn_rate"] > 1.0
        clk.t = 350.0                         # t=0 sample leaves window
        st = s.evaluate()["ttft_ms_p90"]
        assert st["samples"] == 1 and st["breaches"] == 0
        assert st["burn_rate"] == 0.0 and st["ok"] is True

    def test_record_request_covers_each_metric_once(self):
        """Two objectives on one metric: the request summary feeds the
        metric exactly once, record() fans out to both objectives."""
        clk = ManualClock()
        s = SLOSet(["ttft_ms_p50 <= 10", "ttft_ms_p99 <= 100",
                    "tpot_ms_p90 <= 5"], clock=clk)
        breached = s.record_request(
            {"uid": 1, "ttft_ms": 200.0, "tpot_ms": 1.0,
             "queue_wait_ms": None})
        assert sorted(breached) == ["ttft_ms_p50", "ttft_ms_p99"]
        ev = s.evaluate()
        assert ev["ttft_ms_p50"]["samples"] == 1
        assert ev["ttft_ms_p99"]["samples"] == 1
        assert ev["tpot_ms_p90"]["samples"] == 1
        assert s.total_samples == 3           # one per objective

    def test_duplicate_objectives_rejected(self):
        with pytest.raises(ValueError, match="duplicate"):
            SLOSet(["ttft_ms_p99 <= 1", "ttft_ms_p99 <= 2"])


# ---------------------------------------------------------------------------
# Tail sampling
# ---------------------------------------------------------------------------


class TestTailSampler:
    def test_deterministic_under_seed(self):
        a = TailSampler(n=4, seed=123)
        b = TailSampler(n=4, seed=123)
        da = [a.should_promote() for _ in range(200)]
        db = [b.should_promote() for _ in range(200)]
        assert da == db
        assert a.promoted_sample > 0
        assert a.promoted_sample + a.dropped == 200
        # roughly 1-in-4 (binomial, wide tolerance — determinism is the
        # contract, the rate is a sanity floor)
        assert 20 <= a.promoted_sample <= 90

    def test_breach_consumes_rng_stream(self):
        """Decision k must be identical across runs regardless of how
        many earlier decisions were breach-promoted."""
        plain = TailSampler(n=4, seed=9)
        mixed = TailSampler(n=4, seed=9)
        ref = [plain.should_promote() for _ in range(50)]
        got = [mixed.should_promote(breached=(i == 0))
               for i in range(50)]
        assert got[0] == (True, "slo_breach")
        assert got[1:] == ref[1:]

    def test_n_zero_promotes_only_breach_and_error(self):
        s = TailSampler(n=0, seed=1)
        assert s.should_promote() == (False, "")
        assert s.should_promote(breached=True) == (True, "slo_breach")
        assert s.should_promote(errored=True) == (True, "error")
        assert s.should_promote(breached=True, errored=True) == (
            True, "slo_breach")              # breach outranks error
        c = s.counters()
        assert c["decisions"] == 4
        assert c["promoted_breach"] == 2 and c["promoted_error"] == 1
        assert c["dropped"] == 1


class TestTracerPromotion:
    def test_promote_filters_other_uid_lifecycles(self):
        """The retained ring gets the promoted uid's lifecycle plus the
        shared serving spans in its window — neighbours' request events
        and out-of-window spans stay out."""
        clk = ManualClock()
        tr = Tracer(enabled=True, sampling=True, clock=clk)
        clk.t = 1.0
        tr.event("request_submit", cat="request", uid=1)
        tr.event("request_submit", cat="request", uid=2)
        tr.add_complete("decode_block", 1.1, 1.4, cat="request",
                        uids=[1, 2])
        tr.add_complete("prefill_chunk", 1.2, 1.3, cat="serving")
        clk.t = 2.0
        tr.event("request_reap", cat="request", uid=1)
        tr.add_complete("late_span", 5.0, 6.0, cat="serving")
        assert tr.retained_snapshot() == []   # staging is scratch
        n = tr.promote(1, 1.0, 2.0, reason="slo_breach")
        kept = tr.retained_snapshot()
        names = [ev["name"] for ev in kept]
        assert n == 4
        assert names.count("request_submit") == 1     # uid 2 filtered
        assert "decode_block" in names                # shared, uid in uids
        assert "prefill_chunk" in names               # serving span rides
        assert "request_reap" in names
        assert "late_span" not in names
        marker = kept[-1]
        assert marker["name"] == "promoted"
        assert marker["args"] == {"uid": 1, "reason": "slo_breach",
                                  "events": 4}

    def test_export_writes_retained_ring_when_sampling(self, tmp_path):
        clk = ManualClock()
        tr = Tracer(enabled=True, sampling=True, clock=clk)
        clk.t = 1.0
        tr.event("request_submit", cat="request", uid=7)
        path = str(tmp_path / "t.json")
        tr.export(path)
        with open(path) as f:                 # only "M" metadata rows
            assert [ev for ev in json.load(f)["traceEvents"]
                    if ev["ph"] != "M"] == [] # nothing promoted
        tr.promote(7, 0.9, 1.1, reason="sample")
        tr.export(path)
        with open(path) as f:
            names = [ev["name"] for ev in json.load(f)["traceEvents"]]
        assert "request_submit" in names and "promoted" in names


# ---------------------------------------------------------------------------
# Flight-dump embedding & monitor bridge
# ---------------------------------------------------------------------------


class TestFlightMetricsEmbed:
    def test_dump_embeds_schema_valid_snapshot(self, registry, tmp_path):
        from deepspeed_tpu_torch.telemetry import flight, read_flight_record

        registry.counter("dstpu_sdc_mismatches_total").inc(3)
        registry.histogram("dstpu_request_ttft_ms",
                           buckets=(1.0, 2.0)).observe(1.5)
        path = flight.dump_on_fault("unit_metrics", dir=str(tmp_path))
        header, _events = read_flight_record(path)
        snap = header["metrics"]
        assert snap["record"] == "metrics"
        assert validate_metrics_doc(snap) == []
        assert any(c["name"] == "dstpu_sdc_mismatches_total"
                   and c["value"] == 3.0 for c in snap["counters"])

    def test_reader_rejects_corrupt_embedded_snapshot(self, registry,
                                                      tmp_path):
        from deepspeed_tpu_torch.telemetry import flight, read_flight_record

        registry.histogram("h", buckets=(1.0, 2.0)).observe(0.5)
        path = flight.dump_on_fault("unit_corrupt", dir=str(tmp_path))
        with open(path) as f:
            lines = f.read().splitlines()
        header = json.loads(lines[0])
        header["metrics"]["histograms"][0]["counts"] = [1]
        lines[0] = json.dumps(header)
        with open(path, "w") as f:
            f.write("\n".join(lines) + "\n")
        with pytest.raises(ValueError, match="metrics"):
            read_flight_record(path)

    def test_disabled_registry_omits_snapshot(self, registry, tmp_path):
        from deepspeed_tpu_torch.telemetry import flight, read_flight_record

        registry.configure(enabled=False)
        path = flight.dump_on_fault("unit_off", dir=str(tmp_path))
        header, _ = read_flight_record(path)
        assert "metrics" not in header


# ---------------------------------------------------------------------------
# torch.profiler bridge
# ---------------------------------------------------------------------------

def _write_trace(path, events):
    with open(path, "w") as f:
        json.dump({"traceEvents": events}, f)
    return str(path)


class TestProfiler:
    def test_real_cpu_trace_has_no_device_seconds(self, tmp_path):
        import torch
        from torch.profiler import ProfilerActivity, profile
        from deepspeed_tpu_torch.telemetry import profiler

        with profile(activities=[ProfilerActivity.CPU]) as prof:
            torch.ones(64, 64) @ torch.ones(64, 64)
        path = str(tmp_path / "cpu.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            names = {ev.get("name") for ev in json.load(f)["traceEvents"]}
        assert "aten::matmul" in names        # the trace is a real one
        assert profiler.device_seconds_by_kernel(path) == {}
        assert profiler.device_seconds_by_kernel(str(tmp_path)) == {}
        assert profiler.device_seconds_by_kernel(prof) == {}

    def test_kernel_events_summed_by_name(self, tmp_path):
        from deepspeed_tpu_torch.telemetry import profiler

        path = _write_trace(tmp_path / "t.json", [
            {"ph": "X", "cat": "kernel", "name": "rpa_mma<128>",
             "dur": 250.0, "ts": 0},
            {"ph": "X", "cat": "kernel", "name": "rpa_mma<128>",
             "dur": 750.0, "ts": 300},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD",
             "dur": 500.0, "ts": 900},
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm",
             "dur": 9000.0, "ts": 0},
            {"ph": "i", "cat": "kernel", "name": "marker", "ts": 5},
        ])
        k = profiler.device_seconds_by_kernel(path)
        assert k == pytest.approx({"rpa_mma<128>": 1e-3,
                                   "Memcpy HtoD": 5e-4})
        assert profiler.device_seconds_matching(k, "rpa_") == \
            pytest.approx(1e-3)
        assert profiler.split_host_device(2e-3, 1e-3) == \
            pytest.approx({"host_s": 2e-3, "device_s": 1e-3,
                           "host_other_s": 1e-3})
        assert profiler.split_host_device(2e-3, None)["host_other_s"] is None

    def test_newest_trace_in_a_directory(self, tmp_path):
        from deepspeed_tpu_torch.telemetry import profiler

        old = _write_trace(tmp_path / "a.json", [
            {"ph": "X", "cat": "kernel", "name": "old", "dur": 1.0}])
        os.utime(old, (1, 1))
        (tmp_path / "sub").mkdir()
        _write_trace(tmp_path / "sub" / "b.json", [
            {"ph": "X", "cat": "kernel", "name": "new", "dur": 1.0}])
        assert set(profiler.device_seconds_by_kernel(str(tmp_path))) == \
            {"new"}

    @pytest.mark.parametrize("content, err", [
        ("{not json", ValueError),
        ('{"events": []}', ValueError),
        ('{"traceEvents": [3]}', ValueError),
        ('{"traceEvents": [{"ph": "X", "cat": "kernel", "name": "k"}]}',
         KeyError),
    ], ids=["not-json", "no-events", "event-not-object", "kernel-no-dur"])
    def test_malformed_trace_raises(self, tmp_path, content, err):
        from deepspeed_tpu_torch.telemetry import profiler

        path = tmp_path / "bad.json"
        path.write_text(content)
        with pytest.raises(err):
            profiler.device_seconds_by_kernel(str(path))

    def test_missing_trace_raises(self, tmp_path):
        from deepspeed_tpu_torch.telemetry import profiler

        with pytest.raises(FileNotFoundError):
            profiler.device_seconds_by_kernel(str(tmp_path))
        with pytest.raises(FileNotFoundError):
            profiler.device_seconds_by_kernel(str(tmp_path / "none.json"))


# ---------------------------------------------------------------------------
# The port's v2 engine with telemetry armed, against the JAX engine
# ---------------------------------------------------------------------------

import torch_tier_helpers as tiers  # noqa: E402
from deepspeed_tpu.telemetry import tracer as jax_tracer_mod  # noqa: E402


@pytest.fixture(scope="module")
def tiny():
    return tiers.weights()


@pytest.fixture
def armed_tracer():
    """Singleton tracer armed for tail sampling, fully restored after."""
    tr = tracer_mod.trace
    prev = (tr.enabled, tr.sampling, tr.sample_n)
    tr.clear()
    tr.configure(enabled=True, sampling=True, sample_n=0)
    yield tr
    tr.configure(enabled=prev[0], sampling=prev[1], sample_n=prev[2])
    tr.clear()


@pytest.fixture
def both_tracers():
    """Both packages' tracer singletons on (no sampling), restored after."""
    trs = (tracer_mod.trace, jax_tracer_mod.trace)
    prev = [(t.enabled, t.sampling, t.buffer_size) for t in trs]
    for t in trs:
        t.clear()
        t.configure(enabled=True, sampling=False, buffer_size=1 << 16)
    yield trs
    for t, (en, sa, bs) in zip(trs, prev):
        t.configure(enabled=en, sampling=sa, buffer_size=bs)
        t.clear()


def _lifecycle(events):
    """The request-lifecycle events in record order, as comparable tuples
    (the ``cat="request"`` marks; decode blocks by their uids)."""
    out = []
    for ev in events:
        if ev.get("cat") != "request" or ev.get("ph") != "i":
            continue
        a = ev["args"]
        key = a.get("uid", tuple(a.get("uids", ())))
        out.append((ev["name"], key, a.get("spilled"), a.get("pages"),
                    a.get("take"), a.get("tokens")))
    return out


@pytest.mark.faults
def test_slo_breach_promotes_full_timeline(registry, armed_tracer, tiny):
    """The reference's engine-integration case on the port's engine:
    every request breaches a sub-microsecond TTFT objective, so every
    reap promotes its submit -> reap lifecycle with the breach reason,
    and the SLO window, the sampler and the registry report it."""
    eng = tiers.port_engine(tiny, max_seqs=2, max_seq_len=64,
                            prefill_chunk=8, slo=["ttft_ms_p99 <= 0.0001"],
                            trace_sample=0)
    eng.generate_all(tiers.prompts((5, 9)), max_new_tokens=6)
    by_name = {}
    for ev in armed_tracer.retained_snapshot():
        by_name.setdefault(ev["name"], []).append(ev)
    markers = by_name.get("promoted", [])
    assert len(markers) == 2
    assert all(m["args"]["reason"] == "slo_breach:ttft_ms_p99"
               for m in markers)
    submit_uids = {ev["args"]["uid"]
                   for ev in by_name.get("request_submit", [])}
    reap_uids = {ev["args"]["uid"] for ev in by_name.get("request_reap", [])}
    assert submit_uids == reap_uids == {m["args"]["uid"] for m in markers}
    st = eng.serving_stages()
    assert st["slo"]["ttft_ms_p99_breaches"] == 2
    assert st["slo"]["ttft_ms_p99_ok"] == 0
    assert st["trace_sampling"]["promoted_breach"] == 2
    assert st["trace_sampling"]["dropped"] == 0
    assert registry.get("dstpu_request_ttft_ms").labels(
        replica="").merged()[2] == 2
    # every host-path bracket fed the stage histogram and a span
    assert registry.get("dstpu_serving_stage_seconds").labels(
        stage="dispatch", replica="").merged()[2] == \
        eng.host_stats.dispatches


def test_slo_and_trace_sample_from_the_config(tiny, armed_tracer):
    eng = tiers.port_engine(tiny, config={"v2": {
        "slo": ["ttft_ms_p99 <= 150"], "trace_sample": 0}})
    assert isinstance(eng.slo, SLOSet)
    assert eng._tail_sampler is not None


@pytest.mark.parametrize("pipeline", [False, True])
def test_lifecycle_events_match_jax_engine(tiny, both_tracers, pipeline):
    """The same traffic through both engines with their tracers on: the
    request-lifecycle events (submit, admit, prefill chunks, decode
    blocks, spills, restores, reaps) come in the same order with the same
    uids and counts, and the latency records agree on every count."""
    ps = tiers.prompts((40, 40, 40, 40, 17))
    port_tr, jax_tr = both_tracers
    kw = dict(kv_tiering={"host_pages": 64}, pipeline=pipeline)
    je = tiers.jax_engine(tiny, **kw)
    pe = tiers.port_engine(tiny, **kw)
    want = tiers.serve(je, ps, audit=False, max_new_tokens=24)
    got = tiers.serve(pe, ps, max_new_tokens=24)
    tiers.assert_same(got, want)
    jl, pl = _lifecycle(jax_tr.snapshot()), _lifecycle(port_tr.snapshot())
    names = {n for n, *_ in jl}
    assert {"request_spill", "request_restore", "decode_block",
            "prefill_chunk"} <= names
    assert pl == jl
    counts = ("uid", "tokens", "spills", "errors", "handoffs")
    recs = [[{k: r[k] for k in counts} for r in e.request_latency.completed()]
            for e in (je, pe)]
    assert recs[1] == recs[0] and len(recs[0]) == len(ps)


# -- the engine timers feed the histogram and the tracer -----------------------

def test_timer_observes_each_recorded_interval(registry, global_trace):
    """``utils/timer.Timer`` observes ``dstpu_engine_seconds{timer=...}``
    once per recorded interval, as the JAX ``Timer`` does, and lands each
    as a ``cat="engine"`` span; an unrecorded interval is neither."""
    from deepspeed_tpu_torch.utils.timer import SynchronizedWallClockTimer

    global_trace.configure(enabled=True)
    timers = SynchronizedWallClockTimer()
    t = timers("step")
    t.use_cuda = False
    for _ in range(3):
        t.start()
        t.stop()
    t.start()
    t.stop(record=False)
    hist = registry.get("dstpu_engine_seconds").labels(timer="step")
    assert hist.count() == 3
    spans = [e for e in global_trace.snapshot()
             if e.get("cat") == "engine" and e.get("name") == "step"]
    assert len(spans) == 3
    assert t.mean() >= 0.0
    assert hist.count() == 3          # reading the timer observes nothing
