"""Disaggregated and elastic serving on the port against the reference.

Copies of the JAX package's fake-driven suites pointed at
``deepspeed_tpu_torch``: the role-split router and the handoff telemetry
of ``tests/unit/serving/test_disagg.py``, and the spill-format handoff,
``ReplicaSet`` grow/shrink and router grow/retire of
``tests/unit/serving/test_elastic_serving.py``.  Then the real thing: one
prefill and one decode replica of the port's v2 engine behind the port's
router, under the reference's mixed prompt-length workload, held token
for token to a fused port engine AND to the JAX package's own 1P1D
router on the same weights (fp32, greedy), with the handoff counters and
session blobs equal to the reference's; the degraded fold without
tiering, the wire bitflip that quarantines and re-prefills, and the
transient restore flip that heals by a re-read.
"""
import itertools
import types
from collections import OrderedDict

import numpy as np
import pytest

from deepspeed_tpu_torch.control.knobs import router_knobs
from deepspeed_tpu_torch.inference.kv_tiering import (KVRestoreError,
                                                      TieredKVStore)
from deepspeed_tpu_torch.inference.prefix_cache import ROOT_HASH, _chunk_hash
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving import Router, RouterRejection
from deepspeed_tpu_torch.serving.replica_set import ReplicaSet
from deepspeed_tpu_torch.telemetry.requests import RequestLatencyTracker
import torch_cpu  # noqa: F401  (one torch thread a process)



class FakeClock:
    def __init__(self, t=0.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += float(dt)


class FakeReplica:
    """Handle-protocol fake: synchronous ops, scripted finish latency,
    no handoff ops (the router must skip the handoff pump cleanly)."""

    def __init__(self, idx, max_seqs=3, page_size=4, latency=1,
                 die_at_step=None):
        self.idx = idx
        self.name = f"f{idx}"
        self.alive = True
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.in_flight = 0
        self.latency = latency
        self.die_at_step = die_at_step
        self._uid = itertools.count(1000 * idx)
        self.admitted = []            # [uid, steps_left, prompt]
        self.puts = []                # (uid, kw) in admit order
        self.steps = 0
        self.closed = False

    def validate(self, prompt, max_new):
        if np.asarray(prompt).size + int(max_new) > 64:
            raise ValueError("prompt + max_new_tokens > max_seq_len 64")

    def put_async(self, prompt, kw, accept_t, on_done):
        uid = next(self._uid)
        self.puts.append((uid, dict(kw)))
        self.admitted.append([uid, self.latency,
                              np.asarray(prompt, np.int32)])
        on_done(uid)

    def step_async(self, on_done):
        self.steps += 1
        if self.die_at_step is not None and self.steps >= self.die_at_step:
            raise RuntimeError(f"scripted death of {self.name}")
        outs, keep = [], []
        for ent in self.admitted:
            ent[1] -= 1
            if ent[1] <= 0:
                outs.append((ent[0], np.concatenate(
                    [ent[2], np.array([7, 8, 9], np.int32)])))
            else:
                keep.append(ent)
        self.admitted = keep
        on_done((outs, {"pressure": float(len(self.admitted))}))

    def join_all(self):
        pass

    def close(self):
        self.alive = False
        self.closed = True


def _router(n=2, **kw):
    rkw = kw.pop("replica_kw", {})
    reps = [FakeReplica(i, **rkw) for i in range(n)]
    return Router(reps, policy="least_tokens", clock=FakeClock(),
                  **kw), reps


class TestRoleSplitRouter:

    def test_set_roles_validates(self):
        router, _ = _router(2)
        with pytest.raises(ValueError, match="unknown replicas"):
            router.set_roles({"nope": "prefill", "f1": "decode"})
        with pytest.raises(ValueError, match="unknown roles"):
            router.set_roles({"f0": "chef", "f1": "decode"})
        with pytest.raises(ValueError, match="at least one prefill"):
            router.set_roles({"f0": "prefill", "f1": "prefill"})
        router.set_roles({"f0": "prefill", "f1": "decode"})
        assert router.prefill_fraction == 0.5
        router.set_roles({})          # revert to fused
        assert not router._roles

    def test_classification_routes_by_role(self):
        router, (f0, f1) = _router(2, replica_kw={"latency": 3})
        router.set_roles({"f0": "prefill", "f1": "decode"})
        # handoff_min_prompt seeds to the page size (4): >= 4 is a
        # long prefill, shorter is chat traffic
        long_rid = router.submit(np.arange(1, 9, dtype=np.int32),
                                 max_new_tokens=8)
        short_rid = router.submit(np.array([1, 2], np.int32),
                                  max_new_tokens=8)
        router.pump()
        assert long_rid in router._assigned["f0"]
        assert short_rid in router._assigned["f1"]
        # the long request is marked for the prefill->decode handoff
        assert f0.puts[-1][1].get("handoff") is True
        assert not f1.puts[-1][1].get("handoff")

    def test_single_token_prefill_never_marked_for_handoff(self):
        router, (f0, _) = _router(2)
        router.set_roles({"f0": "prefill", "f1": "decode"})
        router.submit(np.arange(1, 9, dtype=np.int32), max_new_tokens=1)
        router.pump()
        # max_new == 1 finishes at its prefill replica: no handoff mark
        assert f0.puts and not f0.puts[-1][1].get("handoff")

    def test_full_role_does_not_block_other_role(self):
        router, (f0, f1, f2) = _router(3, queue_cap=1)
        router.set_roles({"f0": "prefill", "f1": "decode",
                          "f2": "decode"})
        r1 = router.submit(np.arange(1, 9, dtype=np.int32),
                           max_new_tokens=4)
        r2 = router.submit(np.arange(1, 9, dtype=np.int32),
                           max_new_tokens=4)
        r3 = router.submit(np.array([1], np.int32), max_new_tokens=4)
        router._dispatch_queued()
        # the prefill side is at cap with r1; r2 parks aside, but the
        # decode request behind it in the heap still dispatches
        assert r1 in router._assigned["f0"]
        assert r2 not in router._assigned["f0"]
        assert (r3 in router._assigned["f1"]
                or r3 in router._assigned["f2"])
        assert router.queued == 1     # r2 went back to the heap
        router.drain()
        assert sorted(router.stats_counters.items())  # no KeyErrors
        router.close()

    def test_prefill_fraction_rederives_roles(self):
        router, _ = _router(4)
        router.set_roles({"f0": "prefill", "f1": "prefill",
                          "f2": "decode", "f3": "decode"})
        router.set_prefill_fraction(0.25)
        roles = dict(router._roles)
        assert sum(1 for v in roles.values() if v == "prefill") == 1
        # an existing prefill replica keeps the role (warm prefix cache)
        assert roles["f0"] == "prefill"
        # clamp: each side always keeps >= 1 replica
        router.set_prefill_fraction(1.0)
        assert sum(1 for v in router._roles.values()
                   if v == "decode") == 1

    def test_fraction_noop_in_fused_mode(self):
        router, _ = _router(2)
        router.set_prefill_fraction(0.9)
        assert router.prefill_fraction == 0.9
        assert not router._roles      # the knob never CREATES a split

    def test_losing_a_side_falls_back_to_fused(self):
        router, (f0, f1) = _router(2, replica_kw={"latency": 3})
        router.set_roles({"f0": "prefill", "f1": "decode"})
        rid = router.submit(np.arange(1, 9, dtype=np.int32),
                            max_new_tokens=4)
        router.pump()
        # the decode side dies (direct trip: the fake holds no work, so
        # a scripted step-death would never fire)
        router._on_replica_death(f1, RuntimeError("scripted death"))
        assert not router._roles, "one-sided split must revert to fused"
        assert router._live[rid].phase is None
        outs = router.drain()         # the request still finishes
        assert rid in outs
        router.close()

    def test_retire_last_decode_falls_back_to_fused(self):
        router, _ = _router(3)
        router.set_roles({"f0": "prefill", "f1": "prefill",
                          "f2": "decode"})
        router.retire_replica("f2")
        assert not router._roles
        router.close()

    def test_knobs_registered_and_clamped(self):
        router, _ = _router(2)
        reg = router_knobs(router)
        assert "router.prefill_fraction" in reg
        assert "router.handoff_depth" in reg
        router.set_roles({"f0": "prefill", "f1": "decode"})
        reg.set("router.prefill_fraction", 7.0)     # clamps to 0.9
        assert router.prefill_fraction == 0.9
        reg.set("router.handoff_depth", 99)
        assert router.handoff_depth == 8


class TestHandoffTelemetry:

    def test_phase_label_splits_series(self):
        clk = FakeClock()
        t = RequestLatencyTracker(clock=clk, registry=None,
                                  replica="r0")
        t.set_phase("prefill")
        assert t.phase == "prefill"

    def test_stall_series_only_holds_receiver_records(self):
        clk = FakeClock()
        t = RequestLatencyTracker(clock=clk, registry=None)
        t.on_submit(1)
        clk.advance(0.5)
        t.on_handoff_stall(1, 0.25)
        t.on_finish(1)
        t.on_submit(2)                # never handed off
        t.on_finish(2)
        s = t.summary()
        assert s["handoff_stall_ms_p50"] == pytest.approx(250.0)
        stalls = [r["handoff_stall_ms"] for r in t.completed()]
        assert stalls.count(None) == 1   # the non-handoff record

    def test_handoff_out_closes_donor_record(self):
        clk = FakeClock()
        t = RequestLatencyTracker(clock=clk, registry=None)
        t.on_submit(3)
        clk.advance(0.1)
        t.on_admit(3)
        clk.advance(0.1)
        t.on_tokens(3, 1)
        rec = t.on_handoff_out(3)
        assert rec is not None and rec["ttft_ms"] == pytest.approx(200.0)
        assert t.handed_off == 1
        assert 3 not in t._live       # closed, not leaked


# -- spill-format handoff at the store level -----------------------------
# (the port's store spills and restores one packed buffer: ``pack`` and
# ``unpack`` stand where the reference passes per-leaf arrays)

PAGE_SHAPES = [(8, 4, 6), (8, 4)]
PAGE_DTYPES = [np.float32, np.float32]


def _store(**kw):
    kw.setdefault("page_shapes", PAGE_SHAPES)
    kw.setdefault("page_dtypes", PAGE_DTYPES)
    kw.setdefault("pages_per_seq", 4)
    kw.setdefault("host_pages", 8)
    return TieredKVStore(**kw)


def _pages(n, seed=0):
    return [np.random.default_rng(seed).random((n,) + s).astype(d)
            for s, d in zip(PAGE_SHAPES, PAGE_DTYPES)]


class TestSpillFormatHandoff:

    def test_export_import_roundtrip_bit_exact(self):
        a, b = _store(), _store()
        arrs = _pages(3, seed=1)
        a.spill(5, a.pack(arrs, 3), 3)
        blob = a.export_spilled(5)
        assert not a.holds(5), "export transfers ownership out"
        assert a.counters["exports"] == 1
        b.import_spilled(7, blob)          # receiver re-keys the uid
        back = b.unpack(b.restore(7), 3)
        for x, y in zip(arrs, back):
            np.testing.assert_array_equal(x, y)
        s = b.stats()
        # donor digests travelled: restore VERIFIED against them
        assert s["pages_verified"] == s["pages_restored"] == 3
        assert b.counters["imports"] == 1
        a.close()
        b.close()

    def test_corruption_in_transit_caught_by_donor_digests(self):
        a, b = _store(), _store()
        a.spill(1, a.pack(_pages(3, seed=2), 3), 3)
        blob = a.export_spilled(1)
        raw = bytearray(blob["payload"])
        raw[100] ^= 0xFF                   # one flipped bit in transit
        blob["payload"] = bytes(raw)
        b.import_spilled(9, blob)
        with pytest.raises(KVRestoreError):
            b.restore(9)
        assert b.counters["quarantined"] == 1
        assert not b.holds(9)              # session re-prefills loudly
        a.close()
        b.close()

    def test_import_rejects_layout_mismatch(self):
        a = _store()
        # leaf widths past one 4096B alignment unit: stride 8192 != 4096
        b = _store(page_shapes=[(64, 4, 6), (64, 4)])
        a.spill(1, a.pack(_pages(2, seed=3), 2), 2)
        blob = a.export_spilled(1)
        with pytest.raises(ValueError, match="page_stride"):
            b.import_spilled(1, blob)
        a.close()
        b.close()

    def test_import_rejects_when_tiers_full(self):
        a, b = _store(), _store(host_pages=1, nvme_pages=0)
        a.spill(1, a.pack(_pages(3, seed=4), 3), 3)
        blob = a.export_spilled(1)
        with pytest.raises(RuntimeError, match="kv tiers full"):
            b.import_spilled(1, blob)
        assert b.counters["spill_fallbacks"] == 1
        assert not b.holds(1)
        a.close()
        b.close()


# -- ReplicaSet grow / shrink --------------------------------------------

class _DummyEngine:
    max_seqs = 2
    page_size = 4

    def __init__(self):
        self.closed = False

    def set_replica(self, name):
        self.replica = name

    def close(self):
        self.closed = True


class TestReplicaSetElastic:

    def test_grow_uses_fresh_never_reused_names(self):
        rs = ReplicaSet(lambda i: _DummyEngine(), 2)
        try:
            (h2,) = rs.grow(1)
            assert h2.name == "r2" and len(rs) == 3
            rs.shrink("r2")
            (h3,) = rs.grow(1)                 # r2 is NOT resurrected
            assert h3.name == "r3"
            assert [h.name for h in rs] == ["r0", "r1", "r3"]
        finally:
            rs.close()

    def test_shrink_removes_and_closes(self):
        rs = ReplicaSet(lambda i: _DummyEngine(), 3)
        try:
            (dropped,) = rs.shrink("r1")
            assert not dropped.alive and dropped.engine.closed
            assert [h.name for h in rs] == ["r0", "r2"]
        finally:
            rs.close()

    def test_shrink_refuses_unknown_and_empty(self):
        rs = ReplicaSet(lambda i: _DummyEngine(), 2)
        try:
            with pytest.raises(ValueError, match="unknown replicas"):
                rs.shrink("nope")
            with pytest.raises(ValueError, match="empty replica set"):
                rs.shrink(["r0", "r1"])
            assert len(rs) == 2                # refusal changed nothing
        finally:
            rs.close()


# -- Router grow / retire against scripted fakes -------------------------

class FakeElasticReplica:
    """Handle-protocol fake with the elastic extensions: synchronous
    ops, scripted finish latency, parked-session export/import."""

    def __init__(self, idx, max_seqs=3, page_size=4, latency=1,
                 exportable=True):
        self.idx = idx
        self.name = f"f{idx}"
        self.alive = True
        self.max_seqs = max_seqs
        self.page_size = page_size
        self.in_flight = 0
        self.latency = latency
        self.exportable = exportable
        self._uid = itertools.count(1000 * idx)
        self.admitted = []            # [uid, steps_left, prompt]
        self.puts = []
        self.imported = []
        self.closed = False
        self.engine = types.SimpleNamespace()   # no prefix cache

    def validate(self, prompt, max_new):
        if np.asarray(prompt).size + int(max_new) > 64:
            raise ValueError("prompt + max_new_tokens > max_seq_len 64")

    def put_async(self, prompt, kw, accept_t, on_done=None):
        uid = next(self._uid)
        p = np.asarray(prompt, np.int32)
        self.puts.append((uid, p.tolist()))
        self.admitted.append([uid, self.latency, p])
        if on_done is not None:
            on_done(uid)

    def step_async(self, on_done):
        outs, keep = [], []
        for ent in self.admitted:
            ent[1] -= 1
            if ent[1] <= 0:
                outs.append((ent[0], np.concatenate(
                    [ent[2], np.array([7, 8, 9], np.int32)])))
            else:
                keep.append(ent)
        self.admitted = keep
        on_done((outs, {"pressure": float(len(self.admitted))}))

    def drain_async(self, on_done=None):
        outs = [(e[0], np.concatenate([e[2],
                                       np.array([7, 8, 9], np.int32)]))
                for e in self.admitted]
        self.admitted = []
        if on_done is not None:
            on_done((outs, {"pressure": 0.0}))

    def export_parked_async(self, on_done):
        sessions = []
        if self.exportable:
            sessions = [{"uid": e[0], "prompt": e[2]}
                        for e in self.admitted]
            self.admitted = []
        on_done(sessions)

    def import_parked_async(self, sessions, on_done):
        uids = []
        for s in sessions:
            uid = next(self._uid)
            self.admitted.append([uid, self.latency,
                                  np.asarray(s["prompt"], np.int32)])
            self.imported.append(uid)
            uids.append(uid)
        on_done(uids)

    def join_all(self):
        pass

    def close(self):
        self.alive = False
        self.closed = True


def _prompt(n, base=1):
    return np.arange(base, base + n, dtype=np.int32)


class TestRouterElastic:

    def test_add_replica_joins_rotation(self):
        fakes = [FakeElasticReplica(0)]
        router = Router(fakes, policy="rr", sticky=False)
        router.add_replica(FakeElasticReplica(1))
        rids = [router.submit(_prompt(3, base=10 * i), max_new_tokens=4)
                for i in range(4)]
        outs = router.drain()
        assert set(outs) == set(rids)
        s = router.stats()
        assert s["replicas_added"] == 1
        assert s["routed_f0"] == 2 and s["routed_f1"] == 2, s

    def test_add_replica_rejects_duplicate_name(self):
        router = Router([FakeElasticReplica(0)], sticky=False)
        with pytest.raises(ValueError, match="already routed"):
            router.add_replica(FakeElasticReplica(0))

    def test_add_replica_warms_donor_prefix_chains(self):
        donor = FakeElasticReplica(0)
        k1 = _chunk_hash(ROOT_HASH, (1, 2, 3, 4))
        k2 = _chunk_hash(k1, (5, 6, 7, 8))
        k3 = _chunk_hash(ROOT_HASH, (9, 9, 9, 9))
        donor.engine = types.SimpleNamespace(_pfx=types.SimpleNamespace(
            _entries=OrderedDict([
                (k1, types.SimpleNamespace(parent=ROOT_HASH,
                                           tokens=(1, 2, 3, 4))),
                (k2, types.SimpleNamespace(parent=k1,
                                           tokens=(5, 6, 7, 8))),
                (k3, types.SimpleNamespace(parent=ROOT_HASH,
                                           tokens=(9, 9, 9, 9))),
            ])))
        router = Router([donor], sticky=True)
        newbie = FakeElasticReplica(1)
        router.add_replica(newbie, warm_from=donor, warm_limit=1)
        # only the LONGEST chain replays under warm_limit=1, and it is
        # the full leaf-to-root token sequence
        assert [p[1] for p in newbie.puts] == [[1, 2, 3, 4, 5, 6, 7, 8]]

    def test_retire_hands_off_parked_sessions(self):
        fakes = [FakeElasticReplica(0, latency=5),
                 FakeElasticReplica(1, latency=5)]
        router = Router(fakes, policy="rr", sticky=False)
        rids = [router.submit(_prompt(3, base=10 * i), max_new_tokens=4)
                for i in range(6)]
        router.pump()                          # 3 admitted on each
        summary = router.retire_replica("f0")
        assert summary["handed_off"] == 3
        assert fakes[0].closed
        assert [h.name for h in router.handles] == ["f1"]
        assert len(fakes[1].imported) == 3
        s = router.stats()
        assert s["replicas_retired"] == 1
        assert s["sessions_handed_off"] == 3
        # conservation: every accepted request still finishes, with the
        # handed-off uids re-keyed to the survivor
        outs = router.drain()
        assert set(outs) == set(rids)

    def test_retire_finishes_in_flight_before_close(self):
        # a replica whose engine cannot export (pre-elastic protocol):
        # retire degrades to drain-in-place, still conserving requests
        fakes = [FakeElasticReplica(0, latency=3, exportable=False),
                 FakeElasticReplica(1, latency=1)]
        router = Router(fakes, policy="rr", sticky=False)
        rids = [router.submit(_prompt(3, base=10 * i), max_new_tokens=4)
                for i in range(4)]
        router.pump()
        summary = router.retire_replica("f0")
        assert summary["handed_off"] == 0
        assert fakes[0].closed and not fakes[0].admitted
        outs = router.drain()
        assert set(outs) == set(rids)
        assert router.stats()["sessions_handed_off"] == 0

    def test_retire_migrates_affinity_pins(self):
        fakes = [FakeElasticReplica(0, latency=1),
                 FakeElasticReplica(1, latency=1)]
        router = Router(fakes, policy="rr", sticky=True)
        shared = np.array([3, 1, 4, 1, 5, 9, 2, 6], np.int32)
        router.submit(np.concatenate([shared, [11]]), max_new_tokens=4)
        router.drain()
        pinned = next(iter(router._affinity.values()))
        summary = router.retire_replica(pinned)
        assert summary["moved_pins"] == 1
        survivor = router.handles[0].name
        assert set(router._affinity.values()) == {survivor}
        # sticky traffic now lands on the survivor as an affinity hit
        router.submit(np.concatenate([shared, [22]]), max_new_tokens=4)
        router.drain()
        assert router.stats()["affinity_hits"] == 1

    def test_retire_refuses_last_replica(self):
        router = Router([FakeElasticReplica(0)], sticky=False)
        with pytest.raises(RouterRejection, match="no surviving"):
            router.retire_replica("f0")
        with pytest.raises(ValueError, match="unknown replica"):
            router.retire_replica("ghost")

    def test_retire_honours_named_target(self):
        fakes = [FakeElasticReplica(i, latency=5) for i in range(3)]
        router = Router(fakes, policy="rr", sticky=False)
        for i in range(3):
            router.submit(_prompt(3, base=10 * i), max_new_tokens=4)
        router.pump()
        summary = router.retire_replica("f0", target="f2")
        assert summary["target"] == "f2"
        assert len(fakes[2].imported) == summary["handed_off"] == 1
        assert not fakes[1].imported
        router.drain()


# -- integration against REAL engines ------------------------------------


# -- 1 prefill + 1 decode replica of the real engines ----------------------

import torch_tier_helpers as tiers  # noqa: E402
from deepspeed_tpu import serving as jax_serving  # noqa: E402
from deepspeed_tpu.resilience import faults as jax_faults  # noqa: E402

# the reference test's mixed workload: half long prefills (>= one page,
# so they classify as handoff traffic), half short chat turns
MIX_SIZES = (24, 5, 40, 7, 33, 6, 20, 9)
TIERED = {"host_pages": 64}


@pytest.fixture(scope="module")
def tiny():
    return tiers.weights()


def _fused(w, prompts, max_new, **ekw):
    eng = tiers.port_engine(w, pipeline=True, **ekw)
    order = {eng.put_request(p, max_new_tokens=max_new): i
             for i, p in enumerate(prompts)}
    outs = {order[u]: t for u, t in tiers.serve(eng, []).items()}
    eng.close()
    return outs


def _record_blobs(eng, blobs):
    """Wrap ``eng.export_handoff`` to keep each blob's handoff fields."""
    export = eng.export_handoff

    def recording():
        out = export()
        for b in out:
            sp = b["spill"]
            blobs.append((b["uid"], list(b["generated"]),
                          int(b["prefill_done"]),
                          None if sp is None else int(sp["live_tokens"])))
        return out

    eng.export_handoff = recording


def _disagg(pkg, make, prompts, max_new):
    """1 prefill + 1 decode replica behind ``pkg``'s router; returns
    (outputs by prompt index, router stats, prefill engine, decode
    engine, the handed-off blobs' fields, the replica set)."""
    rs = pkg.ReplicaSet(make, 2)
    blobs = []
    _record_blobs(rs.handles[0].engine, blobs)
    router = pkg.Router(rs, policy="least_tokens")
    router.set_roles({"r0": "prefill", "r1": "decode"})
    rids = {router.submit(p, max_new_tokens=max_new): i
            for i, p in enumerate(prompts)}
    outs = {rids[r]: t for r, t in router.drain().items()}
    e0, e1 = rs.handles[0].engine, rs.handles[1].engine
    return outs, router.stats(), e0, e1, sorted(blobs), rs


def _jax_disagg(w, prompts, max_new, **ekw):
    outs, stats, e0, e1, blobs, rs = _disagg(
        jax_serving, lambda i: tiers.jax_engine(w, pipeline=True, **ekw),
        prompts, max_new)
    tier = None if e1.tiering is None else dict(e1.tiering.counters)
    res = dict(outs=outs, stats=stats, blobs=blobs, tier=tier,
               handoffs=e0.handoffs, folds=e0.handoff_folds)
    rs.close()
    return res


_PORT = types.SimpleNamespace(ReplicaSet=ReplicaSet, Router=Router)


def _port_disagg(w, prompts, max_new, **ekw):
    return _disagg(_PORT, lambda i: tiers.port_engine(
        w, pipeline=True, **ekw), prompts, max_new)


@pytest.fixture(scope="module")
def jax_clean(tiny):
    return _jax_disagg(tiny, tiers.prompts(MIX_SIZES), 12,
                       kv_tiering=TIERED)


@pytest.fixture(scope="module")
def jax_folded(tiny):
    return _jax_disagg(tiny, tiers.prompts(MIX_SIZES[:4]), 10)


def _assert_outputs(outs, *refs):
    for ref in refs:
        assert sorted(outs) == sorted(ref)
        for i in ref:
            np.testing.assert_array_equal(outs[i], ref[i],
                                          err_msg=f"prompt {i}")


def _handoff_stats(stats):
    return {k: stats[k] for k in ("handoffs", "handoff_kv",
                                  "handoff_reprefill", "finished",
                                  "routed_r0", "routed_r1")}


class TestDisaggParity:

    def test_1p1d_matches_fused_and_jax_router(self, tiny, jax_clean):
        """Greedy tokens of the port's 1P1D router equal a
        fused port engine's and the JAX 1P1D router's; every long request
        handed off its KV, each payload restored verified against the
        donor's digests; the counters and blobs are the reference's."""
        prompts = tiers.prompts(MIX_SIZES)
        ref = _fused(tiny, prompts, 12, kv_tiering=TIERED)
        outs, stats, e0, e1, blobs, rs = _port_disagg(
            tiny, prompts, 12, kv_tiering=TIERED)
        try:
            _assert_outputs(outs, ref, jax_clean["outs"])
            n_long = sum(1 for p in prompts if p.size >= 16)
            assert stats["handoffs"] == stats["handoff_kv"] == n_long
            assert stats["handoff_reprefill"] == 0
            assert _handoff_stats(stats) == _handoff_stats(
                jax_clean["stats"])
            assert (e0.handoffs, e0.handoff_folds) == (
                jax_clean["handoffs"], jax_clean["folds"]) == (n_long, 0)
            assert len(blobs) == n_long and blobs == jax_clean["blobs"]
            st = e1.tiering.stats()
            assert e1.tiering.counters["imports"] == n_long
            assert st["pages_verified"] == st["pages_restored"] > 0
            assert st["quarantined"] == 0
            for k in ("imports", "restores", "pages_restored",
                      "pages_verified", "quarantined"):
                assert e1.tiering.counters[k] == jax_clean["tier"][k], k
            for e in (e0, e1):
                e.audit_kv_sharing()
                assert e.allocator.free_pages == e.num_pages - 1
                assert e.serving_stages()["pool"]["pages_in_use"] == 0
            assert e0.serving_stages()["handoff"] == {
                "exported": n_long, "folds": 0, "pending": 0}
            assert e0.request_latency.handed_off == n_long
            stalls = [r["handoffs"] for r in e1.request_latency.completed()]
            assert sum(1 for n in stalls if n > 0) == n_long
            assert e1.request_latency.summary()[
                "handoff_stall_ms_p50"] is not None
        finally:
            rs.close()

    def test_degraded_fold_without_tiering(self, tiny, jax_folded):
        """Without tiers the finished prefill cannot travel as pages: it
        folds to a re-prefill continuation, tokens unchanged, as the
        reference does."""
        prompts = tiers.prompts(MIX_SIZES[:4])
        ref = _fused(tiny, prompts, 10)
        outs, stats, e0, e1, blobs, rs = _port_disagg(tiny, prompts, 10)
        try:
            _assert_outputs(outs, ref, jax_folded["outs"])
            assert stats["handoffs"] > 0
            assert stats["handoff_reprefill"] == stats["handoffs"]
            assert stats["handoff_kv"] == 0
            assert e0.handoff_folds == stats["handoffs"]
            assert _handoff_stats(stats) == _handoff_stats(
                jax_folded["stats"])
            assert blobs == jax_folded["blobs"]
            e0.audit_kv_sharing()
            e1.audit_kv_sharing()
        finally:
            rs.close()


@pytest.mark.faults
class TestHandoffCorruption:

    def test_wire_bitflip_quarantines_and_reprefills(self, tiny, jax_clean):
        """A flip on the handoff wire (the ``handoff.import`` site) is
        caught by the donor's digests at restore: re-reads return the same
        bytes, the payload quarantines, the session re-prefills on the
        decode replica and the tokens stay the JAX router's, as the
        reference's own corrupted run shows."""
        prompts = tiers.prompts(MIX_SIZES)
        with faults.FaultInjector(seed=9) as inj:
            inj.bitflip("handoff.import", bits=1, count=100)
            outs, stats, e0, e1, blobs, rs = _port_disagg(
                tiny, prompts, 12, kv_tiering=TIERED)
        with jax_faults.FaultInjector(seed=9) as jinj:
            jinj.bitflip("handoff.import", bits=1, count=100)
            ref = _jax_disagg(tiny, prompts, 12, kv_tiering=TIERED)
        try:
            n_long = sum(1 for p in prompts if p.size >= 16)
            fired = [s for s, _, _ in inj.fired if s == "handoff.import"]
            assert len(fired) == n_long
            _assert_outputs(outs, jax_clean["outs"], ref["outs"])
            c = e1.tiering.counters
            assert c["quarantined"] == ref["tier"]["quarantined"] == n_long
            assert c["reread_recovered"] == 0
            assert c["rereads"] == ref["tier"]["rereads"] > 0
            assert sum(r["errors"] for r in
                       e1.request_latency.completed()) == n_long
            e0.audit_kv_sharing()
            e1.audit_kv_sharing()
            assert e1.allocator.free_pages == e1.num_pages - 1
        finally:
            rs.close()

    def test_transient_restore_bitflip_heals_via_reread(self, tiny):
        """A one-shot flip on a tier read (``kv.read_page``) heals through
        the store's re-read: nothing quarantines, tokens unchanged."""
        prompts = tiers.prompts(MIX_SIZES[:4])
        ref = _fused(tiny, prompts, 12, kv_tiering=TIERED)
        with faults.FaultInjector(seed=11) as inj:
            inj.bitflip("kv.read_page", bits=1, count=1)
            outs, stats, e0, e1, blobs, rs = _port_disagg(
                tiny, prompts, 12, kv_tiering=TIERED)
        try:
            assert inj.fired, "the flip never fired"
            _assert_outputs(outs, ref)
            assert (e0.tiering.counters["quarantined"]
                    + e1.tiering.counters["quarantined"]) == 0
            assert (e0.tiering.counters["reread_recovered"]
                    + e1.tiering.counters["reread_recovered"]) == 1
        finally:
            rs.close()


def test_cancel_and_drain_release_pending_handoffs(tiny):
    """A session parked for a handoff the router never pulls: ``cancel``
    releases it at stage ``"handoff"`` with its payload, and ``drain``
    finishes the others here as the fused engine would."""
    prompts = tiers.prompts((24, 40, 33))
    ref = _fused(tiny, prompts, 8, kv_tiering=TIERED)
    eng = tiers.port_engine(tiny, pipeline=True, kv_tiering=TIERED)
    uids = [eng.put_request(p, max_new_tokens=8, handoff=True)
            for p in prompts]
    while len(eng._handoff_ready) < 3:
        eng.step()
    assert not eng.has_work() and eng.serving_stages()["handoff"][
        "pending"] == 3
    assert eng.cancel(uids[1]) == "handoff"
    assert not eng.tiering.holds(uids[1])
    outs = eng.drain()
    assert sorted(outs) == [uids[0], uids[2]]
    for i in (0, 2):
        np.testing.assert_array_equal(outs[uids[i]], ref[i])
    eng.audit_kv_sharing()
    assert eng.allocator.free_pages == eng.num_pages - 1
    assert eng.tiering.stats()["resident_spilled_sessions"] == 0
    eng.close()
