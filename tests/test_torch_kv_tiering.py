"""The port's KV tiers (``inference/kv_tiering.py``, ``resilience/sdc.py``,
``io/``) against the JAX package's.

Pieces: ``sdc.digest``/``checksum`` equal the reference's bit for bit at
lengths 0, 7 and 4099 under every algorithm; the digest side pool's
deferred digests equal its inline ones; the tier store in the cases of
the reference's ``TestTieredStoreUnit`` (host round trip, demotion to an
NVMe directory through the port's own aio build and a prefetch, a restore
while the write-back is in flight, capacity rejection, a transient
bitflip healed by re-read, persistent corruption quarantined as
``.quarantine``) and the degraded-mode trip with its probe re-arm.

Engines: the tiny fp32 Llama of ``torch_tier_helpers`` (the reference
tests' model and pool, one flax tree through the bridge) under the same
traffic in both packages.  With tiering on, pipeline on and off, host
only and with an NVMe tier, the port's greedy tokens and its ``spills``,
``restores`` and ``evictions`` equal the JAX engine's, its tokens equal
its own tiering-off run's, every restored page reads back the spilled
bytes, and the pool and tier audits are clean after every step.  Also:
persistent corruption re-prefills to the same tokens; an int8 pool
spills and restores; the tier-aware submit checks and their messages;
``export_parked`` -> ``import_parked`` between two port engines with the
reference's blob keys; ``cancel`` of a spilled request.  The JAX
zero-new-compiles test has no counterpart: the port compiles nothing per
shape.
"""
import os

import numpy as np
import pytest

from deepspeed_tpu.resilience import sdc as jax_sdc
from deepspeed_tpu_torch.inference.kv_tiering import (KVRestoreError,
                                                      TieredKVStore)
from deepspeed_tpu_torch.resilience import faults, sdc
from torch_tier_helpers import (assert_same, check_restores, jax_engine,
                                port_engine, prompts, serve, weights)
import torch_cpu  # noqa: F401  (one torch thread a process)

SIZES = [12, 20, 9, 16]
NVME_SIZES = [12, 20, 9, 16, 14, 18]


@pytest.fixture(scope="module")
def w():
    return weights()


# -- sdc: digests equal the reference's ----------------------------------


@pytest.mark.parametrize("n", [0, 7, 4099])
@pytest.mark.parametrize("algo", sdc.CHECKSUM_ALGOS)
def test_digest_equals_reference(algo, n):
    buf = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    assert sdc.CHECKSUM_ALGOS == jax_sdc.CHECKSUM_ALGOS
    assert sdc.checksum(buf, algo) == jax_sdc.checksum(buf, algo)
    assert sdc.digest(buf, algo) == jax_sdc.digest(buf, algo)
    with pytest.raises(ValueError, match="unknown checksum"):
        sdc.checksum(buf, "md5")


def test_digest_pool_inline_deferred_parity():
    buf = np.random.default_rng(0).integers(0, 255, size=(1 << 16,),
                                            dtype=np.uint8)
    pool = sdc.DigestPool(defer_min=0)          # everything defers
    assert pool.note("k", buf) is None
    assert pool.pop("k") == sdc.digest(buf, "sum64")
    inline = sdc.DigestPool(defer_min=1 << 30)
    assert inline.note("k", buf) == sdc.digest(buf, "sum64")
    assert not inline.spun, "small digests must not start the pool"
    pool.close()
    inline.close()


# -- the store, no engine ------------------------------------------------

PAGE_SHAPES = [(8, 4, 6), (8, 4)]           # e.g. pages + scales
PAGE_DTYPES = [np.float32, np.float32]


def _store(tmp_path=None, **kw):
    kw.setdefault("page_shapes", PAGE_SHAPES)
    kw.setdefault("page_dtypes", PAGE_DTYPES)
    kw.setdefault("pages_per_seq", 4)
    kw.setdefault("host_pages", 4)
    if tmp_path is not None:
        kw.setdefault("nvme_pages", 8)
        kw.setdefault("nvme_dir", str(tmp_path))
    return TieredKVStore(**kw)


def _pages(n, seed=0):
    r = np.random.default_rng(seed)
    return [r.random((n,) + s).astype(d)
            for s, d in zip(PAGE_SHAPES, PAGE_DTYPES)]


def _spill(st, uid, arrs):
    n = arrs[0].shape[0]
    st.spill(uid, st.pack(arrs, n), n)


def _restored(st, uid, want):
    n = want[0].shape[0]
    for a, b in zip(want, st.unpack(st.restore(uid), n)):
        np.testing.assert_array_equal(a, b)


def test_store_host_round_trip():
    st = _store()
    arrs = _pages(3, seed=1)
    _spill(st, 7, arrs)
    assert st.holds(7) and st.page_stride % 4096 == 0
    assert st.spill_digests(7) == [
        sdc.digest(b, "sum64")
        for b in st.pack(arrs, 3).reshape(3, st.page_stride)]
    _restored(st, 7, arrs)
    assert not st.holds(7)
    s = st.stats()
    assert s["pages_verified"] == s["pages_restored"] == 3
    assert st.audit()["sessions"] == 0
    st.close()


def test_store_demotion_prefetch_and_nvme_round_trip(tmp_path):
    st = _store(tmp_path, host_pages=3)
    a, b = _pages(3, seed=2), _pages(2, seed=3)
    _spill(st, 1, a)
    _spill(st, 2, b)                         # demotes uid 1 to NVMe
    assert st.counters["demotions"] == st.counters["nvme_spills"] == 1
    st._writes.drain()                       # the write-back lands
    assert st._entries[1].state == "nvme"
    assert st.aio_backend in ("uring", "threadpool")
    assert st.prefetch([1]) == 1             # async NVMe -> staging
    _restored(st, 1, a)
    assert st.counters["prefetch_hits"] == 1
    _restored(st, 2, b)
    assert st.audit()["sessions"] == 0
    st.close()


def test_store_restore_while_write_in_flight(tmp_path):
    """A restore before the write-back joins reads the in-memory bytes,
    not the half-written file."""
    st = _store(tmp_path, host_pages=2)
    arrs = _pages(4, seed=4)                 # 4 > host_pages: straight NVMe
    _spill(st, 9, arrs)
    assert st._entries[9].state == "writing"
    _restored(st, 9, arrs)
    st.close()


def test_store_capacity_rejection_counts_fallback():
    st = _store(host_pages=2)
    _spill(st, 1, _pages(2, seed=5))
    with pytest.raises(RuntimeError, match="kv tiers full"):
        _spill(st, 2, _pages(2, seed=6))
    assert st.counters["spill_fallbacks"] == 1
    assert not st.can_spill(1)
    st.close()


def test_store_transient_bitflip_heals_by_reread():
    st = _store()
    arrs = _pages(2, seed=7)
    _spill(st, 3, arrs)
    with faults.FaultInjector(seed=5) as inj:
        inj.bitflip("kv.read_page", bits=1, count=1)
        _restored(st, 3, arrs)
    assert st.counters["reread_recovered"] == 1
    assert st.counters["quarantined"] == 0
    st.close()


def test_store_persistent_corruption_quarantines(tmp_path):
    st = _store(tmp_path, host_pages=1, max_reread=2)
    _spill(st, 4, _pages(2, seed=8))         # oversized for host: NVMe
    st._writes.drain()
    path = st._entries[4].path
    with faults.FaultInjector(seed=6) as inj:
        inj.bitflip("kv.read_page", bits=1, count=10)
        with pytest.raises(KVRestoreError):
            st.restore(4)
    assert st.counters["quarantined"] == 1
    assert not st.holds(4)                   # dropped: the session re-prefills
    assert os.path.exists(path + ".quarantine")
    st.close()


def test_store_degraded_trip_and_probe_rearm(tmp_path):
    """Hard write errors trip the NVMe tier offline (parked NVMe payloads
    fold to a re-prefill), spills fall back to the host tier, and a clean
    probe re-arms it."""
    st = _store(tmp_path, host_pages=2, nvme_fail_threshold=2,
                probe_every=1)
    _spill(st, 1, _pages(2, seed=9))         # host
    _spill(st, 2, _pages(2, seed=10))        # demotes uid 1 to NVMe
    st._writes.drain()
    with faults.FaultInjector(seed=1) as inj:
        inj.io_error("kv.write", count=3)
        for uid in (3, 4):                   # oversized: straight to NVMe
            with pytest.raises(RuntimeError, match="NVMe write-back"):
                _spill(st, uid, _pages(3, seed=uid))
        assert st.nvme_offline and st.counters["tier_degraded"] == 1
        assert st.counters["degraded_folds"] == 1
        with pytest.raises(KVRestoreError, match="degraded mode"):
            st.restore(1)
        assert not st.can_spill(3)           # the probe fails: still down
        assert st.counters["probe_failures"] == 1
    assert st.can_spill(3)                   # a clean probe re-arms
    assert not st.nvme_offline and st.counters["tier_rearmed"] == 1
    assert st.audit()["nvme_pages_used"] == 0
    st.close()


# -- engines against the JAX package's -----------------------------------

TIERS = {"host": lambda tmp: ({"host_pages": 64}, SIZES),
         "nvme": lambda tmp: ({"host_pages": 2, "nvme_pages": 16,
                               "nvme_dir": str(tmp)}, NVME_SIZES)}


@pytest.mark.parametrize("tier", list(TIERS))
@pytest.mark.parametrize("pipeline", [False, True], ids=["unpiped", "piped"])
def test_tiering_matches_jax_engine(w, tmp_path, pipeline, tier):
    tiering, sizes = TIERS[tier](tmp_path)
    ref = jax_engine(w, pipeline=pipeline, kv_tiering=dict(
        tiering, nvme_dir=str(tmp_path / "jax")) if tier == "nvme"
        else tiering)
    want = serve(ref, prompts(sizes), audit=False)
    off = serve(port_engine(w, pipeline=pipeline), prompts(sizes))
    eng = port_engine(w, pipeline=pipeline, kv_tiering=tiering)
    checked = check_restores(eng)
    got = serve(eng, prompts(sizes))
    assert_same(got, want)
    assert_same(got, off)
    assert (eng.spills, eng.restores, eng.evictions) == (
        ref.spills, ref.restores, ref.evictions)
    assert eng.spills > 0 and eng.evictions == 0
    st = eng.serving_stages()["kv_tiering"]
    assert st["pages_verified"] == st["pages_restored"] == sum(checked) > 0
    if tier == "nvme":
        assert st["nvme_spills"] > 0 and st["nvme_offline"] == 0
        assert st["nvme_spills"] == ref.tiering.stats()["nvme_spills"]
    assert eng.tiering.audit()["sessions"] == 0
    assert eng.audit_kv_sharing()["referenced"] == 0
    eng.close()
    ref.close()


def test_persistent_corruption_reprefills_exactly(w):
    off = serve(port_engine(w), prompts(SIZES))
    eng = port_engine(w, kv_tiering={"host_pages": 64})
    with faults.FaultInjector(seed=6) as inj:
        inj.bitflip("kv.read_page", bits=1, count=3)
        on = serve(eng, prompts(SIZES))
    assert eng.tiering.stats()["quarantined"] >= 1, "the fault must fire"
    assert sum(r["errors"] for r in eng.request_latency.completed()) >= 1
    assert_same(off, on)                     # the re-prefill is exact
    eng.close()


def test_int8_pool_spills_and_restores(w):
    off = serve(port_engine(w, kv_cache_dtype="int8"), prompts(SIZES))
    eng = port_engine(w, kv_cache_dtype="int8",
                      kv_tiering={"host_pages": 64})
    checked = check_restores(eng)
    on = serve(eng, prompts(SIZES))
    assert eng.spills > 0 and sum(checked) > 0 and eng.evictions == 0
    # two leaves a layer: int8 pages, then their fp32 scales
    assert eng.tiering.widths == [16 * 4 * 8, 16 * 4 * 4] * 2
    assert_same(off, on)
    eng.close()


def test_submit_accepts_beyond_hbm_within_tiers(w):
    eng = port_engine(w, kv_tiering={"host_pages": 64}, num_pages=4)
    # 100 tokens = 7 pages > 3 usable device pages, within 3 + 64
    assert eng.put_request(np.ones(40, np.int32), max_new_tokens=60) >= 0
    eng.close()


@pytest.mark.parametrize("tiering,match", [
    (None, "raise num_pages$"),
    ({"host_pages": 2}, r"host \(2\) \+ NVMe \(0\)")])
def test_submit_rejection_names_the_tiers(w, tiering, match):
    eng = port_engine(w, kv_tiering=tiering, num_pages=4)
    with pytest.raises(ValueError, match=match):
        eng.put_request(np.ones(40, np.int32), max_new_tokens=60)
    ref = jax_engine(w, kv_tiering=tiering, num_pages=4)
    with pytest.raises(ValueError, match=match):
        ref.put_request(np.ones(40, np.int32), max_new_tokens=60)


def test_admission_names_the_hbm_tier(w):
    """A request admitted on the tiers' capacity whose working set cannot
    fit the device pool fails loudly at admission."""
    eng = port_engine(w, kv_tiering={"host_pages": 64}, num_pages=4)
    eng.put_request(np.ones(60, np.int32), max_new_tokens=40)
    with pytest.raises(ValueError, match="HBM tier"):
        eng.step()
    assert not eng.waiting
    eng.close()


def _park(eng, sizes):
    """Submit and step until a request is spilled; the waiting queue then
    holds it and the queued rest."""
    for p in prompts(sizes):
        eng.put_request(p, max_new_tokens=40)
    while not any(r.spilled is not None for r in eng.waiting):
        eng.step()
    eng.sync()


def test_export_import_parked_between_engines(w):
    want = serve(port_engine(w), prompts(NVME_SIZES))
    ref = jax_engine(w, kv_tiering={"host_pages": 64})
    _park(ref, NVME_SIZES)
    ref_blobs = ref.export_parked()
    donor = port_engine(w, kv_tiering={"host_pages": 64})
    _park(donor, NVME_SIZES)
    blobs = donor.export_parked()
    assert [sorted(b) for b in blobs] == [sorted(b) for b in ref_blobs]
    spilled = [b for b in blobs if b["spill"] is not None]
    assert spilled and sorted(spilled[0]["spill"]) == sorted(
        next(b for b in ref_blobs if b["spill"] is not None)["spill"])
    assert sorted(spilled[0]["spill"]["payload"]) == sorted(
        next(b for b in ref_blobs
             if b["spill"] is not None)["spill"]["payload"])
    assert donor.tiering.audit()["sessions"] == 0
    donor.audit_kv_sharing()
    # the receiver finishes the parked sessions, the donor its live ones
    recv = port_engine(w, kv_tiering={"host_pages": 64})
    checked = check_restores(recv)
    new_uids = recv.import_parked(blobs)
    got = serve(recv, [])
    assert sum(checked) > 0 and recv.tiering.counters["imports"] > 0
    for b, u in zip(blobs, new_uids):
        np.testing.assert_array_equal(got[u], want[b["uid"]])
    for u, toks in serve(donor, []).items():
        np.testing.assert_array_equal(toks, want[u])
    assert recv.tiering.audit()["sessions"] == 0
    recv.close()
    donor.close()
    ref.close()


def test_cancel_spilled_request_releases_its_payload(w):
    eng = port_engine(w, kv_tiering={"host_pages": 64})
    _park(eng, NVME_SIZES)
    r = next(r for r in eng.waiting if r.spilled is not None)
    assert eng.tiering.holds(r.uid)
    assert eng.cancel(r.uid) == "spilled"
    assert not eng.tiering.holds(r.uid)
    eng.audit_kv_sharing()
    serve(eng, [])
    assert eng.tiering.audit()["sessions"] == 0
    assert eng.audit_kv_sharing()["referenced"] == 0
    eng.close()
