"""The offload tiers' stream (``runtime/swap_tensor.py``) on its own, its
fault paths, and the tiers at ZeRO stages 1-3 over two gloo ranks.

The swappers run over flat fp32 buffers with seeded numpy gradients and
the engine's Adam scalars (``Adam.bias_corrections``).  What is held:

- the bucket plan: units merge up to the cap, a longer unit is cut, the
  buckets cover the shard;
- pipelined against serial, at every ``buffer_count`` from 1 to 4:
  master, working copy and moments bit-identical, and every NVMe bucket
  file byte-identical;
- SDC: a bitflip on swap-in that heals on re-read gives the clean run's
  bits; one on the media quarantines the file, invalidates the moments
  and raises ``SwapCorruptionError``; in ``train_batch`` the emergency
  checkpoint is then a ``.torn`` postmortem copy, ``latest`` keeps the
  last whole checkpoint and a load refuses the copy;
- writes: a transient async-write failure retries through the blocking
  path (bit-identical, files included); one that persists, or a torn
  write, invalidates the moments, and the next step streams zero moments
  as a fresh swapper does from the same master;
- ``swapper_knobs`` resizes ``buffer_count`` at the next step's start,
  bit-identically; the ``sigterm`` fault kind reaches an installed
  preemption handler, which takes the emergency checkpoint; inside a
  step it waits for the step's end (the checkpoint holds the whole
  stepped master), and a step that then fails saves nothing;
- an NVMe checkpoint's save and load hold one bucket's moments on the
  host at a time;
- two gloo ranks at stages 1-3: each tier's losses, masters and moments
  bit-identical to the resident engine's on every rank.
"""
import json
import os
import signal

import numpy as np
import pytest
import torch

from deepspeed_tpu_torch.control.knobs import swapper_knobs
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience import retry as retry_mod
from deepspeed_tpu_torch.resilience.faults import (FaultInjector,
                                                   SimulatedCrash,
                                                   flip_bit_in_file)
from deepspeed_tpu_torch.resilience.guards import SwapCorruptionError
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.swap_tensor import (HostMomentSwapper,
                                                     NvmeOptimizerSwapper,
                                                     plan_buckets)
from torch_dist_workers import (TINY, largest_fp32_tensor, make_engine,
                                offload_worker, spawn, tiny_model,
                                whole_pieces)
import torch_cpu  # noqa: F401  (one torch thread a process)

N = 600_000
UNITS = [(a, min(a + 50_000, N)) for a in range(0, N, 50_000)]


@pytest.fixture(autouse=True)
def many_buckets(monkeypatch):
    monkeypatch.setenv("DSTPU_SWAP_BUCKET_MB", "1")


@pytest.fixture
def fake_sleep(monkeypatch):
    """Retry backoffs never really sleep in tier-1."""
    delays = []
    monkeypatch.setattr(retry_mod, "_sleep", delays.append)
    return delays


def test_bucket_plan():
    units = [(0, 10), (10, 3000), (3000, 3100), (3100, 9000)]
    got = plan_buckets(units, cap=2048, align=1024)
    assert got == [(0, 10), (10, 2058), (2058, 3100), (3100, 5148),
                   (5148, 7196), (7196, 9000)]
    assert plan_buckets([(0, 500), (500, 900)], cap=2048) == [(0, 900)]
    flat = [i for a, b in plan_buckets(UNITS) for i in (a, b)]
    assert flat[0] == 0 and flat[-1] == N
    assert all(x == y for x, y in zip(flat[1::2], flat[2::2]))


class _Run:
    """A swapper over ``N`` seeded masters, stepped like the engine."""

    def __init__(self, kind, path, w_dtype=torch.float32, **kw):
        rng = np.random.default_rng(0)
        self.opt, _ = build_optimizer("adamw", {
            "lr": 1e-2, "weight_decay": 0.1, "betas": [0.9, 0.95],
            "fused": True})
        common = dict(device="cpu", optimizer=self.opt, **kw)
        if kind == "nvme":
            self.sw = NvmeOptimizerSwapper(str(path), N, UNITS, **common)
        else:
            self.sw = HostMomentSwapper(N, UNITS, **common)
        self.sw.p.copy_(torch.from_numpy(
            rng.standard_normal(N).astype(np.float32)))
        self.w = self.sw.p.to(w_dtype)
        self.state = {"count": torch.zeros((), dtype=torch.int32)}
        self.sc = torch.zeros(5)
        self.sc[0] = 1e-2
        self.sc[3] = 1.0

    def step(self, i):
        g = torch.from_numpy(np.random.default_rng(100 + i).standard_normal(
            N).astype(np.float32))
        self.opt.bias_corrections(self.state, self.sc)
        self.sw.step(g, self.w, self.sc)
        self.opt.advance(self.state, self.sc)

    def steps(self, a, b, prefetch=False):
        for i in range(a, b):
            if prefetch and hasattr(self.sw, "start_prefetch"):
                self.sw.start_prefetch()
            self.step(i)
        self.sw.synchronize()
        return self

    def state_bits(self):
        return [self.sw.p.clone(), self.w.clone(), *_moments(self.sw)]

    def files(self):
        return {k: open(self.sw._fname(k), "rb").read()
                for k in sorted(self.sw._ready)}


def _moments(sw):
    """The tier's whole ``m`` and ``v``, on the host."""
    sw.synchronize()
    if isinstance(sw, HostMomentSwapper):
        return sw.m.clone(), sw.v.clone()
    mv = [(sw.read_bucket(k), b - a) for k, (a, b) in enumerate(sw.buckets)]
    return (torch.cat([t[:n] for t, n in mv]),
            torch.cat([t[n:] for t, n in mv]))


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a.state_bits(),
                                                  b.state_bits()))


@pytest.mark.parametrize("buffer_count", [1, 2, 3, 4])
@pytest.mark.parametrize("kind", ["cpu", "nvme"])
def test_pipelined_equals_serial(kind, buffer_count, tmp_path):
    serial = _Run(kind, tmp_path / "s", torch.bfloat16, pipeline_read=False,
                  pipeline_write=False).steps(0, 3)
    pipe = _Run(kind, tmp_path / "p", torch.bfloat16,
                buffer_count=buffer_count).steps(0, 3, prefetch=True)
    assert len(pipe.sw.buckets) >= 6
    assert pipe.sw.slot_count == max(2, buffer_count)
    assert pipe.sw.stage_stats["pipelined"]
    assert not serial.sw.stage_stats["pipelined"]
    assert pipe.sw.updates == serial.sw.updates == 3 * len(pipe.sw.buckets)
    assert _same(pipe, serial)
    if kind == "nvme":
        assert pipe.files() == serial.files()
        st = pipe.sw.stage_stats
        assert st["bytes_read"] == st["bytes_written"] == 8 * N
        assert 0.0 <= st["overlap_efficiency"] <= 1.0
    pipe.sw.close()
    serial.sw.close()


def test_transient_bitflip_heals_bit_identically(tmp_path, fake_sleep):
    faulty = _Run("nvme", tmp_path / "f").steps(0, 1)
    clean = _Run("nvme", tmp_path / "c").steps(0, 1)
    with FaultInjector(seed=3).bitflip("swap.read_bucket", count=1) as inj:
        faulty.steps(1, 2)
    assert ("swap.read_bucket", "bitflip", 1) in inj.fired
    c = faulty.sw.sdc_counters
    assert c["mismatches"] == 1 and c["reread_recovered"] == 1
    assert c["quarantined"] == 0 and fake_sleep == []
    clean.steps(1, 2)
    assert _same(faulty, clean) and faulty.files() == clean.files()
    assert faulty.sw.stage_stats["sdc"]["mismatches"] == 1
    faulty.sw.close()
    clean.sw.close()


def test_persistent_bitflip_quarantines_and_raises(tmp_path, fake_sleep):
    run = _Run("nvme", tmp_path / "r", sdc_max_reread=1).steps(0, 1)
    bucket = run.sw._fname(0)
    flip_bit_in_file(bucket, seed=11)
    with pytest.raises(SwapCorruptionError):
        run.steps(1, 2)
    c = run.sw.sdc_counters
    assert c["mismatches"] == 1 and c["quarantined"] == 1
    assert c["rereads"] == 2 and c["reread_recovered"] == 0
    assert not os.path.exists(bucket)
    assert os.path.exists(bucket + ".quarantine")
    assert not run.sw._ready and not run.sw._sums
    run.sw.close()


def test_engine_routes_corruption_through_emergency_checkpoint(tmp_path):
    """A persistent flip in bucket 5's file at step 3: buckets 0-4 were
    stepped in place and the moments are gone, so the emergency
    checkpoint is a postmortem copy (``.torn``) that ``latest`` does not
    name and a load refuses; the restart loads the last whole one."""
    eng = make_engine(_state(), 2, offload_optimizer={
        "device": "nvme", "nvme_path": str(tmp_path / "swap")})
    ckpt = str(tmp_path / "ckpt")
    eng.install_preemption_handler(ckpt, exit_after=False)
    batches = _batches()
    try:
        eng.train_batch(batch=batches[0])
        eng.save_checkpoint(ckpt)
        want = whole_pieces(eng)
        eng.train_batch(batch=batches[1])
        sw = eng.swapper
        sw.synchronize()
        assert len(sw.buckets) > 6
        flip_bit_in_file(sw._fname(5), seed=23)
        with pytest.raises(SwapCorruptionError):
            eng.train_batch(batch=batches[2])
        assert eng.swap_corrupted
        assert any(".quarantine" in f for f in os.listdir(sw.swap_dir))
        assert sorted(t for t in os.listdir(ckpt)
                      if not t.startswith("flight_")) == [
            "emergency_step2.torn", "global_step1", "latest"]
        with open(os.path.join(ckpt, "latest")) as f:
            assert f.read().strip() == "global_step1"
        from deepspeed_tpu_torch.checkpoint import sharded

        ok, reason = sharded.verify_tag(os.path.join(ckpt,
                                                     "emergency_step2.torn"))
        assert ok, reason
    finally:
        eng.uninstall_preemption_handler()
        eng.swapper.close()
    fresh = make_engine(_state(), 2)
    path, _ = fresh.load_checkpoint(ckpt)
    assert path.endswith("global_step1") and fresh.global_steps == 1
    got = whole_pieces(fresh)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(RuntimeError, match="postmortem"):
        fresh.load_checkpoint(ckpt, tag="emergency_step2.torn")


@pytest.mark.parametrize("fails", [False, True])
def test_sigterm_mid_step_never_saves_a_torn_master(fails, tmp_path):
    """SIGTERM at bucket 3's write of a 12-bucket NVMe step (the third:
    the warm-up's first two take lr 0): the handler
    holds it until the step is done, so the emergency checkpoint holds
    the whole stepped master, not buckets 0-3 stepped and the rest not;
    then the signal reaches the handler installed before.  When the step
    dies later in the stream, no checkpoint is taken and the signal is
    passed on all the same."""
    eng = make_engine(_state(), 2, offload_optimizer={
        "device": "nvme", "nvme_path": str(tmp_path / "swap")})
    ckpt = str(tmp_path / "ckpt")
    batches = _batches()
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    try:
        for b in batches[:2]:
            eng.train_batch(batch=b)
        pre = whole_pieces(eng)
        eng.install_preemption_handler(ckpt)
        with FaultInjector().sigterm("swap.write_bucket", after=3) as inj:
            if fails:
                inj.crash("swap.write_bucket", after=4)
                with pytest.raises(SimulatedCrash):
                    eng.train_batch(batch=batches[2])
            else:
                eng.train_batch(batch=batches[2])
        assert len(eng.swapper.buckets) > 6
        assert ("swap.write_bucket", "sigterm", 4) in inj.fired
        assert eng.preempted and got == [signal.SIGTERM]
        if fails:
            assert not os.path.exists(ckpt)
            return
        post = whole_pieces(eng)
    finally:
        eng.uninstall_preemption_handler()
        signal.signal(signal.SIGTERM, prev)
        eng.swapper.close()
    assert sorted(os.listdir(ckpt)) == ["emergency_step3", "latest"]
    fresh = make_engine(_state(), 2)
    fresh.load_checkpoint(ckpt)
    saved = whole_pieces(fresh)
    for k in post:
        assert torch.equal(saved[k], post[k]), k
    # the step moved every leaf: a save mid-stream would differ
    assert all(not torch.equal(saved[k], pre[k]) for k in pre
               if k.startswith("module/"))


def _fresh_at(run, tmp_path, name):
    """A fresh swapper at ``run``'s count and master: what an
    invalidated one must equal after its next step."""
    fresh = _Run("nvme", tmp_path / name)
    fresh.sw.p.copy_(run.sw.p)
    fresh.w.copy_(run.w)
    fresh.state["count"].copy_(run.state["count"])
    return fresh


def test_transient_write_failure_retries(tmp_path, fake_sleep):
    faulty = _Run("nvme", tmp_path / "f", buffer_count=2).steps(0, 1)
    clean = _Run("nvme", tmp_path / "c", pipeline_read=False,
                 pipeline_write=False).steps(0, 1)
    with FaultInjector(seed=0) as inj:
        # two async submits fail, then the first blocking retry of one
        inj.transient_oserror("swap.write_bucket", count=3)
        faulty.steps(1, 2)
    assert inj.fired and all(k == "oserror" for _, k, _ in inj.fired)
    assert fake_sleep, "the blocking retry path never backed off"
    clean.steps(1, 2)
    assert len(faulty.sw._ready) == len(faulty.sw.buckets)
    assert _same(faulty, clean) and faulty.files() == clean.files()
    faulty.sw.close()
    clean.sw.close()


@pytest.mark.parametrize("fault", ["persistent", "torn"])
def test_failed_write_invalidates_then_recovers(fault, tmp_path,
                                                fake_sleep):
    run = _Run("nvme", tmp_path / "r", buffer_count=2).steps(0, 1)
    master = [run.sw.p.clone(), run.w.clone()]
    with FaultInjector(seed=0) as inj:
        if fault == "torn":
            inj.torn_write("swap.write_bucket", fraction=0.25)
            err = SimulatedCrash
        else:
            inj.transient_oserror("swap.write_bucket", count=1000)
            err = OSError
        with pytest.raises(err):
            run.steps(1, 2)
    assert not run.sw._ready and not run.sw._sums
    assert run.state["count"].item() == 1
    # the master was stepped in place up to the failure: reload it, as
    # from a checkpoint, and the next step streams zero moments
    run.sw.p.copy_(master[0])
    run.w.copy_(master[1])
    fresh = _fresh_at(run, tmp_path, "fresh")
    run.steps(1, 2)
    fresh.steps(1, 2)
    assert _same(run, fresh)
    run.sw.close()
    fresh.sw.close()


@pytest.mark.parametrize("kind", ["cpu", "nvme"])
def test_swapper_knobs_resize_at_the_next_step(kind, tmp_path):
    run = _Run(kind, tmp_path / "r", buffer_count=2)
    ref = _Run(kind, tmp_path / "ref", buffer_count=2)
    reg = swapper_knobs(run.sw)
    knob = reg.get("swap.buffer_count")
    assert knob.get() == 2 and "swap.buffer_count" in reg
    run.steps(0, 1, prefetch=True)
    assert reg.set("swap.buffer_count", 99) == (2, 8)     # clamped
    reg.set("swap.buffer_count", 4)
    assert run.sw.buffer_count == 2          # applied at a quiescent point
    run.steps(1, 3, prefetch=True)
    assert run.sw.buffer_count == 4 and run.sw.slot_count == 4
    ref.steps(0, 3, prefetch=True)
    assert _same(run, ref)
    run.sw.close()
    ref.sw.close()


def test_sigterm_reaches_the_preemption_handler(tmp_path):
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: got.append(s))
    try:
        with FaultInjector().sigterm("swap.write_bucket") as inj:
            faults.hook("swap.write_bucket")
        assert got == [signal.SIGTERM] and inj.fired
    finally:
        signal.signal(signal.SIGTERM, prev)
    eng = make_engine(_state(), 0, offload_optimizer={"device": "cpu"})
    eng.train_batch(batch=_batches()[0])
    ckpt = str(tmp_path / "ckpt")
    eng.install_preemption_handler(ckpt, exit_after=False)
    try:
        signal.raise_signal(signal.SIGTERM)
    finally:
        eng.uninstall_preemption_handler()
    assert eng.preempted
    assert os.listdir(ckpt) == ["emergency_step1", "latest"] or \
        sorted(os.listdir(ckpt)) == ["emergency_step1", "latest"]
    eng.swapper.close()


def _state():
    rng = np.random.default_rng(1)
    out = {}
    with torch.device("meta"):
        shapes = {k: tuple(v.shape) for k, v in
                  tiny_model().state_dict().items()}
    for k, shape in shapes.items():
        fan = shape[-1] if len(shape) > 1 else 1
        out[k] = (rng.standard_normal(shape) / np.sqrt(fan)).astype(
            np.float32) if len(shape) > 1 else np.ones(shape, np.float32)
    return out


def _batches(n=3):
    rng = np.random.default_rng(2)
    return [rng.integers(0, TINY["vocab_size"], size=(8, 16))
            for _ in range(n)]


def test_nvme_checkpoint_holds_one_bucket_at_a_time(tmp_path):
    """An NVMe tier's checkpoint save, and its load into another NVMe
    engine, hold one bucket's ``[m; v]`` on the host at a time (the
    largest fp32 tensor either makes), not the shard's moments; each
    saved moment record lies within a bucket; the load gives the saved
    bits."""
    def nvme(name):
        return make_engine(_state(), 2, offload_optimizer={
            "device": "nvme", "nvme_path": str(tmp_path / name)})

    eng = nvme("a")
    for b in _batches():
        eng.train_batch(batch=b)
    cap = max(b - a for a, b in eng.swapper.buckets)
    assert eng.swapper.numel > 8 * cap
    ckpt = str(tmp_path / "ckpt")
    _, most = largest_fp32_tensor(lambda: eng.save_checkpoint(ckpt, tag="t"))
    assert most <= 2 * cap, (most, cap)
    want = whole_pieces(eng)
    with open(os.path.join(ckpt, "t", "index_p0.json")) as f:
        records = json.load(f)["records"]
    moments = [r for r in records if r["path"].startswith(
        ("optimizer/m/", "optimizer/v/"))]
    assert len(moments) > len({r["path"] for r in moments})   # cut leaves
    assert all(r["nbytes"] <= 4 * cap for r in moments)
    back = nvme("b")
    _, most = largest_fp32_tensor(lambda: back.load_checkpoint(ckpt, tag="t"))
    # the working copy's refresh after any load gathers a unit at a time
    unit = max(u.padded for u in back.plan.units)
    assert most <= max(2 * cap, unit) < back.swapper.numel, (most, cap)
    got = whole_pieces(back)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for e in (eng, back):
        e.swapper.close()


def test_tiers_match_resident_at_world2(tmp_path):
    out = spawn(offload_worker, 2, str(tmp_path), state=_state(),
                batches=_batches(), swap_dir=str(tmp_path / "swap"))
    for rank in out:
        assert sorted(rank) == [(s, t) for s in (1, 2, 3)
                                for t in ("cpu", "nvme")]
        for case, r in rank.items():
            assert r["buckets"] > 2, case
            assert r["same_losses"] and r["same_state"], case
    for case in out[0]:
        assert out[0][case]["losses"] == out[1][case]["losses"]
