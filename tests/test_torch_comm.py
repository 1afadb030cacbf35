"""The port's comm layer over ``torch.distributed`` (``comm/``,
``parallel/topology.py``, ``resilience/``).

Ranks are processes spawned by ``torch_dist_workers.spawn``, joined over
gloo; the pytest process never initialises a process group.  What is
held:

- at worlds 1, 2 and 4, every collective (all_reduce sum/avg/max/min,
  all_gather tiled along two axes and stacked, reduce_scatter sum/avg
  along two axes, all_to_all, broadcast, ppermute, barrier) against numpy
  on the same seeded inputs (fp32, rtol 1e-6: only the sums' order
  differs), and the comms logger's exact counts, every call through the
  process group (a world of one's too, not a local copy);
- at world 2, the collective watchdog: one rank drops an all_reduce, the
  other raises ``CollectiveTimeout`` within its 1 s deadline;
- with no process group: a world of one (collectives are copies), NCCL
  without a GPU raising, the watchdog on a thread, and the straggler
  report, ``get_bw`` and the fault-spec parser against the JAX package's
  copies.
"""
import time

import numpy as np
import pytest
import torch

from deepspeed_tpu.comm.comms_logging import get_bw as jax_get_bw
from deepspeed_tpu.resilience.distributed import \
    build_straggler_report as jax_straggler_report
from deepspeed_tpu.resilience.faults import FaultInjector as JaxInjector
from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.comm import watchdog
from deepspeed_tpu_torch.comm.comms_logging import get_bw
from deepspeed_tpu_torch.parallel.topology import AXIS_ORDER
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.distributed import (
    CollectiveTimeout, build_straggler_report)
from torch_dist_workers import comm_worker, spawn
import torch_cpu  # noqa: F401  (one torch thread a process)

SEED = 11


@pytest.fixture(scope="module", params=[1, 2, 4])
def ranks(request, tmp_path_factory):
    world = request.param
    out = spawn(comm_worker, world, str(tmp_path_factory.mktemp("comm")),
                seed=SEED, watchdog=world == 2)
    return world, out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_collectives_match_numpy(ranks):
    world, out = ranks
    xs = [np.random.default_rng(SEED + r).standard_normal(
        (world * 2, 3)).astype(np.float32) for r in range(world)]
    for r in range(world):
        np.testing.assert_array_equal(out[r]["x"], xs[r])
    total = np.sum(xs, axis=0)
    for r, got in enumerate(out):
        _close(got["all_reduce_sum"], total)
        _close(got["all_reduce_avg"], total / world)
        _close(got["all_reduce_max"], np.max(xs, axis=0))
        _close(got["all_reduce_min"], np.min(xs, axis=0))
        _close(got["all_gather_0"], np.concatenate(xs, axis=0))
        _close(got["all_gather_1"], np.concatenate(xs, axis=1))
        _close(got["all_gather_stack"], np.stack(xs, axis=1))
        _close(got["reduce_scatter_0"], total[2 * r:2 * r + 2])
        _close(got["reduce_scatter_avg"], total[2 * r:2 * r + 2] / world)
        _close(got["reduce_scatter_1"], total.T[:, 2 * r:2 * r + 2])
        _close(got["all_to_all"], np.concatenate(
            [x[2 * r:2 * r + 2] for x in xs], axis=0))
        _close(got["all_to_all_01"], np.concatenate(
            [x[2 * r:2 * r + 2] for x in xs], axis=1))
        _close(got["broadcast"], xs[-1])
        _close(got["ppermute"], xs[(r - 1) % world])
        assert got["world_size"] == world and got["axis_index"] == r


def test_comms_logger_counts(ranks):
    world, out = ranks
    want = {"all_reduce": 4, "all_gather": 3, "reduce_scatter": 3,
            "all_to_all": 2, "broadcast": 1, "ppermute": 1, "barrier": 1}
    for got in out:
        assert got["counts"] == want
        # through the process group at every world, one rank's included
        assert got["backend_calls"] == want
        assert got["mean_latency_ops"] == sorted(want)
        # the report gathers across processes: none in a world of one
        assert ("cross-rank straggler report" in got["summary"]) == \
            (world > 1)
        assert got["logger_class"]


def test_watchdog_raises_when_a_rank_drops_a_collective(ranks):
    world, out = ranks
    if world != 2:                  # no drop staged: nothing timed out
        assert all("timed_out" not in r for r in out)
        return
    assert out[1]["dropped"]
    assert out[0]["timed_out"] is not None, "the all_reduce returned"
    assert 1.0 <= out[0]["timed_out"] < 3.0
    assert out[0]["timeouts"] == 1


def test_world_of_one_without_a_process_group():
    topo = comm.get_topology()
    assert topo.world_size == 1 and tuple(topo.shape) == AXIS_ORDER
    x = torch.arange(6, dtype=torch.float32).view(2, 3)
    assert comm.all_reduce(x.clone(), op="avg").equal(x)
    assert comm.all_gather(x, axis=1).equal(x)
    assert comm.all_gather(x, tiled=False).equal(x[None])
    assert comm.reduce_scatter(x).equal(x)
    assert comm.all_to_all(x).equal(x)
    assert comm.broadcast(x.clone()).equal(x)
    assert comm.get_world_size() == 1 and comm.get_rank() == 0
    assert not torch.distributed.is_initialized()


def test_nccl_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for kw in ({"dist_backend": "nccl"}, {}):
        with pytest.raises(RuntimeError, match="nccl backend needs a CUDA"):
            comm.init_distributed(**kw)
    assert not comm.is_initialized()
    assert not torch.distributed.is_initialized()


def test_watchdog_deadline_on_a_thread():
    dog = watchdog.CollectiveWatchdog(0.2)
    assert dog.guard(lambda: 7) == 7
    t0 = time.perf_counter()
    with pytest.raises(CollectiveTimeout, match="0.2s collective deadline"):
        dog.guard(lambda: time.sleep(2.0), what="comm.all_reduce")
    assert time.perf_counter() - t0 < 1.0 and dog.timeouts == 1
    with pytest.raises(ZeroDivisionError):
        dog.guard(lambda: 1 / 0)
    off = watchdog.CollectiveWatchdog(0.0)
    assert not off.enabled and off.guard(lambda: 3) == 3


def test_straggler_report_and_bw_match_jax():
    per_rank = [{"all_reduce": {"mean_s": 0.5, "count": 3},
                 "broadcast": {"mean_s": 0.01, "count": 1}},
                {"all_reduce": {"mean_s": 0.02, "count": 3},
                 "broadcast": {"mean_s": 0.011, "count": 1}},
                {"all_reduce": {"mean_s": 0.49, "count": 3}}]
    got = build_straggler_report(per_rank)
    assert repr(got) == repr(jax_straggler_report(per_rank))   # nan too
    assert got["all_reduce"]["straggler_rank"] == 1
    for op in ("all_reduce", "all_gather_into_tensor", "broadcast",
               "barrier"):
        for n in (1, 2, 8):
            assert get_bw(op, 1 << 20, 1e-3, n) == \
                jax_get_bw(op, 1 << 20, 1e-3, n)


def test_fault_spec_parses_like_jax():
    spec = ("site=comm.all_reduce kind=corrupt after=1 param=0.5; "
            "site=ckpt.write_blob,kind=oserror,count=2")
    mine, ref = faults.FaultInjector.from_spec(spec), JaxInjector.from_spec(
        spec)
    assert [(f.site, f.kind, f.count, f.after, f.param) for f in
            mine.faults] == [(f.site, f.kind, f.count, f.after, f.param)
                             for f in ref.faults]
    with mine:
        assert faults.hook("comm.all_reduce") is None      # after=1
        assert faults.hook("comm.all_reduce") == ("corrupt", 0.5)
        with pytest.raises(OSError):
            faults.hook("ckpt.write_blob")
    assert faults.active() is None


def test_resolve_device_honours_local_rank(monkeypatch):
    from deepspeed_tpu_torch.accelerator import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert resolve_device() == torch.device("cuda", 0)     # no group
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    assert resolve_device() == torch.device("cuda", 3)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
    assert resolve_device("cpu") == torch.device("cpu")
