"""Optimizer-state offload: the ZeRO-Offload and ZeRO-Infinity tiers.

Counterpart of ``deepspeed_tpu/runtime/swap_tensor.py``
(``HostMomentSwapper`` and ``NvmeOptimizerSwapper``; the reference's
``runtime/swap_tensor/partitioned_optimizer_swapper.py`` and
``pipelined_optimizer_swapper.py``).  The engine keeps its state in flat
buffers (``runtime/engine.py``); a tier takes the fp32 master and the two
Adam moments of this rank's flat shard off the card and streams them
through it once a step, bucket by bucket:

- tier ``cpu`` (:class:`HostMomentSwapper`): master and moments in
  page-locked host RAM;
- tier ``nvme`` (:class:`NvmeOptimizerSwapper`): the master in
  page-locked host RAM, the moments in one ``[m; v]`` file a bucket on
  NVMe, through the native async I/O engine (``io/aio.py``).

The working copy (compute dtype) and the fp32 gradient stay on the card;
at stage 3 with ``offload_param`` the working-copy shard lives in host RAM
too and the step writes it back beside the master.

**Buckets.**  A bucket is a contiguous range of the flat shard.  Gather
units (one decoder block, ``runtime/zero.py``) follow each other into one
bucket while it stays within :data:`BUCKET_CAP` elements; a larger unit is
cut into pieces of the cap.  The cap keeps the card's staging, at most
:data:`MAX_BUFFERS` slots of ``p, m, v`` (12 bytes an element), within
:data:`STAGING_BYTES` (3 GiB): 2**25 elements, 402.7 MB of fp32 ``p, m,
v`` a bucket.

**The step**, for each bucket ``[a, b)`` in slot ``k % slots``:

1. on a copy stream: ``p[a:b]``, ``m[a:b]``, ``v[a:b]`` host to device into
   the slot (after the slot's previous bucket was copied back);
2. on the compute stream: the engine's optimizer's own update
   (``Adam.update``: one ``fused_adam`` launch, kernel #4,
   ``ops/fused_adam.py``, when it is fused, as in the resident step) over
   the slot, ``g[a:b]`` and the working copy's ``w[a:b]``, with the
   step's ``step_scalars``;
3. on a second copy stream: the slot back into host RAM.

Events order the three streams, so up to ``slots`` buckets are in flight
and the host never waits on the card inside the step.  One loop
(:meth:`_TierBase.step`) runs both tiers; a tier only says where a
bucket's moments come from and go to.  AdamW is elementwise, every
bucket reads the same scalars and runs the resident step's update, so
the offloaded step gives the resident step's bits: losses, masters and
moments.  The
NVMe tier adds the file reads ahead of step 1 (read-ahead of ``slots -
1`` buckets, :meth:`NvmeOptimizerSwapper.start_prefetch` starting the
first ones under the backward) and the file writes after step 3 (the
last ones deferred past the step, drained at the next one), each
digested for silent data corruption (``resilience/sdc.py``): a bucket
whose bytes fail their digest on swap-in is re-read, then quarantined,
and :class:`~deepspeed_tpu_torch.resilience.guards.SwapCorruptionError`
raises (the engine saves a postmortem copy and re-raises, so the job
restarts from its last whole checkpoint).  A failed async write
retries through the blocking path; a write that keeps failing
invalidates the swapped moments (they restart from zero, as the JAX
swapper's do).  A checkpoint reads and writes the NVMe moments a bucket
at a time (:class:`MomentFiles`), so it holds one bucket's ``[m; v]`` in
host RAM beside the tier's own buffers.

On ``cuda`` the host buffers are page-locked by CUDA
(``cudaHostRegister`` of their own allocation: the caching host allocator
rounds each request up to a power of two, ~33% more than 96 GB for
``llama3-8b``) and a tier that cannot pin raises.  With ``device="cpu"``,
as the tests run it, the same plan runs with plain host copies.
"""
from __future__ import annotations

import atexit
import contextlib
import os
import shutil
import time
import weakref
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.ops import fused_adam as fa
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.guards import SwapCorruptionError
from deepspeed_tpu_torch.resilience.retry import retriable
from deepspeed_tpu_torch.utils.async_stage import StageTimers
from deepspeed_tpu_torch.utils.logging import log_dist, logger

STAGING_BYTES = 3 << 30
MAX_BUFFERS = 8               # the buffer_count knob's upper bound
BUCKET_CAP = STAGING_BYTES // (MAX_BUFFERS * 12)       # 2**25 elements
PAGE = 4096

__all__ = ["BUCKET_CAP", "HostMomentSwapper", "MomentFiles",
           "NvmeOptimizerSwapper", "bucket_cap", "host_buffer",
           "plan_buckets"]


def bucket_cap() -> int:
    """:data:`BUCKET_CAP`, or the elements of ``DSTPU_SWAP_BUCKET_MB``
    megabytes of ``p, m, v`` (the JAX package's override of its bucket
    size; the tests use it to get many buckets from a small model)."""
    mb = os.environ.get("DSTPU_SWAP_BUCKET_MB")
    return (int(mb) << 20) // 12 if mb else BUCKET_CAP


def plan_buckets(units: Sequence[Tuple[int, int]],
                 cap: Optional[int] = None,
                 align: int = 1024) -> List[Tuple[int, int]]:
    """``[(start, stop)]`` buckets over the contiguous ``units`` (ranges of
    the flat shard in layout order): units follow each other into one
    bucket while it holds at most ``cap`` elements (:func:`bucket_cap`);
    a longer unit is cut into pieces of ``cap`` (rounded down to
    ``align``) and a remainder."""
    cap = bucket_cap() if cap is None else cap
    cap = max(align, cap // align * align)
    out: List[Tuple[int, int]] = []
    cur: Optional[List[int]] = None
    for a, b in units:
        if b <= a:
            continue
        if cur is not None and cur[1] == a and b - cur[0] <= cap:
            cur[1] = b
            continue
        if cur is not None:
            out.append(tuple(cur))
        while b - a > cap:
            out.append((a, a + cap))
            a += cap
        cur = [a, b]
    if cur is not None:
        out.append(tuple(cur))
    return out


# ---------------------------------------------------------------------------
# Page-locked host memory
# ---------------------------------------------------------------------------

def _unregister(ptr: int) -> None:
    torch.cuda.cudart().cudaHostUnregister(ptr)


class _Pinned:
    """One host allocation, registered with CUDA while this
    object lives.  Views of ``tensor`` may outlive it (they are then
    ordinary pageable memory)."""

    def __init__(self, nbytes: int, pin: bool, zero: bool):
        raw = torch.empty(nbytes + PAGE, dtype=torch.uint8)
        off = (-raw.data_ptr()) % PAGE
        self.tensor = raw[off:off + nbytes]
        if zero or pin:
            # fault the pages in with every core before CUDA pins
            # them (a registration faults them one thread at a time)
            raw.zero_()
        self.pinned = False
        if pin and nbytes:
            # the whole allocation: the storage's base pointer, which
            # ``Tensor.is_pinned`` asks CUDA about, lies before the
            # aligned view
            err = torch.cuda.cudart().cudaHostRegister(
                raw.data_ptr(), raw.numel(), 0)
            if int(err) != 0:
                raise RuntimeError(
                    f"cudaHostRegister of {nbytes / 2**30:.2f} GiB failed "
                    f"({err}): the host cannot page-lock the offloaded "
                    "state")
            self.pinned = True
            weakref.finalize(self, _unregister, raw.data_ptr())


def host_buffer(n: int, dtype: torch.dtype, device: torch.device,
                zero: bool = True, owners: Optional[list] = None
                ) -> torch.Tensor:
    """A flat host tensor of ``n`` elements, page-aligned, page-locked
    when ``device`` is a CUDA device (raises if CUDA refuses).
    ``owners`` keeps the registration alive (drop it to unpin)."""
    nbytes = n * torch.empty((), dtype=dtype).element_size()
    buf = _Pinned(nbytes, device.type == "cuda", zero)
    if owners is not None:
        owners.append(buf)
    return buf.tensor.view(dtype)


class _Streams:
    """The copy streams and events of a tier on ``cuda``; on the CPU
    every method is a no-op and copies run in order."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.device = device
        if self.cuda:
            self.h2d = torch.cuda.Stream(device)
            self.d2h = torch.cuda.Stream(device)

    def on(self, which: str):
        if not self.cuda:
            return contextlib.nullcontext()
        return torch.cuda.stream(getattr(self, which))

    def event(self):
        return torch.cuda.Event() if self.cuda else None

    def join_compute(self) -> None:
        """Both copy streams wait for what the compute stream has queued
        (before they first touch memory allocated on it)."""
        if self.cuda:
            cur = torch.cuda.current_stream(self.device)
            self.h2d.wait_stream(cur)
            self.d2h.wait_stream(cur)

    def record(self, ev, which: Optional[str] = None) -> None:
        if ev is not None:
            ev.record(getattr(self, which) if which else
                      torch.cuda.current_stream(self.device))

    def wait(self, ev, which: Optional[str] = None) -> None:
        if ev is not None:
            (getattr(self, which) if which else
             torch.cuda.current_stream(self.device)).wait_event(ev)


def _copy_parts(dst: torch.Tensor, parts) -> None:
    """``dst`` from the concatenation of ``parts`` (zeros when None)."""
    if parts is None:
        dst.zero_()
        return
    at = 0
    for t in parts:
        dst[at:at + t.numel()].copy_(t, non_blocking=True)
        at += t.numel()


class _TierBase:
    """What both tiers share: the bucket plan, the host master, the
    card's staging slots and the three-stream step.  A tier says where a
    bucket's moments come from (:meth:`_moments_in`) and go to
    (:meth:`_moments_out`); the rest of the step is this class's."""

    moments_on_host = True

    def __init__(self, numel: int, units: Sequence[Tuple[int, int]], *,
                 device, optimizer, buffer_count: int = 3,
                 pipeline_read: bool = True, pipeline_write: bool = True):
        self.device = torch.device(device)
        self.numel = int(numel)
        self.buckets = plan_buckets(units)
        if self.buckets and (self.buckets[0][0] != 0 or
                             self.buckets[-1][1] != self.numel):
            raise ValueError("the units must cover the flat shard")
        # the engine's optimizer: its update (fused or not) and its
        # hyperparameters are the resident step's
        self.opt = optimizer
        self.pipeline_read = bool(pipeline_read)
        self.pipeline_write = bool(pipeline_write)
        self._buffer_count = max(1, int(buffer_count))
        self._req_buffer_count: Optional[int] = None
        self._working_dtype: Optional[torch.dtype] = None
        self._owners: list = []
        self._streams = _Streams(self.device)
        self._slots: List[Dict] = []
        self._done = self._streams.event()      # the last step's copies back
        self.stage_timers = StageTimers(cat="swap")
        self.stage_stats: Dict = {}
        self.updates = 0                # bucket updates (kernel #4 calls)
        t0 = time.perf_counter()
        self.p = host_buffer(self.numel, torch.float32, self.device,
                             owners=self._owners)
        self._alloc_moments()
        self.pin_seconds = time.perf_counter() - t0
        self.host_bytes = sum(o.tensor.numel() for o in self._owners)

    def _alloc_moments(self) -> None:
        pass

    # -- the buffer_count knob --------------------------------------------

    @property
    def slot_count(self) -> int:
        return max(2, self._buffer_count) if self.pipeline_read else 1

    @property
    def buffer_count(self) -> int:
        return self._buffer_count

    def set_buffer_count(self, n: int) -> None:
        """Resize the windows at the next quiescent point (the next
        step's start, with no read in flight): the controller's runtime
        knob.  Numerics do not change: every slot count gives the same
        bits."""
        self._req_buffer_count = min(MAX_BUFFERS, max(1, int(n)))

    def _apply_requested_buffer_count(self) -> None:
        if self._req_buffer_count is None:
            return
        n, self._req_buffer_count = self._req_buffer_count, None
        if n != self._buffer_count:
            self.synchronize()
            self._buffer_count = n
            self._slots = []             # re-made at the new count

    # -- staging on the card ----------------------------------------------

    def _ensure_slots(self, w_host: bool) -> None:
        want = self.slot_count
        if len(self._slots) == want and all(
                (s["w"] is not None) == w_host for s in self._slots):
            return
        cap = max((b - a for a, b in self.buckets), default=0)
        st = self._streams
        self._slots = [dict(
            pmv=torch.empty(3 * cap, dtype=torch.float32, device=self.device),
            w=(torch.empty(cap, dtype=self._working_dtype,
                           device=self.device) if w_host else None),
            loaded=st.event(), updated=st.event(), free=st.event())
            for _ in range(want)]
        # the slots may reuse blocks that kernels still queued on the
        # compute stream (the backward's) use: the copy streams start
        # after them
        st.join_compute()

    # -- host reads -------------------------------------------------------

    def synchronize(self) -> None:
        """Wait until the last step's copies back are in host RAM (before
        the host reads the master or the moments)."""
        if self._done is not None:
            self._done.synchronize()

    def fill_working(self, w: torch.Tensor) -> None:
        """``w`` (the working copy, on the card or in host RAM) from the
        master, one bucket at a time (a whole cast would stage a copy of
        the master in the working dtype)."""
        self.synchronize()
        for a, b in self.buckets:
            w[a:b].copy_(self.p[a:b])

    def close(self) -> None:
        self.synchronize()
        self._slots = []
        self._owners = []

    # -- the step ----------------------------------------------------------

    def _w_mode(self, w: Optional[torch.Tensor]) -> str:
        """How the step writes the working copy: ``none`` (the master is
        it), ``kernel`` (the update writes it on the card), ``copy`` (an
        fp32 copy on the card), ``host`` (staged, copied back beside the
        master: ``offload_param``)."""
        if w is None or w is self.p:
            return "none"
        if w.device != self.device:
            if w.dtype == torch.float32:
                raise ValueError("an fp32 working copy in host RAM is the "
                                 "master: pass it as the master")
            self._working_dtype = w.dtype
            return "host"
        return "copy" if w.dtype == torch.float32 else "kernel"

    def _update(self, slot: Dict, n: int, g: torch.Tensor,
                w: Optional[torch.Tensor], w_mode: str, a: int, b: int,
                sc: torch.Tensor) -> None:
        """The optimizer's own update of one bucket on the card."""
        pmv = slot["pmv"]
        dw = None
        if w_mode == "kernel":
            dw = w[a:b]
        elif w_mode == "host":
            dw = slot["w"][:n]
        self.opt.update(pmv[:n], g[a:b], pmv[n:2 * n], pmv[2 * n:3 * n], sc,
                        dw)
        self.updates += 1
        if w_mode == "copy":
            w[a:b].copy_(pmv[:n])

    def step(self, g: torch.Tensor, w: Optional[torch.Tensor],
             sc: torch.Tensor) -> None:
        """One AdamW step of the whole shard: every bucket's master and
        moments through the card, one update (kernel #4 when the
        optimizer is fused) each; see the module's docstring."""
        self._begin_step()
        w_mode = self._w_mode(w)
        self._ensure_slots(w_mode == "host")
        st, slots = self._streams, self._slots
        t0 = time.perf_counter()
        with st.on("h2d"):
            st.wait(self._done, "h2d")
        ok = False
        try:
            self._open_stream()
            for k, (a, b) in enumerate(self.buckets):
                n = b - a
                slot = slots[k % len(slots)]
                pmv = slot["pmv"]
                src = self._moments_in(k)
                with st.on("h2d"):
                    st.wait(slot["free"], "h2d")
                    pmv[:n].copy_(self.p[a:b], non_blocking=True)
                    _copy_parts(pmv[n:3 * n], src)
                    st.record(slot["loaded"], "h2d")
                st.wait(slot["loaded"])
                self._update(slot, n, g, w, w_mode, a, b, sc)
                st.record(slot["updated"])
                dst = self._moments_out(k)
                with st.on("d2h"):
                    st.wait(slot["updated"], "d2h")
                    self.p[a:b].copy_(pmv[:n], non_blocking=True)
                    at = n
                    for t in dst:
                        t.copy_(pmv[at:at + t.numel()], non_blocking=True)
                        at += t.numel()
                    if w_mode == "host":
                        w[a:b].copy_(slot["w"][:n], non_blocking=True)
                    st.record(slot["free"], "d2h")
                self._copied_back(k)
            self._close_stream()
            with st.on("d2h"):
                st.record(self._done, "d2h")
            if w_mode == "host":
                st.wait(self._done)  # the next gather reads w from host RAM
            ok = True
        finally:
            if not ok:
                self._abort_step()
        self._record_stats(time.perf_counter() - t0, len(slots) > 1)

    # -- what a tier adds to the step ----------------------------------------

    def _begin_step(self) -> None:
        self._apply_requested_buffer_count()

    def _open_stream(self) -> None:
        pass

    def _moments_in(self, k: int):
        """Bucket ``k``'s ``[m; v]`` as host tensors to concatenate, or
        None for zero moments."""
        raise NotImplementedError

    def _moments_out(self, k: int):
        """Where bucket ``k``'s updated ``[m; v]`` go: host tensors to
        fill in order."""
        raise NotImplementedError

    def _copied_back(self, k: int) -> None:
        pass

    def _close_stream(self) -> None:
        pass

    def _abort_step(self) -> None:
        pass

    def _record_stats(self, total: float, pipelined: bool) -> None:
        tt = self.stage_timers
        tt.reset()
        tt.add("apply", total)
        tt.count("buckets", len(self.buckets))
        tt.count("bytes_h2d", 12 * self.numel)
        tt.count("bytes_d2h", 12 * self.numel)
        self.stage_stats = {**tt.snapshot(), "pipelined": pipelined}


class HostMomentSwapper(_TierBase):
    """Tier ``cpu``: the fp32 master and the Adam moments of this rank's
    shard in page-locked host RAM, streamed through the card bucket by
    bucket (the JAX package's ``HostMomentSwapper``)."""

    def _alloc_moments(self) -> None:
        self.m = host_buffer(self.numel, torch.float32, self.device,
                             owners=self._owners)
        self.v = host_buffer(self.numel, torch.float32, self.device,
                             owners=self._owners)
        log_dist(f"host-offload optimizer: {len(self.buckets)} buckets, "
                 f"{3 * 4 * self.numel / 1e9:.2f} GB of master and moments "
                 f"in {'page-locked ' if self.device.type == 'cuda' else ''}"
                 "host memory", ranks=[0])

    def _moments_in(self, k: int):
        a, b = self.buckets[k]
        return self.m[a:b], self.v[a:b]

    _moments_out = _moments_in


# ---------------------------------------------------------------------------
# The NVMe tier
# ---------------------------------------------------------------------------

def _pid_alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


_SWAP_DIR_SEQ = iter(range(1 << 62))


def _swap_dir_name() -> str:
    """``swap.p<pid>.<seq>``: one directory per swapper of this process,
    so two jobs (or two engines) on one NVMe path never share files."""
    return f"swap.p{os.getpid()}.{next(_SWAP_DIR_SEQ)}"


def _prune_stale_swap_dirs(root: str) -> None:
    """Remove the swap directories of processes that are gone (their
    moments are worthless without their job)."""
    try:
        names = os.listdir(root)
    except OSError:
        return
    for name in names:
        if not name.startswith("swap.p"):
            continue
        try:
            pid = int(name[len("swap.p"):].split(".")[0])
        except ValueError:
            continue
        if pid != os.getpid() and not _pid_alive(pid):
            shutil.rmtree(os.path.join(root, name), ignore_errors=True)


def _close_weak(ref) -> None:
    obj = ref()
    if obj is not None:
        obj.close()


class NvmeOptimizerSwapper(_TierBase):
    """Tier ``nvme``: the fp32 master in page-locked host RAM, the Adam
    moments in one ``[m; v]`` file a bucket on NVMe, read ahead into
    page-locked slots and written back behind the update (the JAX
    package's ``NvmeOptimizerSwapper``, bucketed by the flat shard).

    ``pipeline_read`` / ``pipeline_write``: read-ahead of ``slots - 1``
    buckets, and write-back of ``slots - 1`` buckets in flight with the
    last ones deferred past the step; both off is the strictly serial
    stream, whose bits the pipelined one equals."""

    moments_on_host = False
    _SDC_DEFER_MIN = 4 << 20

    def __init__(self, swap_dir: str, numel: int,
                 units: Sequence[Tuple[int, int]], *, device,
                 aio_block_size: int = 1 << 20, aio_thread_count: int = 8,
                 aio_queue_depth: int = 128, aio_use_odirect: bool = False,
                 sdc_verify: bool = True, sdc_checksum: str = "sum64",
                 sdc_max_reread: int = 2, **kw):
        from deepspeed_tpu_torch.io.aio import aio_handle

        _prune_stale_swap_dirs(swap_dir)
        self.swap_dir = os.path.join(swap_dir, _swap_dir_name())
        try:
            os.makedirs(self.swap_dir, exist_ok=True)
            probe = os.path.join(self.swap_dir, ".probe")
            with open(probe, "wb") as f:
                f.write(b"0")
            os.remove(probe)
        except OSError as e:
            raise OSError(f"offload_optimizer.nvme_path {swap_dir!r} is not "
                          f"writable: {e}") from e
        self._atexit = lambda ref=weakref.ref(self): _close_weak(ref)
        atexit.register(self._atexit)
        self.handle = aio_handle(block_size=aio_block_size,
                                 thread_count=aio_thread_count,
                                 queue_depth=aio_queue_depth,
                                 use_odirect=aio_use_odirect)
        self._sdc_verify = bool(sdc_verify)
        self._sdc_algo = str(sdc_checksum)
        self._sdc_rereads = max(0, int(sdc_max_reread))
        self._sdc_pool = None
        self._sums: Dict[int, Tuple[int, int]] = {}
        self.sdc_counters = {"verified": 0, "mismatches": 0, "rereads": 0,
                             "reread_recovered": 0, "quarantined": 0}
        self._ready: set = set()           # buckets with moments on disk
        # bucket -> [op, slot, joined]: a read in flight, or joined with
        # its digest on the side pool
        self._reads: Dict[int, list] = {}
        self._writes: Dict[int, Tuple] = {}  # bucket -> (op, slot index)
        self._host_slots: List[Dict] = []
        self._prefetched = 0
        self._t_in = self._t_out = self._t_verify = self._t_up = 0.0
        super().__init__(numel, units, device=device, **kw)
        log_dist(f"NVMe optimizer swap: {len(self.buckets)} buckets, "
                 f"{2 * 4 * self.numel / 1e9:.2f} GB of moments at "
                 f"{self.swap_dir}, master in host memory", ranks=[0])

    # -- files ------------------------------------------------------------

    def _fname(self, k: int) -> str:
        return os.path.join(self.swap_dir, f"bucket_{k:05d}.bin")

    def _pool(self):
        if self._sdc_pool is None:
            from deepspeed_tpu_torch.resilience.sdc import DigestPool

            self._sdc_pool = DigestPool(algo=self._sdc_algo, workers=2,
                                        defer_min=self._SDC_DEFER_MIN)
        return self._sdc_pool

    def _digest(self, arr: np.ndarray):
        from deepspeed_tpu_torch.resilience.sdc import digest

        return digest(arr, self._sdc_algo)

    def _expected(self, k: int):
        """Bucket ``k``'s write-side digest (joined from the side pool
        when still in flight)."""
        if self._sdc_pool is not None:
            d = self._sdc_pool.pop(("b", k))
            if d is not None:
                self._sums[k] = d
        return self._sums.get(k)

    def _invalidate(self) -> None:
        """The moments on disk can no longer be trusted against the
        master: every bucket restarts from zero moments."""
        self._ready.clear()
        self._sums.clear()
        if self._sdc_pool is not None:
            self._sdc_pool.close()
            self._sdc_pool = None

    def _quarantine(self, k: int) -> str:
        fname = self._fname(k)
        self.sdc_counters["quarantined"] += 1
        dst, n = fname + ".quarantine", 0
        while os.path.exists(dst):
            n += 1
            dst = f"{fname}.quarantine.{n}"
        try:
            os.rename(fname, dst)
        except OSError:
            dst = fname
        logger.error(f"NVMe swap: QUARANTINED corrupt swap file "
                     f"{os.path.basename(fname)} -> {os.path.basename(dst)}")
        return dst

    def _verify(self, k: int, view: np.ndarray, site: str,
                got=None) -> None:
        """Check bucket ``k``'s bytes just read (``got``: their digest, if
        taken already) against the digest of its write; on a mismatch
        re-read (``max_reread_retries`` times), then quarantine the file
        and raise :class:`SwapCorruptionError`."""
        if not self._sdc_verify:
            return
        expect = self._expected(k)
        if expect is None:
            return
        if (got if got is not None else self._digest(view)) == expect:
            self.sdc_counters["verified"] += 1
            return
        self.sdc_counters["mismatches"] += 1
        fname = self._fname(k)
        logger.error(f"NVMe swap: checksum MISMATCH on bucket {k} "
                     f"({os.path.basename(fname)}); re-reading (at most "
                     f"{self._sdc_rereads} times)")

        @retriable(attempts=self._sdc_rereads + 1,
                   retry_on=(SwapCorruptionError,))
        def reread():
            self.sdc_counters["rereads"] += 1
            self.handle.sync_pread(view, fname)
            action = faults.hook(site, path=fname)
            if action is not None and action[0] == "bitflip":
                faults.apply_bitflip(view, action[1])
            if self._digest(view) != expect:
                raise SwapCorruptionError(
                    f"bucket {k} ({os.path.basename(fname)}) failed its "
                    f"checksum ({self._sdc_algo}) on every re-read")

        try:
            reread()
        except SwapCorruptionError as err:
            self._quarantine(k)
            self._invalidate()
            from deepspeed_tpu_torch.telemetry import flight

            flight.dump_on_fault("swap_corruption", err,
                                 extra={"bucket": int(k),
                                        "file": os.path.basename(fname)})
            raise
        self.sdc_counters["reread_recovered"] += 1
        logger.warning(f"NVMe swap: bucket {k} re-read clean: transient "
                       "corruption recovered")

    # -- host slots --------------------------------------------------------

    @property
    def write_slot_count(self) -> int:
        return (max(1, self._buffer_count - 1) + 1 if self.pipeline_write
                else 1)

    def _ensure_host_slots(self) -> None:
        want = (self.slot_count, self.write_slot_count)
        if self._host_slots and self._host_slots[0]["count"] == want:
            return
        cap = max((b - a for a, b in self.buckets), default=0)
        owners: list = []

        def buf():
            return host_buffer(2 * cap, torch.float32, self.device,
                               zero=False, owners=owners)

        self._host_slots = [{"count": want, "owners": owners,
                             "read": [buf() for _ in range(want[0])],
                             "write": [buf() for _ in range(want[1])]}]

    @property
    def _rbufs(self):
        return self._host_slots[0]["read"]

    @property
    def _wbufs(self):
        return self._host_slots[0]["write"]

    # -- reads ------------------------------------------------------------

    def _issue_read(self, k: int) -> None:
        a, b = self.buckets[k]
        view = self._rbufs[k % len(self._rbufs)][:2 * (b - a)]
        op = None
        if k in self._ready:
            op = self.handle.async_pread(view.numpy(), self._fname(k))
        self._reads[k] = [op, view, False]

    def _join_read(self, k: int) -> None:
        """Wait for bucket ``k``'s read and start its digest on the side
        pool, so that the check rides the read-ahead window (the
        ``swap.read_bucket`` fault site fires here)."""
        ent = self._reads.get(k)
        if ent is None or ent[0] is None or ent[2]:
            return
        t0 = time.perf_counter()
        self.handle.wait(ent[0])
        self._t_in += time.perf_counter() - t0
        ent[2] = True
        arr = ent[1].numpy()
        self._bytes_read += arr.nbytes
        action = faults.hook("swap.read_bucket", path=self._fname(k))
        if action is not None and action[0] == "bitflip":
            faults.apply_bitflip(arr, action[1])
        if self._sdc_verify and arr.nbytes >= self._SDC_DEFER_MIN:
            self._pool().submit(("r", k), lambda: self._digest(arr))

    def _wait_read(self, k: int) -> Optional[torch.Tensor]:
        """Bucket ``k``'s ``[m; v]`` in its read slot, verified, or None
        when it has no file yet (zero moments)."""
        self._join_read(k)
        op, view, _ = self._reads.pop(k)
        if op is None:
            return None
        t0 = time.perf_counter()
        got = (self._sdc_pool.pop(("r", k)) if self._sdc_pool is not None
               else None)
        self._verify(k, view.numpy(), "swap.read_bucket", got=got)
        self._t_verify += time.perf_counter() - t0
        return view

    def _drop_reads(self) -> None:
        for k in list(self._reads):
            op, _, joined = self._reads.pop(k)
            if op is not None and not joined:
                try:
                    self.handle.wait(op)
                except OSError:
                    pass
            if self._sdc_pool is not None:
                self._sdc_pool.discard(("r", k))

    def start_prefetch(self) -> None:
        """Settle the previous step's deferred writes and start the first
        window's reads, so that they run under the backward the engine
        has just enqueued."""
        if self._reads or not self.pipeline_read or not self.buckets:
            return
        try:
            self._drain_writes()
        except Exception:      # logged and invalidated; step() zero-inits
            return
        self._apply_requested_buffer_count()
        self._ensure_host_slots()
        n = min(self.slot_count, len(self.buckets))
        for k in range(n):
            self._issue_read(k)
        self._prefetched = n

    def cancel_prefetch(self) -> None:
        self._drop_reads()
        self._prefetched = 0

    # -- writes -----------------------------------------------------------

    def _submit_write(self, k: int, arr: np.ndarray):
        from deepspeed_tpu_torch.io.aio import _pretruncate

        fname = self._fname(k)
        action = faults.hook("swap.write_bucket", path=fname)
        if action is not None and action[0] == "torn":
            with open(fname, "wb") as f:
                f.write(arr.tobytes()[:max(1, int(arr.nbytes * action[1]))])
            raise faults.SimulatedCrash(
                f"[fault-injection] torn bucket write at {fname}")
        _pretruncate(fname, arr.nbytes, exact=False)
        return self.handle.async_pwrite(arr, fname)

    def _rewrite(self, k: int, arr: np.ndarray) -> None:
        """The blocking retry behind a failed async write (a whole
        rewrite from offset 0, so every retry is safe)."""
        fname = self._fname(k)

        @retriable(retry_on=(OSError,))
        def write():
            faults.hook("swap.write_bucket", path=fname)
            self.handle.sync_pwrite(arr, fname)

        write()

    def _finish_write(self, k: int) -> None:
        """Join bucket ``k``'s write (retrying it through the blocking
        path if it failed) and its digest: its slot is free after."""
        op, arr = self._writes.pop(k)
        t0 = time.perf_counter()
        try:
            if op is None:
                self._rewrite(k, arr)
            else:
                try:
                    self.handle.wait(op)
                except OSError:
                    self._rewrite(k, arr)
        finally:
            self._expected(k)
            self._t_out += time.perf_counter() - t0

    def _drain_writes(self) -> None:
        """Join every write in flight (all of them, even after one
        fails); a failure means the moments on disk are stale against
        the master the step committed: invalidate and re-raise."""
        first = None
        for k in sorted(self._writes):
            try:
                self._finish_write(k)
            except BaseException as e:       # noqa: BLE001 (re-raised)
                first = first or e
        if first is not None:
            logger.error("NVMe swap: a bucket write-back failed after its "
                         "step: invalidating the swapped moments (they "
                         "restart from zero; reload the checkpoint to "
                         "recover them)")
            self._invalidate()
            raise first

    def synchronize(self) -> None:
        super().synchronize()
        self._drain_writes()

    def close(self) -> None:
        if getattr(self, "handle", None) is None:
            return
        self._drop_reads()
        try:
            self._drain_writes()
        except BaseException:          # noqa: BLE001 (closing anyway)
            pass
        if self._sdc_pool is not None:
            self._sdc_pool.close()
            self._sdc_pool = None
        super().close()
        self._host_slots = []
        self.handle.close()
        self.handle = None
        shutil.rmtree(self.swap_dir, ignore_errors=True)
        try:
            atexit.unregister(self._atexit)
        except Exception:                # noqa: BLE001
            pass

    # -- the step's hooks ---------------------------------------------------

    def _begin_step(self) -> None:
        prefetched = self._prefetched
        self._prefetched = 0
        try:
            self._drain_writes()
        except BaseException:
            self._drop_reads()
            raise
        if not prefetched:
            self._drop_reads()
            self._apply_requested_buffer_count()
        self._ensure_host_slots()
        self._t_in = self._t_out = self._t_verify = self._t_up = 0.0
        self._bytes_read = self._written = 0
        self._drained: Dict[int, object] = {}   # bucket -> its d2h event

    def _open_stream(self) -> None:
        for k in range(min(self.slot_count, len(self.buckets))):
            if k not in self._reads:
                self._issue_read(k)

    def _moments_in(self, k: int):
        mv = self._wait_read(k)
        return None if mv is None else (mv,)

    def _moments_out(self, k: int):
        if len(self._slots) > 1 and k > 0:
            self._write_back(k - 1)          # under bucket k's update
        wb = self._wbufs
        if k - len(wb) in self._writes:
            self._finish_write(k - len(wb))  # its slot is bucket k's
        a, b = self.buckets[k]
        return (wb[k % len(wb)][:2 * (b - a)],)

    def _copied_back(self, k: int) -> None:
        st = self._streams
        ev = st.event()
        st.record(ev, "d2h")
        self._drained[k] = ev
        if len(self._slots) == 1:
            self._write_back(k)
        elif k + 1 < len(self.buckets):
            self._join_read(k + 1)           # under bucket k's update

    def _close_stream(self) -> None:
        if len(self._slots) > 1 and self.buckets:
            self._write_back(len(self.buckets) - 1)
        if not self.pipeline_write:
            self._drain_writes()

    def _write_back(self, f: int) -> None:
        """Bucket ``f`` is on its way back to host RAM: once there, write
        its moments out and start the read that takes its slot."""
        ev = self._drained.pop(f)
        t0 = time.perf_counter()
        if ev is not None:
            ev.synchronize()
        self._t_up += time.perf_counter() - t0
        a, b = self.buckets[f]
        arr = self._wbufs[f % len(self._wbufs)][:2 * (b - a)].numpy()
        try:
            op = self._submit_write(f, arr)
        except OSError:
            op = None
        self._writes[f] = (op, arr)
        if self._sdc_verify:
            self._sums.pop(f, None)
            d = self._pool().note(("b", f), arr)
            if d is not None:
                self._sums[f] = d
        self._written += arr.nbytes
        if not self.pipeline_write:
            self._finish_write(f)
        self._ready.add(f)
        if f + len(self._slots) < len(self.buckets):
            self._issue_read(f + len(self._slots))

    def _abort_step(self) -> None:
        self._drop_reads()
        for f in list(self._writes):
            try:
                self._finish_write(f)
            except BaseException:    # noqa: BLE001
                pass
        logger.error("NVMe optimizer step failed mid-stream: the moments on "
                     "disk are ahead of the master; invalidating them (they "
                     "restart from zero; reload the checkpoint to recover "
                     "them)")
        self._invalidate()

    def _record_stats(self, total: float, pipelined: bool) -> None:
        tt = self.stage_timers
        tt.reset()
        for name, secs in (("swap_in_wait", self._t_in),
                           ("bucket_update", self._t_up),
                           ("swap_out_wait", self._t_out),
                           ("swap_verify", self._t_verify),
                           ("apply", total)):
            tt.add(name, secs)
        moved = self._bytes_read + self._written
        tt.count("bytes_read", int(self._bytes_read))
        tt.count("bytes_written", int(self._written))
        tt.count("buckets", len(self.buckets))
        self.stage_stats = {
            **tt.snapshot(),
            "overlap_efficiency": (round(1.0 - min(1.0, (
                self._t_in + self._t_out) / total), 4) if total > 0
                else None),
            "stream_gbps": (round(moved / total / 1e9, 3) if total > 0
                            else None),
            "pipelined": pipelined, "sdc": dict(self.sdc_counters)}

    # -- the moments outside the step: a checkpoint's, a bucket at a time ---

    def read_bucket(self, k: int) -> torch.Tensor:
        """Bucket ``k``'s ``[m; v]`` read from its file and verified, in a
        new host tensor (zeros when it has no file yet)."""
        self.synchronize()
        a, b = self.buckets[k]
        buf = torch.zeros(2 * (b - a), dtype=torch.float32)
        if k in self._ready:
            arr = buf.numpy()
            self.handle.sync_pread(arr, self._fname(k))
            action = faults.hook("swap.read_item", path=self._fname(k))
            if action is not None and action[0] == "bitflip":
                faults.apply_bitflip(arr, action[1])
            self._verify(k, arr, "swap.read_item")
        return buf

    def begin_load(self) -> None:
        """Before a checkpoint load writes the files: the moments on disk
        are stale against the master being loaded."""
        self.synchronize()
        self._drop_reads()
        self._invalidate()

    def write_bucket(self, k: int, buf: torch.Tensor) -> None:
        """Bucket ``k``'s file from ``buf``, its ``[m; v]`` (a checkpoint
        load)."""
        arr = buf.numpy()
        fname = self._fname(k)

        @retriable(retry_on=(OSError,))
        def write():
            faults.hook("swap.write_item", path=fname)
            self.handle.sync_pwrite(arr, fname)

        write()
        if self._sdc_verify:
            self._sums[k] = self._digest(arr)
        self._ready.add(k)


class MomentFiles:
    """The NVMe tier's moments for one checkpoint save or load, one
    bucket in host memory at a time.  The engine cuts its moment pieces
    at the buckets' bounds and orders them bucket by bucket, so a save
    reads each bucket's file once (:meth:`read`) and a load writes each
    once, when it moves on to the next bucket or :meth:`flush` is
    called (:meth:`fill`)."""

    def __init__(self, swapper: NvmeOptimizerSwapper):
        self.sw = swapper
        self.k: Optional[int] = None
        self.buf: Optional[torch.Tensor] = None
        self.dirty = False
        self.loading = False

    def read(self, k: int, lo: int, hi: int) -> torch.Tensor:
        """Elements ``[lo, hi)`` of bucket ``k``'s ``[m; v]``."""
        if self.k != k:
            self.k, self.buf = k, self.sw.read_bucket(k)
        return self.buf[lo:hi]

    def fill(self, k: int, lo: int, data: torch.Tensor) -> None:
        """Elements ``[lo, lo + len(data))`` of bucket ``k``'s ``[m; v]``
        (the rest of the bucket, the shard's padding, stays zero)."""
        if not self.loading:
            self.sw.begin_load()
            self.loading = True
        if self.k != k:
            self.flush()
            a, b = self.sw.buckets[k]
            self.k = k
            self.buf = torch.zeros(2 * (b - a), dtype=torch.float32)
        self.buf[lo:lo + data.numel()].copy_(data)
        self.dirty = True

    def flush(self) -> None:
        if self.dirty:
            self.sw.write_bucket(self.k, self.buf)
        self.k, self.buf, self.dirty = None, None, False
