"""Communication facade over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/comm/comm.py`` (the reference's
``deepspeed/comm/comm.py``).  The reference runs one controller over a
mesh and gives eager inputs a leading dimension of the group size; here
every rank runs its own process and passes its own tensor, as in
``torch.distributed``.  Names and keyword arguments are the reference's
where they mean the same thing:

- ``group=`` takes axis names of the topology (``"data"``,
  ``("data", "data_sub")``, ...), as the reference's ``_resolve_axes``;
  ``None`` means every axis wider than 1;
- ``all_gather(x, axis=, tiled=)``: tiled concatenates the members'
  tensors along ``axis``, untiled stacks them on a new ``axis``;
- ``reduce_scatter(x, axis=)``: the sum (or mean) of the members'
  tensors, cut into ``group size`` pieces along ``axis``, piece ``i`` to
  member ``i``;
- ``all_to_all(x, split_axis=, concat_axis=)``, ``broadcast(x, src=)``
  (``src`` is the member's index in the group), ``ppermute(x, perm)``.

``all_reduce`` and ``broadcast`` work in place and return their input;
the others return a new tensor, or fill ``out=`` where they take one.

The backend is NCCL for CUDA tensors and gloo for CPU tensors; asking for
NCCL without a GPU raises.  Without an initialised process group the
world is one process and every collective is a local copy.

``backend_calls`` counts, by log name, the collectives that went through
a ``torch.distributed`` group (and not a local copy), whether or not the
logger is enabled: a caller reads it to show that its collectives really
ran over the backend.

Every call is recorded by the ``CommsLogger`` while it is enabled
(``comms_logger`` in the config), runs under the collective watchdog when
one is armed (``comm/watchdog.py``), and is a fault-injection site
(``comm.<op>``: straggle, drop, corrupt; ``resilience/faults.py``).
"""
from __future__ import annotations

import collections
import datetime
import os
import time
from typing import Callable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.distributed as dist

from deepspeed_tpu_torch.comm import watchdog as _watchdog
from deepspeed_tpu_torch.comm.comms_logging import CommsLogger, EventPair
from deepspeed_tpu_torch.parallel.topology import (AXIS_ORDER, DATA_AXIS,
                                                   Group, MeshTopology)
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.utils.logging import log_dist, logger

GroupLike = Union[None, str, Tuple[str, ...], Sequence[str]]

comms_logger = CommsLogger()
backend_calls: collections.Counter = collections.Counter()

# torch renamed the tensor forms of all-gather and reduce-scatter; take the
# name this torch has (the older one is deprecated where both exist)
_ALL_GATHER = (dist.all_gather_single if hasattr(dist, "all_gather_single")
               else dist.all_gather_into_tensor)
_REDUCE_SCATTER = (dist.reduce_scatter_single
                   if hasattr(dist, "reduce_scatter_single")
                   else dist.reduce_scatter_tensor)

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "avg": dist.ReduceOp.SUM,
               "mean": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}


class _CommState:
    initialized: bool = False
    topology: Optional[MeshTopology] = None
    local_rank: int = 0


_state = _CommState()


# ---------------------------------------------------------------------------
# Bootstrap (reference: init_distributed comm.py:625)
# ---------------------------------------------------------------------------


def init_distributed(dist_backend: Optional[str] = None,
                     init_method: Optional[str] = None,
                     rank: int = -1,
                     world_size: int = -1,
                     timeout: Optional[float] = None,
                     device: Optional[str] = None) -> None:
    """Initialise the default process group.

    ``dist_backend``: ``"nccl"`` (CUDA tensors) or ``"gloo"`` (CPU
    tensors); by default ``gloo`` when ``device="cpu"`` and ``nccl``
    otherwise.  NCCL without a GPU raises.  ``rank``, ``world_size`` and
    ``init_method`` (``tcp://host:port``, ``file:///path``) come from the
    caller, else from the ``RANK`` / ``WORLD_SIZE`` / ``MASTER_ADDR`` /
    ``MASTER_PORT`` environment that ``torchrun`` sets (``env://``); a
    world of one needs neither.  ``LOCAL_RANK`` (default: ``rank``) picks
    this rank's GPU.  ``timeout`` is in seconds.  A process group the
    caller initialised already is adopted as it is."""
    if _state.initialized:
        return
    env = os.environ
    if not dist.is_initialized():
        rank = rank if rank >= 0 else int(env.get("RANK", 0))
        world_size = world_size if world_size > 0 else int(
            env.get("WORLD_SIZE", 1))
        if dist_backend is None:
            dist_backend = "gloo" if device == "cpu" else "nccl"
        if dist_backend == "nccl" and not torch.cuda.is_available():
            raise RuntimeError(
                "the nccl backend needs a CUDA GPU and none is available; "
                "pass dist_backend='gloo' (device='cpu') to run on the CPU")
        local_rank = int(env.get("LOCAL_RANK", rank))
        if dist_backend == "nccl":
            torch.cuda.set_device(local_rank)
        kw = {}
        if init_method is None and "MASTER_ADDR" not in env:
            if world_size != 1:
                raise ValueError(
                    f"world_size={world_size} needs an init_method or the "
                    "MASTER_ADDR/MASTER_PORT environment")
            kw["store"] = dist.HashStore()
        else:
            kw["init_method"] = init_method or "env://"
        if timeout is not None:
            kw["timeout"] = datetime.timedelta(seconds=timeout)
        dist.init_process_group(dist_backend, rank=rank,
                                world_size=world_size, **kw)
        log_dist(f"torch.distributed initialised: backend={dist_backend} "
                 f"world_size={world_size}", ranks=[0])
    _state.local_rank = int(env.get("LOCAL_RANK", dist.get_rank()))
    _state.topology = None          # one laid out before had no group
    _state.initialized = True


def is_initialized() -> bool:
    return _state.initialized


def get_backend_name() -> Optional[str]:
    """The default process group's backend, or None without one."""
    return dist.get_backend() if dist.is_initialized() else None


def destroy_process_group() -> None:
    """Tear down the default process group and forget the topology."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _state.initialized = False
    _state.topology = None


def initialize_mesh(dp: Optional[int] = None, tp: int = 1, pp: int = 1,
                    sp: int = 1, ep: int = 1,
                    hpz: int = 1) -> MeshTopology:
    """Lay the ranks out on the parallelism axes and install the topology
    (reference ``initialize_mesh``; ``hpz`` splits the data axis for the
    hpZ secondary partition).  Collective: every rank calls it."""
    topo = MeshTopology(dp=dp, tp=tp, pp=pp, sp=sp, ep=ep, hpz=hpz)
    _state.topology = topo
    return topo


def set_topology(topology: MeshTopology) -> None:
    _state.topology = topology


def get_topology() -> MeshTopology:
    if _state.topology is None:
        initialize_mesh()
    return _state.topology


def peek_topology() -> Optional[MeshTopology]:
    """The installed topology, or None (never installs a default)."""
    return _state.topology


def get_mesh() -> np.ndarray:
    """The global rank at each coordinate of the topology's axes (the
    counterpart of the reference's ``mesh.devices``)."""
    return get_topology().ranks


def get_world_size(group: GroupLike = None) -> int:
    topo = get_topology()
    return int(np.prod([topo.axis_size(a) for a in _resolve_axes(group)]))


def get_rank() -> int:
    """This process's rank in the default group."""
    return dist.get_rank() if dist.is_initialized() else 0


def get_local_rank() -> int:
    return _state.local_rank


def get_process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def barrier(group: GroupLike = None) -> None:
    """Synchronise the group's processes (fault site ``comm.barrier``:
    straggle delays this rank, drop skips it so peers stall)."""
    directive = faults.hook("comm.barrier")
    if directive is not None:
        if directive[0] == "straggle":
            time.sleep(directive[1])
        elif directive[0] == "drop":
            logger.error("[fault-injection] comm.barrier: dropped on rank "
                         f"{get_rank()} — peers will stall")
            return
    g = _group(group)
    if g.pg is None:
        return
    t0 = time.perf_counter()
    _watchdog.guard(lambda: dist.barrier(group=g.pg), what="comm.barrier")
    backend_calls["barrier"] += 1
    comms_logger.append("barrier", 0, g.size, time.perf_counter() - t0)


# ---------------------------------------------------------------------------
# Groups
# ---------------------------------------------------------------------------


def _resolve_axes(group: GroupLike) -> Tuple[str, ...]:
    if group is None:
        topo = _state.topology
        if topo is None:
            return tuple(AXIS_ORDER)
        return tuple(a for a in AXIS_ORDER
                     if topo.axis_size(a) > 1) or (DATA_AXIS,)
    if isinstance(group, str):
        return (group,)
    return tuple(group)


def _group(group: GroupLike) -> Group:
    return get_topology().group(_resolve_axes(group))


def axis_index(group: GroupLike = None) -> int:
    """This rank's index within ``group``."""
    return _group(group).rank


def _nbytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _collective(kind: str, op_name: str, result: torch.Tensor,
                nbytes: int, g: Group, run: Callable[[], None],
                log_name: str) -> bool:
    """Run one collective: the fault site, the watchdog, the logger.
    Returns False when a fault directive dropped it on this rank."""
    directive = faults.hook(f"comm.{kind}")
    if directive is not None:
        if directive[0] == "straggle":
            logger.warning(f"[fault-injection] comm.{kind}: straggling "
                           f"{directive[1]:.3f}s on rank {get_rank()}")
            time.sleep(directive[1])
        elif directive[0] == "drop":
            logger.error(f"[fault-injection] comm.{kind}: dropped on rank "
                         f"{get_rank()} — peers will stall in it")
            return False
    timed = comms_logger.should_profile(op_name)
    if timed and result.is_cuda:
        start = torch.cuda.Event(enable_timing=True)
        start.record()
    t0 = time.perf_counter()
    if g.pg is None:
        run()
    else:
        _watchdog.guard(run, what=f"comm.{kind}")
        backend_calls[log_name] += 1
    if timed:
        if result.is_cuda:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
            latency = EventPair(start, end)
        else:
            latency = time.perf_counter() - t0
        comms_logger.append(op_name, nbytes, g.size, latency, log_name)
    if directive is not None and directive[0] == "corrupt":
        logger.error(f"[fault-injection] comm.{kind}: corrupting "
                     f"{directive[1]:.2f} of the result on rank "
                     f"{get_rank()}")
        flat = result.view(-1)
        k = max(1, int(flat.numel() * directive[1]))
        flat[:k] = flat[:k] * 1024.0 + 1.0
    return True


# ---------------------------------------------------------------------------
# Collectives
# ---------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, op: str = "sum", group: GroupLike = None,
               log_name: str = "all_reduce") -> torch.Tensor:
    """Reduce ``x`` across the group in place (``sum``, ``avg``/``mean``,
    ``max``, ``min``); every member ends with the result."""
    g = _group(group)

    def run():
        if g.pg is not None:
            dist.all_reduce(x, op=_REDUCE_OPS[op], group=g.pg)
        if op in ("avg", "mean"):
            x.div_(g.size)

    _collective("all_reduce", "all_reduce", x, _nbytes(x), g, run, log_name)
    return x


def inference_all_reduce(x: torch.Tensor, group: GroupLike = None
                         ) -> torch.Tensor:
    return all_reduce(x, "sum", group, log_name="inference_all_reduce")


def all_gather(x: torch.Tensor, group: GroupLike = None, axis: int = 0,
               tiled: bool = True, out: Optional[torch.Tensor] = None,
               log_name: str = "all_gather") -> torch.Tensor:
    """Gather every member's ``x`` (equal shapes), in member order:
    concatenated along ``axis`` (``tiled``) or stacked on a new ``axis``.
    ``out`` (axis 0, tiled only): a contiguous ``[size * x.shape[0],
    ...]`` tensor to gather into (the reference's
    ``all_gather_into_tensor``)."""
    g = _group(group)
    x = x.contiguous()
    if out is None:
        out = x.new_empty((g.size * x.shape[0],) + tuple(x.shape[1:])) \
            if x.dim() else x.new_empty(g.size)
    elif axis != 0 or not tiled:
        raise ValueError("all_gather: out= takes axis=0, tiled=True")

    def run():
        if g.pg is not None:
            _ALL_GATHER(out, x, group=g.pg)
        else:
            out.copy_(x.reshape(out.shape))

    _collective("all_gather", "all_gather_into_tensor", out, _nbytes(out),
                g, run, log_name)
    if axis == 0 and tiled:
        return out
    parts = out.view((g.size,) + tuple(x.shape))
    if tiled:
        return torch.cat(parts.unbind(0), dim=axis)
    return parts.movedim(0, axis)


def reduce_scatter(x: torch.Tensor, op: str = "sum", group: GroupLike = None,
                   axis: int = 0, out: Optional[torch.Tensor] = None,
                   log_name: str = "reduce_scatter") -> torch.Tensor:
    """Reduce every member's ``x`` and give member ``i`` the ``i``-th of
    ``group size`` equal pieces along ``axis`` (the reference's
    ``reduce_scatter_tensor``).  ``out`` (axis 0 only): the contiguous
    tensor to write the piece into."""
    g = _group(group)
    if x.shape[axis] % g.size:
        raise ValueError(f"reduce_scatter: dim {axis} of {tuple(x.shape)} "
                         f"does not split into {g.size} pieces")
    src = x.movedim(axis, 0).contiguous()
    shape = (src.shape[0] // g.size,) + tuple(src.shape[1:])
    if out is None:
        out = src.new_empty(shape)
    elif axis != 0 or tuple(out.shape) != shape:
        raise ValueError(f"reduce_scatter: out= must be {shape} at axis 0")

    def run():
        if g.pg is not None:
            _REDUCE_SCATTER(out, src, op=_REDUCE_OPS[op], group=g.pg)
        else:
            out.copy_(src)
        if op in ("avg", "mean"):
            out.div_(g.size)

    _collective("reduce_scatter", "reduce_scatter_tensor", out,
                _nbytes(src), g, run, log_name)
    return out.movedim(0, axis)


def all_to_all(x: torch.Tensor, group: GroupLike = None,
               split_axis: int = 0, concat_axis: int = 0,
               tiled: bool = True,
               log_name: str = "all_to_all") -> torch.Tensor:
    """Cut ``x`` into ``group size`` pieces along ``split_axis``, send
    piece ``j`` to member ``j``, and concatenate the pieces received
    along ``concat_axis`` in member order (the reference's
    ``all_to_all_single``, tiled)."""
    if not tiled:
        raise NotImplementedError("all_to_all: only the tiled form")
    g = _group(group)
    if len(_resolve_axes(group)) != 1:
        raise ValueError("all_to_all requires a single axis")
    if x.shape[split_axis] % g.size:
        raise ValueError(f"all_to_all: dim {split_axis} of "
                         f"{tuple(x.shape)} does not split into {g.size}")
    src = x.movedim(split_axis, 0).contiguous()
    recv = torch.empty_like(src)

    def run():
        if g.pg is not None:
            dist.all_to_all_single(recv, src, group=g.pg)
        else:
            recv.copy_(src)

    _collective("all_to_all", "all_to_all_single", recv, _nbytes(src), g,
                run, log_name)
    pieces = recv.view((g.size, src.shape[0] // g.size) +
                       tuple(src.shape[1:]))
    return torch.cat([p.movedim(0, split_axis) for p in pieces.unbind(0)],
                     dim=concat_axis)


def ppermute(x: torch.Tensor, perm, group: GroupLike = None,
             log_name: str = "ppermute") -> torch.Tensor:
    """Point-to-point permute over one axis: for each ``(i, j)`` in
    ``perm`` member ``i`` sends ``x`` to member ``j``; a member that
    receives nothing gets zeros (``lax.ppermute`` semantics)."""
    g = _group(group)
    if len(_resolve_axes(group)) != 1:
        raise ValueError("ppermute requires a single axis")
    x = x.contiguous()
    out = torch.zeros_like(x)
    sends = [j for i, j in perm if i == g.rank]
    recvs = [i for i, j in perm if j == g.rank]

    def run():
        ops = []
        for j in sends:
            if j == g.rank:
                out.copy_(x)
            else:
                ops.append(dist.P2POp(dist.isend, x, g.ranks[j], g.pg))
        for i in recvs:
            if i != g.rank:
                ops.append(dist.P2POp(dist.irecv, out, g.ranks[i], g.pg))
        if ops:
            for work in dist.batch_isend_irecv(ops):
                work.wait()

    _collective("ppermute", "ppermute", out, _nbytes(x), g, run, log_name)
    return out


def broadcast(x: torch.Tensor, src: int = 0, group: GroupLike = None,
              log_name: str = "broadcast") -> torch.Tensor:
    """Member ``src``'s ``x`` to every member of the group, in place."""
    g = _group(group)

    def run():
        if g.pg is not None:
            dist.broadcast(x, src=g.ranks[src], group=g.pg)

    _collective("broadcast", "broadcast", x, _nbytes(x), g, run, log_name)
    return x


def broadcast_object(obj, src: int = 0):
    """A picklable object from global rank ``src`` to every rank."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def quantized_all_gather(*args, **kwargs):
    raise NotImplementedError("quantized (ZeRO++) collectives are not "
                              "ported yet: ROADMAP A11")


quantized_reduce_scatter = quantized_all_gather


# ---------------------------------------------------------------------------
# Summaries
# ---------------------------------------------------------------------------


def straggler_report(min_spread_s: float = 0.020,
                     min_ratio: float = 2.0) -> dict:
    """Gather every process's mean collective latencies and name the rank
    peers wait for (``resilience/distributed.py``); one small
    ``all_gather_object``."""
    from deepspeed_tpu_torch.resilience.distributed import (
        allgather_json, build_straggler_report)

    per_rank = allgather_json(comms_logger.per_op_mean_latency())
    return build_straggler_report(per_rank, min_spread_s=min_spread_s,
                                  min_ratio=min_ratio)


def log_summary(show_straggler: bool = False) -> str:
    """Print the comms table (reference ``comm.py:428``); with
    ``show_straggler`` and more than one process, the cross-rank
    straggler report too (a collective: every rank calls it)."""
    out = comms_logger.log_summary(show_straggler=show_straggler)
    if show_straggler and get_process_count() > 1:
        section = comms_logger.render_straggler_report(straggler_report())
        logger.info("\n" + section)
        out = out + "\n" + section
    return out


def configure(comms_config=None) -> None:
    if comms_config is not None:
        comms_logger.configure(comms_config)


__all__: List[str] = [
    "init_distributed", "is_initialized", "initialize_mesh",
    "set_topology", "get_topology", "peek_topology", "get_mesh",
    "get_world_size", "get_rank", "get_local_rank", "get_process_count",
    "barrier", "all_reduce", "inference_all_reduce", "all_gather",
    "reduce_scatter", "all_to_all", "ppermute", "broadcast", "axis_index",
    "log_summary", "straggler_report", "configure", "comms_logger",
    "backend_calls", "quantized_all_gather", "quantized_reduce_scatter",
    "broadcast_object", "destroy_process_group", "get_backend_name"]
