"""ZeRO as partitions of the engine's flat buffers.

Counterpart of ``deepspeed_tpu/runtime/zero.py``.  The reference states the
three stages as per-leaf sharding layouts and lets XLA emit the
collectives; the port keeps its state in flat buffers (``runtime/
engine.py``) and partitions those by hand, as the reference DeepSpeed's
``stage_1_and_2.py`` and ``stage3.py`` do:

- stage 1: the fp32 master weights and the optimizer moments;
- stage 2: also the fp32 gradient accumulator, each unit's gradient
  reduce-scattered into it as soon as its backward is done;
- stage 3: also the compute-dtype working copy, each unit all-gathered
  just before its forward and again before its backward, and released
  after each (FSDP).

**Layout.**  The leaves, in the engine's order, are cut into *gather
units*: one per decoder block (a run of leaves named ``...layers.<i>.``,
``...h.<i>.`` or ``...blocks.<i>.``) and one for each run of other leaves
(for Llama: the embedding, and the final norm with the head).  Each unit
is padded to a multiple of ``world x ALIGN`` elements and cut into
``world`` equal slices.  A rank's *shard* is the concatenation of its
slice of every unit, so the optimizer stays one fused launch per step
over the shard.

**Persistence threshold.**  At stage 3, a leaf of at most
``stage3_param_persistence_threshold`` elements, or none of whose
dimensions the parameter partition count divides, keeps its working copy
whole on every rank, as the reference's ``leaf_spec`` keeps it
replicated.  Those leaves form one more unit, ``persistent``, last in the
layout, gathered once after each step and never released; their master
and moments are partitioned like every other unit's.

**hpZ.**  With ``zero_hpz_partition_size`` = h > 1 at stage 3, the data
extent W splits into D = W/h ``data`` x h ``data_sub`` (rank = d*h + s).
The working copy is partitioned over ``data_sub`` only: rank (d, s)
keeps the s-th of h pieces of each unit, and gathers a unit from its h
``data_sub`` peers (consecutive ranks).  Gradients and optimizer state
keep the full W-way partition: rank (d, s) owns slice s*D + d of each
unit, which lies inside its working-copy piece, so a reduce-scatter over
``data_sub`` and then over ``data`` delivers it, and a gather over
``data`` refreshes the working-copy piece after a step.
"""
from __future__ import annotations

import dataclasses
import math
import re
import weakref
from typing import Dict, Iterable, List, Sequence, Tuple

import torch

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.checkpoint.reshard import ALIGN, padded_unit_size

_BLOCK = re.compile(r"^(.*?(?:^|\.)(?:layers|h|blocks)\.\d+)\.")

PERSISTENT = "persistent"


def gather_units(names: Sequence[str]) -> List[Tuple[str, List[int]]]:
    """``[(unit name, leaf indices)]``: consecutive leaves of one decoder
    block form a unit named by the block's module path; each run of other
    consecutive leaves forms one unit named by its modules' paths."""
    units: List[Tuple[str, List[int]]] = []
    prev = object()
    for i, name in enumerate(names):
        m = _BLOCK.match(name)
        key = m.group(1) if m else None
        if key != prev or not units:
            units.append((key, []))
        units[-1][1].append(i)
        prev = key
    out = []
    for key, idx in units:
        if key is None:
            mods = dict.fromkeys(names[i].rpartition(".")[0] or names[i]
                                 for i in idx)
            key = "+".join(mods)
        out.append((key, idx))
    return out


@dataclasses.dataclass
class Unit:
    """One gather unit of the layout."""

    name: str
    leaves: List[int]            # leaf indices, in layout order
    leaf_offsets: List[int]      # each leaf's start inside the unit
    numel: int                   # elements of the leaves
    padded: int                  # a multiple of world x ALIGN
    offset: int                  # start in the full layout
    chunk: int                   # elements of one rank's slice
    shard_offset: int            # start of the slice in a rank's shard
    param_offset: int            # start of the working-copy piece (stage 3)
    persistent: bool


class ZeroPartitionPlan:
    """The partition of the engine's flat buffers at one stage, world
    size and rank.

    ``names``/``shapes``: the leaves in the engine's order.  ``world``:
    the data extent (``data`` x ``data_sub`` ranks); ``rank``: this
    rank's index in it; ``hpz``: ``zero_hpz_partition_size`` (used at
    stage 3 only, as in the reference)."""

    def __init__(self, names: Sequence[str], shapes: Sequence[Tuple],
                 stage: int, world: int = 1, rank: int = 0, hpz: int = 1,
                 persistence_threshold: int = 100_000, align: int = ALIGN):
        if stage not in (1, 2, 3):
            raise ValueError(f"a partition plan is for stages 1-3, not "
                             f"{stage}")
        self.stage = stage
        self.world = world
        self.rank = rank
        self.hpz = hpz if stage >= 3 else 1
        if world % self.hpz:
            raise ValueError(f"zero_hpz_partition_size={hpz} does not "
                             f"divide the data extent {world}")
        self.persistence_threshold = persistence_threshold
        d, s = divmod(rank, self.hpz)
        # which slice of every unit this rank's shard holds, and which
        # piece of it its working copy keeps at stage 3
        self.slice_index = s * (world // self.hpz) + d
        self.param_world = self.hpz if self.hpz > 1 else world
        self.param_index = s if self.hpz > 1 else rank
        self.names = list(names)
        self.shapes = [tuple(x) for x in shapes]
        self.numels = [math.prod(x) for x in self.shapes]
        self.partitioned = [stage >= 3 and self._partitions_leaf(x)
                            for x in self.shapes]

        groups = []
        for name, idx in gather_units(self.names):
            idx = [i for i in idx if stage < 3 or self.partitioned[i]]
            if idx:
                groups.append((name, idx, False))
        persistent = [i for i in range(len(self.names))
                      if stage >= 3 and not self.partitioned[i]]
        if persistent:
            groups.append((PERSISTENT, persistent, True))

        self.units: List[Unit] = []
        offset = shard = param = 0
        for name, idx, pers in groups:
            offs = [0]
            for i in idx:
                offs.append(offs[-1] + self.numels[i])
            padded = padded_unit_size(offs[-1], world, align)
            self.units.append(Unit(
                name=name, leaves=idx, leaf_offsets=offs[:-1],
                numel=offs[-1], padded=padded, offset=offset,
                chunk=padded // world, shard_offset=shard,
                param_offset=param, persistent=pers))
            offset += padded
            shard += padded // world
            if not pers:
                param += padded // self.param_world
        self.n_full = offset
        self.n_shard = shard
        self.n_param = param
        self.unit_of = {}
        for u, unit in enumerate(self.units):
            for i in unit.leaves:
                self.unit_of[i] = u

    def _partitions_leaf(self, shape: Tuple[int, ...]) -> bool:
        """The reference's ``leaf_spec`` rule: a leaf is partitioned when
        it holds more than the threshold and the partition count divides
        one of its dimensions."""
        return (len(shape) > 0 and
                math.prod(shape) > self.persistence_threshold and
                any(d % self.param_world == 0 for d in shape))

    # -- per-rank ranges ------------------------------------------------

    @property
    def regular_units(self) -> List[Unit]:
        return [u for u in self.units if not u.persistent]

    @property
    def persistent_unit(self):
        return next((u for u in self.units if u.persistent), None)

    def slice_start(self, unit: Unit) -> int:
        """Start, in the full layout, of this rank's slice of ``unit``."""
        return unit.offset + self.slice_index * unit.chunk

    def leaf_start(self, i: int) -> int:
        """Start of leaf ``i`` in the full layout."""
        unit = self.units[self.unit_of[i]]
        return unit.offset + unit.leaf_offsets[unit.leaves.index(i)]

    def leaf_pieces(self) -> List[Tuple[int, int, int, int]]:
        """``[(leaf, lo, hi, shard position)]``: the elements ``[lo, hi)``
        of each leaf that this rank's shard holds, and where."""
        out = []
        for unit in self.units:
            s0 = self.slice_start(unit)
            s1 = s0 + unit.chunk
            for i, off in zip(unit.leaves, unit.leaf_offsets):
                a = unit.offset + off
                lo, hi = max(a, s0), min(a + self.numels[i], s1)
                if lo < hi:
                    out.append((i, lo - a, hi - a,
                                unit.shard_offset + lo - s0))
        return out

    # -- bookkeeping ----------------------------------------------------

    def step_collectives(self, gas: int) -> Dict[str, int]:
        """The collectives one ``train_batch`` of ``gas`` micro-batches
        issues, by the engine's log name."""
        n_units = len(self.units)
        hops = 2 if self.hpz > 1 else 1      # hpZ: data_sub, then data
        out = {"step_stats": 1}
        if self.stage == 1:
            out["grad_reduce_scatter"] = n_units
            out["weight_gather"] = n_units
        elif self.stage == 2:
            out["grad_reduce_scatter"] = n_units * gas
            out["weight_gather"] = n_units
        else:
            regular = len(self.regular_units)
            out["param_gather"] = 2 * regular * gas
            out["grad_reduce_scatter"] = hops * n_units * gas
            gathers = (regular if self.hpz > 1 else 0) + \
                (hops if self.persistent_unit is not None else 0)
            if gathers:
                out["weight_gather"] = gathers
        return out

    def describe(self) -> str:
        sharded = [i for i in range(len(self.names)) if self.partitioned[i]]
        numel = sum(self.numels)
        frac = sum(self.numels[i] for i in sharded) / max(numel, 1)
        hpz = f", working copy over data_sub={self.hpz}" \
            if self.hpz > 1 else ""
        return (f"ZeRO stage {self.stage}: {len(sharded)}/"
                f"{len(self.names)} param tensors sharded over "
                f"('data', 'data_sub') ({self.world} partitions{hpz}), "
                f"{frac:.0%} of param bytes; {len(self.units)} gather "
                f"units, shard {self.n_shard} of {self.n_full} elements "
                f"({numel} unpadded)")


# ---------------------------------------------------------------------------
# The partitioned buffers of one rank and the collectives that keep them
# ---------------------------------------------------------------------------

EXTENT = ("data", "data_sub")        # the ZeRO partition's axes


class ZeroBuffers:
    """One rank's flat state at stages 1-3 (``plan`` says which), filled
    from ``sources``: each leaf's starting values whole (any device and
    floating dtype), in leaf order, on rank 0 of the data extent, taken
    one at a time (an iterator may make each as it is asked for).  A
    leaf is broadcast from rank 0 and this rank keeps its pieces of it,
    so no rank holds more than one whole leaf of the fp32 weights here.

    - ``p``, ``g``: the fp32 master shard and gradient shard
      (``plan.n_shard``); the optimizer's moments are made over ``p``;
    - ``w_shard``: the compute-dtype copy of the shard the optimizer
      writes (``p`` itself in fp32);
    - stages 1-2: ``flat_w``, the whole working copy (``plan.n_full``),
      gathered from every rank's ``w_shard`` after each step; stage 1
      also keeps the whole gradient, ``flat_gw`` (compute dtype, the
      leaves' ``.grad``) and its fp32 sum ``flat_g``;
    - stage 3: one buffer per regular unit, whose storage is allocated
      only while the unit is gathered (at construction, one unit at a
      time, long enough to cut its leaves' views); ``w_pers``, the
      persistent unit's whole working copy; and under hpZ ``w_pshard``,
      this rank's ``data_sub`` piece of every regular unit.

    ``micro`` (the micro-batch index) and ``in_backward`` are set by the
    engine around each backward.

    With an offload tier (``runtime/swap_tensor.py``) ``master`` is the
    tier's host tensor for ``p``, and with ``offload_param`` ``working``
    is the host tensor for ``w_shard``: each regular unit is then copied
    to the card just before its gather (the unit fill)."""

    def __init__(self, plan: ZeroPartitionPlan, sources: Iterable, dtype,
                 device, master=None, working=None):
        self.plan = plan
        self.dtype = dtype
        self.device = device
        self.micro = 0
        self.in_backward = False
        self.gathered: Dict[int, bool] = {}
        self.live = 0                 # elements of gathered unit buffers
        self.peak_live = 0
        self._ready: Dict[int, int] = {}
        self._done: Dict[int, bool] = {}
        self.leaves: List = []        # set by the engine: the bound leaves
        z = dict(dtype=torch.float32, device=device)
        big = max(u.padded for u in plan.units)
        self.p = (torch.zeros(plan.n_shard, **z) if master is None
                  else master)
        if working is not None:
            self.w_shard = working
        elif dtype == torch.float32 and master is None:
            self.w_shard = self.p
        else:
            self.w_shard = torch.zeros(plan.n_shard, dtype=dtype,
                                       device=device)
        pieces: Dict[int, List[Tuple[int, int, int]]] = {}
        for i, lo, hi, pos in plan.leaf_pieces():
            pieces.setdefault(i, []).append((lo, hi, pos))
        for i, src in enumerate(sources):
            v = src.reshape(-1)
            if plan.world > 1:
                v = v.to(device=device, dtype=torch.float32, copy=True)
                comm.broadcast(v, src=0, group=EXTENT,
                               log_name="init_broadcast")
            for lo, hi, pos in pieces.get(i, ()):
                self.p[pos:pos + hi - lo] = v[lo:hi]
                if self.w_shard is not self.p:
                    # the working copy is the master's values cast
                    self.w_shard[pos:pos + hi - lo] = \
                        v[lo:hi].to(torch.float32)
        self.g = torch.zeros(plan.n_shard, **z)
        w = dict(dtype=dtype, device=device)
        self._views: List = [None] * len(plan.numels)
        if plan.stage <= 2:
            self.flat_w = torch.zeros(plan.n_full, **w)
            for i in range(len(plan.numels)):
                at = plan.leaf_start(i)
                self._views[i] = self.flat_w[at:at + plan.numels[i]]
            if plan.stage == 1:
                self.flat_gw = torch.zeros(plan.n_full, **w)
                self.flat_g = torch.zeros(plan.n_full, **z)
        else:
            pers = plan.persistent_unit
            self.w_pers = torch.zeros(pers.padded, **w) if pers else None
            self.w_pshard = (torch.zeros(plan.n_param, **w)
                             if plan.hpz > 1 else None)
            self.unit_buf = {}
            for u, unit in enumerate(plan.units):
                # a view is cut from a whole storage: allocate the unit's,
                # cut its leaves' views, release it
                buf = self.w_pers if unit.persistent else \
                    torch.empty(unit.padded, **w)
                for i, off in zip(unit.leaves, unit.leaf_offsets):
                    self._views[i] = buf[off:off + plan.numels[i]]
                if not unit.persistent:
                    buf.untyped_storage().resize_(0)
                    self.unit_buf[u] = buf
        # the gradient path's scratch, one unit at most, kept from step to
        # step
        self._grad_full = torch.empty(big, **z) if plan.stage >= 2 else None
        self._grad_mid = (torch.empty(big // plan.hpz, **z)
                          if plan.hpz > 1 else None)
        self._grad_part = (torch.empty(big // plan.world, **z)
                           if plan.stage >= 2 else None)
        self.refresh()

    # -- views ----------------------------------------------------------

    def working_views(self) -> List:
        """Each leaf's working copy (flat), in leaf order."""
        return list(self._views)

    def grad_views(self) -> List:
        """Stage 1: each leaf's ``.grad`` (flat) in ``flat_gw``."""
        return [self.flat_gw[self.plan.leaf_start(i):
                             self.plan.leaf_start(i) + n]
                for i, n in enumerate(self.plan.numels)]

    def shard_slice(self, t, unit: Unit):
        return t[unit.shard_offset:unit.shard_offset + unit.chunk]

    def _on_device(self, t):
        """``t`` on the card: a slice of a working copy kept in host RAM
        (``offload_param``) is copied in first."""
        if t.device.type == torch.device(self.device).type:
            return t
        return t.to(self.device, non_blocking=True)

    def numels(self) -> Dict[str, int]:
        """Elements this rank holds now: fp32 master and gradient, the
        working copy (at stage 3 with the units gathered at this moment;
        ``peak_live`` has the most ever gathered at once), and the
        gradient reduction's scratch (one unit at most)."""
        out = {"master": self.p.numel(), "grad_fp32": self.g.numel(),
               "working_shard": (0 if self.w_shard is self.p
                                 else self.w_shard.numel())}
        if self.plan.stage <= 2:
            out["working"] = self.flat_w.numel()
            if self.plan.stage == 1:
                out["grad_fp32"] += self.flat_g.numel()
                out["grad"] = self.flat_gw.numel()
        else:
            out["working"] = ((self.w_pers.numel() if self.w_pers is not None
                               else 0) +
                              (self.w_pshard.numel()
                               if self.w_pshard is not None else 0) +
                              self.live)
        out["scratch"] = sum(t.numel() for t in (
            self._grad_full, self._grad_mid, self._grad_part)
            if t is not None)
        return out

    # -- collectives ----------------------------------------------------

    def gather_unit(self, src, out, log_name: str):
        """A whole unit (``out``) from every rank's slice (``src``), in the
        layout's order: under hpZ the slices of rank (d, s) sit at
        s*D + d, so the gather runs over ``data`` and then ``data_sub``."""
        if self.plan.hpz > 1:
            src = comm.all_gather(src, group="data", log_name=log_name)
            return comm.all_gather(src, group="data_sub", out=out,
                                   log_name=log_name)
        return comm.all_gather(src, group=EXTENT, out=out,
                               log_name=log_name)

    def reduce_unit(self, src, out):
        """The sum over ranks of a whole fp32 unit (``src``), this rank's
        slice into ``out`` (over ``data_sub`` and then ``data`` under
        hpZ)."""
        if self.plan.hpz > 1:
            mid = self._grad_mid[:src.numel() // self.plan.hpz]
            comm.reduce_scatter(src, group="data_sub", out=mid,
                                log_name="grad_reduce_scatter")
            return comm.reduce_scatter(mid, group="data", out=out,
                                       log_name="grad_reduce_scatter")
        return comm.reduce_scatter(src, group=EXTENT, out=out,
                                   log_name="grad_reduce_scatter")

    def refresh(self) -> None:
        """Bring the working copy up to ``w_shard`` (after a step or a
        load): stages 1-2 gather every unit; stage 3 gathers the
        persistent unit, and under hpZ each rank's working-copy piece."""
        plan = self.plan
        if plan.stage <= 2:
            for unit in plan.units:
                self.gather_unit(
                    self.shard_slice(self.w_shard, unit),
                    self.flat_w[unit.offset:unit.offset + unit.padded],
                    "weight_gather")
            return
        for u, unit in enumerate(plan.units):
            src = self.shard_slice(self.w_shard, unit)
            if unit.persistent:
                self.gather_unit(self._on_device(src), self.w_pers,
                                 "weight_gather")
            elif plan.hpz > 1:
                n = unit.padded // plan.hpz
                comm.all_gather(src, group="data", log_name="weight_gather",
                                out=self.w_pshard[unit.param_offset:
                                                  unit.param_offset + n])

    def gather(self, u: int) -> None:
        """Stage 3: allocate regular unit ``u``'s buffer and gather it
        (no-op when gathered).  The leaves are views of the buffer, and
        autograd may hold them as saved tensors: refilling the storage
        keeps their version counter."""
        if self.gathered.get(u):
            return
        plan, unit, buf = self.plan, self.plan.units[u], self.unit_buf[u]
        buf.untyped_storage().resize_(unit.padded * buf.element_size())
        if plan.hpz > 1:
            n = unit.padded // plan.hpz
            src, group = self.w_pshard[unit.param_offset:
                                       unit.param_offset + n], "data_sub"
        else:
            src = self._on_device(self.shard_slice(self.w_shard, unit))
            group = EXTENT
        with torch.autograd._unsafe_preserve_version_counter(buf):
            comm.all_gather(src, group=group, out=buf,
                            log_name="param_gather")
        self.gathered[u] = True
        self.live += unit.padded
        self.peak_live = max(self.peak_live, self.live)

    def release(self, u: int) -> None:
        """Stage 3: free regular unit ``u``'s storage; its views stay
        valid and are refilled by the next :meth:`gather`."""
        if not self.gathered.get(u):
            return
        self.unit_buf[u].untyped_storage().resize_(0)
        self.gathered[u] = False
        self.live -= self.plan.units[u].padded

    def release_all(self) -> None:
        for u in list(self.gathered):
            self.release(u)

    # -- gradients ------------------------------------------------------

    def reduce_full_grad(self) -> None:
        """Stage 1, once per step: every unit of the whole fp32 gradient
        sum reduce-scattered into ``g``."""
        for unit in self.plan.units:
            self.reduce_unit(self.flat_g[unit.offset:
                                         unit.offset + unit.padded],
                             self.shard_slice(self.g, unit))

    def on_grad(self, i: int) -> None:
        """Stages 2-3: leaf ``i``'s gradient was accumulated; once its
        unit's every leaf is, the unit is reduced."""
        u = self.plan.unit_of[i]
        self._ready[u] = self._ready.get(u, 0) + 1
        if self._ready[u] == len(self.plan.units[u].leaves):
            self._reduce_grad(u)

    def finish_backward(self) -> None:
        """After a micro-batch's backward: a unit some of whose leaves got
        no gradient is reduced with zeros there (every rank reduces every
        unit once, in the same order), and the bookkeeping resets."""
        for u in range(len(self.plan.units)):
            if not self._done.get(u):
                self._reduce_grad(u)
        self._ready.clear()
        self._done.clear()
        self.release_all()

    def _reduce_grad(self, u: int) -> None:
        unit = self.plan.units[u]
        full = self._grad_full[:unit.padded]
        full[unit.numel:].zero_()
        for i, off in zip(unit.leaves, unit.leaf_offsets):
            leaf, n = self.leaves[i], self.plan.numels[i]
            if leaf.grad is None:
                full[off:off + n].zero_()
            else:
                full[off:off + n] = leaf.grad.reshape(-1)
            leaf.grad = None
        dest = self.shard_slice(self.g, unit)
        if self.micro == 0:
            self.reduce_unit(full, dest)
        else:
            part = self._grad_part[:unit.chunk]
            dest.add_(self.reduce_unit(full, part))
        self._done[u] = True
        if not unit.persistent:
            self.release(u)


# module -> the hook handles of the engine that trains it now
_MODULE_HOOKS: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


class UnitGatherHooks:
    """Stage 3's module hooks (FSDP's): a regular unit is gathered just
    before its forward and released after it; a hook on its output
    gathers it again before its backward, and under activation
    checkpointing the recompute's own forward hooks find it gathered (a
    release waits for the unit's gradients: :meth:`ZeroBuffers.on_grad`).

    A unit whose leaves are all the parameters below one module (a
    decoder block, the embedding) hooks that module.  Otherwise it hooks
    each module that owns one of its leaves and is released after the
    last of them has run; a module called more than once in a forward
    (GPT-2's tied embedding: the lookup, then the head) says so in its
    ``calls_per_forward``, and the release waits for its last call.

    ``handles`` removes the hooks; the engine does when it is freed, so
    a module kept after its engine is dropped keeps none of the
    engine's memory.  A module trains under one engine at a time: the
    hooks of an engine initialised on it before are removed here."""

    def __init__(self, zb: ZeroBuffers, module, names: Sequence[str]):
        for handle in _MODULE_HOOKS.pop(module, ()):
            handle.remove()
        self.zb = zb
        self.handles: List = []
        _MODULE_HOOKS[module] = self.handles
        self._fwd_count: Dict[int, int] = {}
        persistent = {names[i] for u in zb.plan.units if u.persistent
                      for i in u.leaves}
        for u, unit in enumerate(zb.plan.units):
            if unit.persistent:
                continue
            leaf_names = [names[i] for i in unit.leaves]
            mods = [n.rpartition(".")[0] for n in leaf_names]
            parts = [m.split(".") for m in mods]
            common = []
            for seg in zip(*parts):
                if len(set(seg)) > 1:
                    break
                common.append(seg[0])
            anc = ".".join(common)
            below = {f"{anc}.{n}" if anc else n for n, _ in
                     module.get_submodule(anc).named_parameters()}
            if below <= set(leaf_names) | persistent:
                targets = [module.get_submodule(anc)]
            else:
                targets = [module.get_submodule(m)
                           for m in dict.fromkeys(mods)]
            calls = sum(getattr(m, "calls_per_forward", 1) for m in targets)
            for mod in targets:
                self.handles += [
                    mod.register_forward_pre_hook(self._pre(u)),
                    mod.register_forward_hook(self._post(u, calls))]

    def _pre(self, u: int):
        def hook(module, args):
            self.zb.gather(u)
        return hook

    def _post(self, u: int, n_calls: int):
        def regather(grad):
            self.zb.gather(u)

        def hook(module, args, output):
            zb = self.zb
            if torch.is_grad_enabled() and not zb.in_backward:
                outs = output if isinstance(output, (tuple, list)) \
                    else (output,)
                for t in outs:
                    if isinstance(t, torch.Tensor) and t.requires_grad:
                        t.register_hook(regather)
            self._fwd_count[u] = self._fwd_count.get(u, 0) + 1
            if self._fwd_count[u] < n_calls:
                return
            self._fwd_count[u] = 0
            if not zb.in_backward:
                zb.release(u)
        return hook
