"""Process topology over ``torch.distributed``.

Counterpart of ``deepspeed_tpu/parallel/topology.py``.  The reference puts
every parallelism axis on one ``jax.sharding.Mesh`` and names groups by
mesh axes; here the ranks of the default process group are laid out on
the same axes, in the same order (outer to inner)::

    ("pipe", "data", "data_sub", "expert", "seq", "tensor")

and each set of axes becomes a ``torch.distributed`` process group: the
ranks that share their coordinates on every other axis.  ``data_sub`` is
the hpZ sub-axis (ZeRO++ secondary partition, the reference's
``groups.py:650``): the data axis splits into ``data`` (outer) x
``data_sub`` (inner, ``zero_hpz_partition_size`` wide), so a ``data_sub``
group is a run of consecutive ranks.

Only ``data`` and ``data_sub`` may be wider than 1 in the port so far:
tensor, pipeline, sequence and expert parallelism raise
``NotImplementedError`` naming ROADMAP A11.

Without an initialised process group the topology is a world of one
process, and every group is local (a collective over it is a copy).
Under one, every group is a ``torch.distributed`` group, one of a single
rank included, so a world of one runs its collectives through the
backend (NCCL on a card) as a wider world does.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from deepspeed_tpu_torch.utils.logging import log_dist

PIPE_AXIS = "pipe"
DATA_AXIS = "data"
HPZ_AXIS = "data_sub"
EXPERT_AXIS = "expert"
SEQ_AXIS = "seq"
TENSOR_AXIS = "tensor"

AXIS_ORDER: Tuple[str, ...] = (PIPE_AXIS, DATA_AXIS, HPZ_AXIS, EXPERT_AXIS,
                               SEQ_AXIS, TENSOR_AXIS)


class Group:
    """One process group as this rank sees it: the global ranks of its
    members in order, this rank's index among them, and the
    ``torch.distributed`` group (``None`` only without an initialised
    process group, where a collective is a local copy)."""

    def __init__(self, ranks: Sequence[int], rank: int, pg):
        self.ranks = list(ranks)
        self.size = len(self.ranks)
        self.rank = self.ranks.index(rank)
        self.pg = pg

    def __repr__(self):  # pragma: no cover
        return f"Group(ranks={self.ranks}, rank={self.rank})"


class MeshTopology:
    """Every parallelism axis over the ranks of the default process group.

    Parameters mirror the reference's sizes: ``pp``, ``tp``, ``sp``, ``ep``
    and ``hpz``; ``dp`` (data-parallel replicas, the hpZ split included) is
    inferred from the world size unless given.  Group creation is
    collective: every rank builds the same topology, in the same order.
    """

    def __init__(self, dp: Optional[int] = None, tp: int = 1, pp: int = 1,
                 sp: int = 1, ep: int = 1, hpz: int = 1):
        distributed = dist.is_available() and dist.is_initialized()
        n = dist.get_world_size() if distributed else 1
        self.rank = dist.get_rank() if distributed else 0
        denom = tp * pp * sp * ep
        if n % denom != 0:
            raise ValueError(
                f"world size {n} not divisible by tp*pp*sp*ep = {denom}")
        if dp is None:
            dp = n // denom
        if dp * denom != n:
            raise ValueError(f"dp({dp}) * tp({tp}) * pp({pp}) * sp({sp}) * "
                             f"ep({ep}) != world size {n}")
        if dp % hpz != 0:
            raise ValueError(f"dp({dp}) not divisible by hpz({hpz})")
        unported = {name: size for name, size in (
            ("tp", tp), ("pp", pp), ("sp", sp), ("ep", ep)) if size > 1}
        if unported:
            raise NotImplementedError(
                f"{unported}: tensor, pipeline, sequence and expert "
                "parallelism are not ported yet (ROADMAP A11)")
        self.shape: Dict[str, int] = {
            PIPE_AXIS: pp, DATA_AXIS: dp // hpz, HPZ_AXIS: hpz,
            EXPERT_AXIS: ep, SEQ_AXIS: sp, TENSOR_AXIS: tp,
        }
        # the rank at each coordinate (the reference's mesh.devices)
        self.ranks = np.arange(n).reshape(
            tuple(self.shape[a] for a in AXIS_ORDER))
        self._distributed = distributed
        self._groups: Dict[Tuple[str, ...], Group] = {}
        for axes in [(a,) for a in AXIS_ORDER] + [self.zero_axes]:
            self.group(axes)
        log_dist(f"MeshTopology: {self.describe()}", ranks=[0])

    # -- sizes ----------------------------------------------------------

    @property
    def world_size(self) -> int:
        return int(self.ranks.size)

    def axis_size(self, axis: str) -> int:
        return self.shape[axis]

    @property
    def data_parallel_size(self) -> int:
        return self.shape[DATA_AXIS] * self.shape[HPZ_AXIS]

    @property
    def hpz_partition_size(self) -> int:
        return self.shape[HPZ_AXIS]

    # -- derived axis sets (as the reference) ----------------------------

    @property
    def zero_axes(self) -> Tuple[str, ...]:
        """Axes ZeRO partitions over: data x expert x seq (the reference's
        ``seq_data_parallel_group``)."""
        return (DATA_AXIS, HPZ_AXIS, EXPERT_AXIS, SEQ_AXIS)

    def zero_partition_count(self) -> int:
        return int(np.prod([self.shape[a] for a in self.zero_axes]))

    # -- groups -----------------------------------------------------------

    def group(self, axes: Sequence[str]) -> Group:
        """The group of this rank over ``axes``: the ranks that share its
        coordinates on every other axis, ordered by their coordinates on
        ``axes`` (row-major in ``AXIS_ORDER``).

        Groups are made when first asked for, and making one is
        collective: the constructor makes every single axis and the ZeRO
        axes up front; any other set must be asked for by every rank in
        the same order."""
        unknown = set(axes) - set(AXIS_ORDER)
        if unknown:
            raise ValueError(f"unknown axes {sorted(unknown)}")
        axes = tuple(a for a in AXIS_ORDER if a in set(axes))
        if axes in self._groups:
            return self._groups[axes]
        inner = [AXIS_ORDER.index(a) for a in axes]
        outer = [i for i in range(len(AXIS_ORDER)) if i not in inner]
        rows = np.transpose(self.ranks, outer + inner).reshape(
            -1, int(np.prod([self.shape[a] for a in axes], dtype=np.int64)))
        rows_list: List[List[int]] = [[int(r) for r in row] for row in rows]
        mine = next(row for row in rows_list if self.rank in row)
        if not self._distributed:
            pg = None
        elif len(mine) == self.world_size:
            pg = dist.group.WORLD
        else:
            pg, _ = dist.new_subgroups_by_enumeration(rows_list)
        self._groups[axes] = Group(mine, self.rank, pg)
        return self._groups[axes]

    def describe(self) -> str:
        return " x ".join(f"{a}={s}" for a, s in self.shape.items())

    def __repr__(self) -> str:  # pragma: no cover
        return f"MeshTopology({self.describe()})"
