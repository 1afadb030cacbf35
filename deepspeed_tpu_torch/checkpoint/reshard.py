"""World re-slicing math: map a partitioned unit from world W to W'.

Counterpart of ``deepspeed_tpu/checkpoint/reshard.py``, adapted to the
port's layout (``runtime/zero.py``): the engine's flat buffers are cut
into gather units, each padded to a multiple of ``world x ALIGN``
elements and cut into ``world`` equal slices, slice ``i`` to the rank
whose shard holds it.  A slice written at world W cannot be read back at
W' by reinterpreting offsets: the slices are gathered to the whole unit
and cut again.

The checkpoint itself stores flat pieces of each leaf (``[lo, hi)`` of
the leaf's elements in row-major order), so a reader assembles any range
of a leaf from the pieces that overlap it (:func:`assemble_flat`):
every (world, stage) loads every checkpoint.

Everything here is pure numpy.
"""
from __future__ import annotations

from typing import Iterable, List, Sequence, Tuple

import numpy as np

__all__ = ["ALIGN", "padded_partition_size", "padded_unit_size",
           "partition_padded", "gather_padded_partitions",
           "reshard_padded_partitions", "assemble_flat"]

# elements a unit's slice is a multiple of: 256 bytes of fp32, so every
# slice of every buffer starts 16-byte aligned for the optimizer kernel
ALIGN = 64


def padded_partition_size(numel: int, world: int, align: int = ALIGN) -> int:
    """Elements in each rank's slice of a unit of ``numel`` elements:
    ``ceil(numel / (world * align)) * align``."""
    if world < 1:
        raise ValueError(f"world must be >= 1, got {world}")
    return -(-int(numel) // (int(world) * align)) * align


def padded_unit_size(numel: int, world: int, align: int = ALIGN) -> int:
    """The unit's padded length: a multiple of ``world * align``."""
    return world * padded_partition_size(numel, world, align)


def partition_padded(full: np.ndarray, world: int,
                     align: int = ALIGN) -> List[np.ndarray]:
    """Cut ``full`` (any shape) into ``world`` slices of the padded unit,
    the tail zero-padded.  Inverse of :func:`gather_padded_partitions`."""
    flat = np.ascontiguousarray(full).reshape(-1)
    per = padded_partition_size(flat.size, world, align)
    padded = np.zeros(per * world, dtype=flat.dtype)
    padded[:flat.size] = flat
    return [padded[rk * per:(rk + 1) * per] for rk in range(world)]


def gather_padded_partitions(parts: Sequence[np.ndarray], numel: int,
                             align: int = ALIGN) -> np.ndarray:
    """Concatenate per-rank slices and strip the padding: the flat unit.
    Inverse of :func:`partition_padded`."""
    world = len(parts)
    if world < 1:
        raise ValueError("gather needs at least one partition")
    per = padded_partition_size(numel, world, align)
    for rk, p in enumerate(parts):
        if p.size != per:
            raise ValueError(
                f"partition {rk} holds {p.size} elements, layout expects "
                f"{per} (numel {numel} @ world {world})")
    return np.concatenate([np.asarray(p).reshape(-1)
                           for p in parts])[:numel]


def reshard_padded_partitions(parts: Sequence[np.ndarray], numel: int,
                              new_world: int,
                              align: int = ALIGN) -> List[np.ndarray]:
    """Map one unit's slices from world ``len(parts)`` to ``new_world``:
    gather, then cut again."""
    return partition_padded(gather_padded_partitions(parts, numel, align),
                            new_world, align)


def assemble_flat(lo: int, hi: int,
                  pieces: Iterable[Tuple[int, int, np.ndarray]],
                  dtype) -> Tuple[np.ndarray, np.ndarray]:
    """Elements ``[lo, hi)`` of one flat leaf from saved pieces
    ``(start, stop, data)``.  Returns ``(values, covered)``: the values
    and a bool mask of which elements some piece provided.  Overlapping
    pieces are last-writer-wins (equal by construction in one save)."""
    out = np.zeros(hi - lo, dtype=dtype)
    covered = np.zeros(hi - lo, dtype=bool)
    for a, b, data in pieces:
        s, e = max(a, lo), min(b, hi)
        if s >= e:
            continue
        out[s - lo:e - lo] = np.asarray(data).reshape(-1)[s - a:e - a]
        covered[s - lo:e - lo] = True
    return out, covered
