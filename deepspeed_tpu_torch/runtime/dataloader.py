"""Data loading.

Copy of ``deepspeed_tpu/runtime/dataloader.py`` (the reference's
``runtime/dataloader.py``: ``DeepSpeedDataLoader`` + ``RepeatingLoader``)
without ``shard_batch``, which has no single-GPU counterpart: the engine
moves each batch to its device.  Works with any iterable / indexable
dataset yielding numpy arrays, dicts of arrays, or tuples.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, Optional

import numpy as np

from deepspeed_tpu_torch.utils.logging import logger


class RepeatingLoader:
    """Wraps an iterator to restart on StopIteration (reference
    ``RepeatingLoader``).  Resumable when the wrapped loader is: the
    state calls delegate, and restoring re-creates the live iterator so
    the stream continues from the restored cursor."""

    def __init__(self, loader):
        self.loader = loader
        self.data_iter = iter(loader)

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return next(self.data_iter)
        except StopIteration:
            self.data_iter = iter(self.loader)
            return next(self.data_iter)

    def state_dict(self) -> Optional[Dict[str, Any]]:
        sd = getattr(self.loader, "state_dict", None)
        return sd() if callable(sd) else None

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.loader.load_state_dict(state)
        self.data_iter = iter(self.loader)


def _stack(samples):
    first = samples[0]
    if isinstance(first, dict):
        return {k: np.stack([s[k] for s in samples]) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(np.stack([s[i] for s in samples])
                           for i in range(len(first)))
    return np.stack(samples)


class DeepSpeedDataLoader:
    """Batches an indexable dataset into global batches of
    ``batch_size`` samples, optionally shuffled per epoch with a seeded RNG
    (deterministic across hosts — the TPU analogue of the reference's
    DistributedSampler consistency check, engine.py:434).

    Resumable: the loader tracks ``(seed, epoch, cursor)`` — the
    in-epoch batch position — through :meth:`state_dict` /
    :meth:`load_state_dict`, and the engine persists it in the
    checkpoint's extra payload.  A restart therefore CONTINUES
    mid-epoch from the next unseen batch instead of replaying (double-
    training) or skipping (never seeing) the interrupted epoch's data;
    the shuffle permutation is a pure function of ``seed + epoch``, so
    the resumed sequence is identical to the uninterrupted one."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 1234, drop_last: bool = True,
                 collate_fn=None, world_size: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.collate_fn = collate_fn or _stack
        self.world_size = int(world_size)   # recorded for elastic resume
        self.epoch = 0              # epoch the NEXT batch comes from
        self.cursor = 0             # batches already served this epoch
        if not hasattr(dataset, "__len__") or not hasattr(dataset, "__getitem__"):
            raise TypeError("DeepSpeedDataLoader needs an indexable dataset; "
                            "wrap pure iterators with RepeatingLoader instead")

    def __len__(self) -> int:
        n = len(self.dataset)
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[Any]:
        n = len(self.dataset)
        idx = np.arange(n)
        if self.shuffle:
            rng = np.random.default_rng(self.seed + self.epoch)
            rng.shuffle(idx)
        stop = (n // self.batch_size) * self.batch_size if self.drop_last else n
        starts = range(0, stop, self.batch_size)
        for bi, start in enumerate(starts):
            if bi < self.cursor:
                continue            # resume mid-epoch: skip served batches
            sel = idx[start:start + self.batch_size]
            batch = self.collate_fn([self.dataset[int(i)] for i in sel])
            self.cursor = bi + 1
            yield batch
        self.epoch += 1
        self.cursor = 0

    # -- resumable state -------------------------------------------------

    def state_dict(self) -> Dict[str, Any]:
        return {"seed": int(self.seed), "epoch": int(self.epoch),
                "cursor": int(self.cursor),
                "batch_size": int(self.batch_size),
                "world_size": int(self.world_size)}

    def load_state_dict(self, state: Dict[str, Any]) -> None:
        self.seed = int(state["seed"])
        self.epoch = int(state["epoch"])
        cursor = int(state["cursor"])
        saved_bs = int(state.get("batch_size", self.batch_size))
        saved_world = int(state.get("world_size", self.world_size))
        if saved_bs != self.batch_size:
            # elastic re-slice changed the GLOBAL batch size: the cursor
            # counts batches of the OLD size, so re-map it through the
            # sample position.  Floor division re-visits at most one
            # partial batch rather than skipping samples.
            samples = cursor * saved_bs
            cursor = samples // self.batch_size
            if samples % self.batch_size:
                logger.warning(
                    f"dataloader resume: global batch {saved_bs} -> "
                    f"{self.batch_size} does not divide the {samples} "
                    f"consumed samples; re-visiting "
                    f"{samples % self.batch_size} samples of batch "
                    f"{cursor} rather than dropping them")
            logger.info(
                f"dataloader resume: re-mapped cursor {state['cursor']} "
                f"(batch {saved_bs}, world {saved_world}) -> {cursor} "
                f"(batch {self.batch_size}, world {self.world_size})")
        elif saved_world != self.world_size:
            # same global batch at a different world (elastic contract:
            # constant global batch across the menu) -> the cursor is a
            # count of GLOBAL batches and remains exact; log the
            # re-slice so resumes are auditable
            logger.info(
                f"dataloader resume: world {saved_world} -> "
                f"{self.world_size} with unchanged global batch "
                f"{self.batch_size}; cursor {cursor} carries over")
        self.cursor = cursor

