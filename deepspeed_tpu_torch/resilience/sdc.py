"""Silent-data-corruption defense: checksums for the offload paths.

Copy of ``deepspeed_tpu/resilience/sdc.py`` (numpy only; its digests equal
the reference's bit for bit).  The KV spill tiers
(:mod:`~deepspeed_tpu_torch.inference.kv_tiering`) digest every page at
spill and verify it at restore, trusting neither host DRAM nor disk.
The threat is bit flips, not an adversary, so the default is chosen for
throughput; all three detect any single flipped bit (and any single
corrupted word or byte):

``sum64``     wraparound sum of the buffer's ``uint64`` words (plus the
              tail bytes and the length), numpy-vectorized.  Weakest
              against multi-word corruption (two flips can cancel).
``adler32``   ``zlib.adler32``; detects all single-byte changes.
``crc32``     ``zlib.crc32``; strongest: all burst errors up to 32 bits.

Digests are ``(value, nbytes)`` so that truncation is detected even when
a short read happens to checksum clean.
"""
from __future__ import annotations

import zlib
from typing import Any, Callable, Optional, Tuple

import numpy as np

__all__ = ["CHECKSUM_ALGOS", "checksum", "digest", "DigestPool"]

CHECKSUM_ALGOS = ("sum64", "adler32", "crc32")

_U64 = (1 << 64) - 1


def _sum64(v: np.ndarray) -> int:
    """Wraparound sum over uint64 words (+ trailing bytes + the length,
    so zero buffers of different sizes differ).  A flipped bit changes
    one word by a nonzero power of two, which the mod-2^64 sum always
    shows."""
    n8 = v.size & ~np.intp(7)
    s = int(np.add.reduce(v[:n8].view(np.uint64))) & _U64 if n8 else 0
    for b in v[n8:]:                       # tail (len % 8 bytes)
        s = (s + int(b)) & _U64
    return (s + v.size) & _U64


def checksum(buf: np.ndarray, algo: str = "sum64") -> int:
    """Digest of a numpy buffer under ``algo``."""
    v = np.ascontiguousarray(buf).reshape(-1).view(np.uint8)
    if algo == "sum64":
        return _sum64(v)
    if algo == "adler32":
        return zlib.adler32(memoryview(v))
    if algo == "crc32":
        return zlib.crc32(memoryview(v))
    raise ValueError(
        f"unknown checksum algo {algo!r} (choose from {CHECKSUM_ALGOS})")


def digest(buf: np.ndarray, algo: str = "sum64") -> Tuple[int, int]:
    """``(checksum, nbytes)``: the unit a verified stream stores."""
    return checksum(buf, algo), int(buf.nbytes)


class DigestPool:
    """Side-thread digest jobs on the bounded-async-stage substrate
    (:mod:`deepspeed_tpu_torch.utils.async_stage`).

    The write-side digest pattern of a verified stream: the submitted
    buffer stays immutable until its IO is reaped, so the job races
    nothing and the checksum overlaps the IO (numpy and zlib release the
    GIL).  Keyed ``submit`` and selective ``pop`` let a read-side verify
    join exactly its digest.  Below ``defer_min`` bytes a thread-pool
    round trip costs more than the digest, so ``note`` digests small
    buffers inline.  ``spun`` says whether the lazy executor ever
    started.
    """

    def __init__(self, algo: str = "sum64", workers: int = 2,
                 defer_min: int = 4 << 20, depth: int = 256,
                 timers: Optional[Any] = None,
                 thread_name_prefix: str = "dstpu-sdc") -> None:
        from deepspeed_tpu_torch.utils.async_stage import (BoundedAsyncStage,
                                                           StageTimers)

        self.algo = algo
        self.defer_min = int(defer_min)
        self._workers = max(1, int(workers))
        self._prefix = thread_name_prefix
        self._exec = None                       # lazy ThreadPoolExecutor
        self.timers = timers if timers is not None else StageTimers()
        self._stage = BoundedAsyncStage(
            waiter=lambda fut: fut.result(), depth=depth,
            timers=self.timers, name="sdc-digest")

    @property
    def spun(self) -> bool:
        return self._exec is not None

    def digest(self, buf: np.ndarray) -> Tuple[int, int]:
        return digest(buf, self.algo)

    def submit(self, key: Any, fn: Callable[[], Any]) -> None:
        """Defer ``fn`` (a digest over buffers that stay immutable until
        joined) to the side pool under ``key``."""
        if self._exec is None:
            from concurrent.futures import ThreadPoolExecutor

            self._exec = ThreadPoolExecutor(
                max_workers=self._workers,
                thread_name_prefix=self._prefix)
        self._stage.submit(key, self._exec.submit(fn))

    def note(self, key: Any, buf: np.ndarray,
             defer: bool = True) -> Optional[Tuple[int, int]]:
        """Digest ``buf`` under ``key``: deferred to the side pool when
        worthwhile (returns None; fetch it with ``pop``), else
        inline (returns the digest)."""
        if defer and buf.nbytes >= self.defer_min:
            self.submit(key, lambda: self.digest(buf))
            return None
        return self.digest(buf)

    def pop(self, key: Any, default: Any = None) -> Any:
        """Join exactly one keyed job (``default`` when absent)."""
        return self._stage.pop(key, default)

    def discard(self, key: Any) -> None:
        """Join and forget one job (its bytes changed)."""
        self._stage.pop(key, None)

    def close(self) -> None:
        for key in self._stage.keys():
            self._stage.pop(key, None)
        if self._exec is not None:
            self._exec.shutdown(wait=True)
            self._exec = None
