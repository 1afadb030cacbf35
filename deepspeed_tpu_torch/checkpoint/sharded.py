"""Checkpoint store: one blob plus a crc32 manifest per process.

Counterpart of ``deepspeed_tpu/checkpoint/sharded.py``.  The format is the
JAX package's: every record is keyed by its tree path (``module/<param
name>``, ``optimizer/<moment>/<param name>``) with the leaf's global shape,
its dtype, byte offset, length and crc32 in ``index_p<rank>.json``, its
bytes in ``shards_p<rank>.bin``, and ``done_p<rank>`` written last.  Each
rank writes its own three files.  A record holds elements ``flat = [lo,
hi)`` of its leaf in row-major order: the whole leaf at ZeRO stage 0 (then
``slices`` covers every dimension, as in the JAX format), the piece of a
rank's shard at stages 1-3.  The reader assembles any range of a leaf
from the records that overlap it (``reshard.assemble_flat``), so a
checkpoint saved at one world size and stage loads at any other.

Saves stream record by record, so host memory holds one leaf piece at a
time; the blob and the manifest are fsync'd before the done marker.  The
write and read paths are fault-injection sites (``ckpt.write_blob``,
``ckpt.write_record``, ``ckpt.write_index``, ``ckpt.read_record``;
``resilience/faults.py``).  Async saves (the JAX package's
``AsyncSaver``) are not ported (ROADMAP A5).
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.checkpoint.reshard import assemble_flat
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.resilience.retry import retriable

INDEX_FILE = "index_p{proc}.json"
BLOB_FILE = "shards_p{proc}.bin"
DONE_FILE = "done_p{proc}"

# (path, leaf shape, lo, hi, flat tensor of hi - lo elements); in place
# of the tensor a piece may hold a function: a save calls it for the
# tensor when it writes the piece, a load calls it with the elements read
Piece = Tuple[str, Tuple[int, ...], int, int, Any]


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_bytes(t: torch.Tensor) -> np.ndarray:
    """The piece's bytes on the host (one device-to-host copy)."""
    return t.detach().contiguous().cpu().reshape(-1).view(torch.uint8).numpy()


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def fsync_dir(path: str) -> None:
    """Durably record directory entries (a rename is crash-safe only once
    its parent directory is synced)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


@retriable(retry_on=(OSError,))
def _write_blob(blob: str, pieces: Sequence[Piece]) -> List[Dict]:
    """Stream every piece into ``blob``, recording its place and crc32.
    Idempotent (rewrites from the start), so transient OSErrors retry."""
    faults.hook("ckpt.write_blob", path=blob)
    records, offset = [], 0
    with open(blob, "wb") as f:
        for i, (path, shape, lo, hi, t) in enumerate(pieces):
            if callable(t):
                t = t()
            data = _to_bytes(t)
            action = faults.hook("ckpt.write_record", path=blob, index=i,
                                 nbytes=int(data.nbytes))
            if action is not None and action[0] == "torn":
                f.write(data.tobytes()[:max(1, int(data.nbytes *
                                                   action[1]))])
                _fsync_file(f)
                raise faults.SimulatedCrash(
                    f"torn write: record {i} of {blob} cut short")
            rec = {"path": path, "dtype": _dtype_name(t),
                   "global_shape": list(shape), "flat": [lo, hi],
                   "offset": offset, "nbytes": int(data.nbytes),
                   "crc32": zlib.crc32(data)}
            if lo == 0 and hi == max(1, int(np.prod(shape))):
                rec["slices"] = [[0, d] for d in shape]
            records.append(rec)
            f.write(data)
            offset += data.nbytes
        _fsync_file(f)
    return records


@retriable(retry_on=(OSError,))
def _write_index(index: str, records: List[Dict]) -> None:
    faults.hook("ckpt.write_index", path=index)
    with open(index, "w") as f:
        json.dump({"records": records}, f)
        _fsync_file(f)


def save_pieces(pieces: Sequence[Piece], path: str, proc: int = 0) -> None:
    """Write process ``proc``'s ``pieces`` under ``path``: blob, then
    manifest, then the done marker."""
    os.makedirs(path, exist_ok=True)
    records = _write_blob(os.path.join(path, BLOB_FILE.format(proc=proc)),
                          pieces)
    _write_index(os.path.join(path, INDEX_FILE.format(proc=proc)), records)
    with open(os.path.join(path, DONE_FILE.format(proc=proc)), "w") as f:
        f.write("ok")
        _fsync_file(f)


def is_complete(path: str, process_count: int = 1) -> bool:
    """Every process's done marker present?"""
    return all(os.path.exists(os.path.join(path, DONE_FILE.format(proc=p)))
               for p in range(process_count))


def verify_tag(path: str, process_count: Optional[int] = None,
               deep: bool = True) -> Tuple[bool, str]:
    """Integrity check of one tag directory: every manifest parses, its
    done marker exists, the blob holds exactly the bytes the manifest
    claims, and (``deep``) every record's crc32 matches.  Returns
    ``(ok, reason)`` and never raises."""
    if not os.path.isdir(path):
        return False, "tag directory missing"
    try:
        idx_files = sorted(f for f in os.listdir(path)
                           if f.startswith("index_p") and f.endswith(".json"))
    except OSError as e:
        return False, f"unreadable tag directory ({e})"
    if not idx_files:
        return False, "no shard manifests"
    if process_count is not None and len(idx_files) != process_count:
        return False, (f"{len(idx_files)} of {process_count} process "
                       "manifests present")
    for fname in idx_files:
        proc = int(fname[len("index_p"):-len(".json")])
        if not os.path.exists(os.path.join(path, DONE_FILE.format(proc=proc))):
            return False, f"process {proc} never finished writing"
        try:
            with open(os.path.join(path, fname)) as f:
                records = json.load(f)["records"]
        except (OSError, ValueError, KeyError) as e:
            return False, f"manifest {fname} unreadable ({e})"
        blob = os.path.join(path, BLOB_FILE.format(proc=proc))
        try:
            size = os.path.getsize(blob)
        except OSError:
            return False, f"blob for process {proc} missing"
        total = sum(int(r["nbytes"]) for r in records)
        if total != size:
            return False, (f"blob for process {proc} holds {size} bytes, "
                           f"manifest claims {total} (torn write?)")
        if deep:
            with open(blob, "rb") as f:
                for r in records:
                    if "crc32" not in r:
                        continue
                    f.seek(int(r["offset"]))
                    data = f.read(int(r["nbytes"]))
                    if len(data) != int(r["nbytes"]) or \
                            zlib.crc32(data) != int(r["crc32"]):
                        return False, (f"crc mismatch in {r['path']!r} "
                                       f"(process {proc})")
    return True, "ok"


class Reader:
    """Reads ranges of leaves back from a tag directory, from whichever
    records (of any process) cover them."""

    def __init__(self, path: str):
        self.by_path: Dict[str, List[Dict]] = {}
        self.blobs: Dict[int, str] = {}
        for fname in sorted(os.listdir(path)):
            if not (fname.startswith("index_p") and fname.endswith(".json")):
                continue
            proc = int(fname[len("index_p"):-len(".json")])
            with open(os.path.join(path, fname)) as f:
                for rec in json.load(f)["records"]:
                    if "flat" not in rec:
                        # written before records carried "flat": whole
                        # leaves only
                        if rec["slices"] != [[0, d] for d in
                                             rec["global_shape"]]:
                            raise ValueError(
                                f"{rec['path']!r}: a record without "
                                "'flat' must hold its whole leaf")
                        rec["flat"] = [0, max(1, int(np.prod(
                            rec["global_shape"])))]
                    rec["proc"] = proc
                    self.by_path.setdefault(rec["path"], []).append(rec)
            self.blobs[proc] = os.path.join(path, BLOB_FILE.format(proc=proc))

    @retriable(retry_on=(OSError,))
    def _pread(self, rec: Dict, start: int = 0,
               stop: Optional[int] = None) -> bytes:
        """Bytes ``[start, stop)`` of the record (all of it by
        default)."""
        faults.hook("ckpt.read_record", path=rec["path"], proc=rec["proc"])
        stop = rec["nbytes"] if stop is None else stop
        with open(self.blobs[rec["proc"]], "rb") as f:
            f.seek(rec["offset"] + start)
            return f.read(stop - start)

    def shape(self, path: str) -> Tuple[int, ...]:
        return tuple(self._records(path)[0]["global_shape"])

    def _records(self, path: str) -> List[Dict]:
        recs = self.by_path.get(path)
        if not recs:
            raise KeyError(f"checkpoint has no entry for {path!r}")
        return recs

    def read_flat(self, path: str, lo: int, hi: int) -> torch.Tensor:
        """Elements ``[lo, hi)`` of leaf ``path``, flat, in its saved
        dtype, assembled from the records that overlap them."""
        recs = self._records(path)
        dtype = getattr(torch, recs[0]["dtype"])
        size = torch.empty(0, dtype=dtype).element_size()
        pieces = []
        for rec in recs:
            a, b = rec["flat"]
            if a < hi and b > lo:
                # only the overlap: a piece of a large record reads its
                # own bytes
                s, e = max(a, lo), min(b, hi)
                raw = np.frombuffer(self._pread(rec, (s - a) * size,
                                                (e - a) * size),
                                    dtype=np.uint8)
                pieces.append((s * size, e * size, raw))
        data, covered = assemble_flat(lo * size, hi * size, pieces, np.uint8)
        if not covered.all():
            raise ValueError(
                f"{path!r}: the saved records cover "
                f"{int(covered.sum()) // size} of the {hi - lo} elements "
                f"[{lo}, {hi}) asked for (incomplete checkpoint?)")
        return torch.from_numpy(data).view(dtype)


def load_pieces(pieces: Sequence[Piece], path: str) -> None:
    """Copy the saved elements into each piece's tensor (casting to its
    dtype and device), whatever world size and stage saved them."""
    reader = Reader(path)
    for key, shape, lo, hi, dst in pieces:
        saved = reader.shape(key)
        if saved != tuple(shape):
            raise ValueError(f"{key!r}: checkpoint shape {saved} != model "
                             f"shape {tuple(shape)} (different model "
                             "config?)")
        data = reader.read_flat(key, lo, hi)
        if callable(dst):
            dst(data)
        else:
            dst.copy_(data)
