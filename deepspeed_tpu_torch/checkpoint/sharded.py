"""Checkpoint store: one blob plus a crc32 manifest per process.

Counterpart of ``deepspeed_tpu/checkpoint/sharded.py`` for one process.
The format is the JAX package's: every leaf is a record keyed by its tree
path (``module/<param name>``, ``optimizer/<moment>/<param name>``) with
its global shape, dtype, byte offset, length and crc32 in
``index_p0.json``, its bytes in ``shards_p0.bin``, and ``done_p0`` written
last.  Since the port runs one process and never shards a leaf, every
record covers its whole leaf (ZeRO partitions across ranks come with
ROADMAP A6).

Saves stream leaf by leaf, so host memory holds one leaf at a time; the
blob and the manifest are fsync'd before the done marker.  Async saves
(the JAX package's ``AsyncSaver``) and the fault-injection hooks are not
ported (ROADMAP A5 and A6).
"""
from __future__ import annotations

import json
import os
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from deepspeed_tpu_torch.resilience.retry import retriable

INDEX_FILE = "index_p{proc}.json"
BLOB_FILE = "shards_p{proc}.bin"
DONE_FILE = "done_p{proc}"
PROC = 0            # the one process


def flatten(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """``{"a": {"b": t}}`` -> ``{"a/b": t}``."""
    out: Dict[str, torch.Tensor] = {}
    for key, val in tree.items():
        path = f"{prefix}{key}"
        if isinstance(val, dict):
            out.update(flatten(val, path + "/"))
        else:
            out[path] = val
    return out


def _dtype_name(t: torch.Tensor) -> str:
    return str(t.dtype).removeprefix("torch.")


def _to_bytes(t: torch.Tensor) -> np.ndarray:
    """The leaf's bytes on the host (one device-to-host copy)."""
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
def _write_blob(blob: str, leaves: Dict[str, torch.Tensor]) -> List[Dict]:
    """Stream every leaf into ``blob``, recording its place and crc32.
    Idempotent (rewrites from the start), so transient OSErrors retry."""
    records, offset = [], 0
    with open(blob, "wb") as f:
        for path, leaf in leaves.items():
            data = _to_bytes(leaf)
            records.append({"path": path, "dtype": _dtype_name(leaf),
                            "global_shape": list(leaf.shape),
                            "slices": [[0, d] for d in leaf.shape],
                            "offset": offset, "nbytes": int(data.nbytes),
                            "crc32": zlib.crc32(data)})
            f.write(data.tobytes())
            offset += data.nbytes
        _fsync_file(f)
    return records


@retriable(retry_on=(OSError,))
def _write_index(index: str, records: List[Dict]) -> None:
    with open(index, "w") as f:
        json.dump({"records": records}, f)
        _fsync_file(f)


def save_tree(tree: Dict, path: str) -> None:
    """Write ``tree`` (nested dicts of tensors) under ``path``: blob, then
    manifest, then the done marker."""
    os.makedirs(path, exist_ok=True)
    records = _write_blob(os.path.join(path, BLOB_FILE.format(proc=PROC)),
                          flatten(tree))
    _write_index(os.path.join(path, INDEX_FILE.format(proc=PROC)), records)
    with open(os.path.join(path, DONE_FILE.format(proc=PROC)), "w") as f:
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
    """Reads whole leaves back from a tag directory."""

    def __init__(self, path: str):
        self.by_path: Dict[str, Dict] = {}
        self.blobs: Dict[int, str] = {}
        for fname in sorted(os.listdir(path)):
            if not (fname.startswith("index_p") and fname.endswith(".json")):
                continue
            proc = int(fname[len("index_p"):-len(".json")])
            with open(os.path.join(path, fname)) as f:
                for rec in json.load(f)["records"]:
                    if rec["slices"] != [[0, d] for d in
                                         rec["global_shape"]]:
                        raise NotImplementedError(
                            f"{rec['path']!r} is saved in shards; reading "
                            "partitioned checkpoints comes with ROADMAP A6")
                    rec["proc"] = proc
                    self.by_path[rec["path"]] = rec
            self.blobs[proc] = os.path.join(path, BLOB_FILE.format(proc=proc))

    @retriable(retry_on=(OSError,))
    def _pread(self, rec: Dict) -> bytes:
        with open(self.blobs[rec["proc"]], "rb") as f:
            f.seek(rec["offset"])
            return f.read(rec["nbytes"])

    def read(self, path: str) -> torch.Tensor:
        rec = self.by_path.get(path)
        if rec is None:
            raise KeyError(f"checkpoint has no entry for {path!r}")
        raw = bytearray(self._pread(rec))
        dtype = getattr(torch, rec["dtype"])
        flat = torch.frombuffer(raw, dtype=torch.uint8) if raw else \
            torch.empty(0, dtype=torch.uint8)
        return flat.view(dtype).reshape(rec["global_shape"])


def load_tree(template: Dict, path: str) -> None:
    """Copy the saved leaves into the tensors of ``template`` (nested
    dicts of tensors, the shape of what :func:`save_tree` wrote), casting
    to each tensor's dtype and device."""
    reader = Reader(path)
    for key, dst in flatten(template).items():
        src = reader.read(key)
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"{key!r}: checkpoint shape {tuple(src.shape)} "
                             f"!= model shape {tuple(dst.shape)} (different "
                             "model config?)")
        dst.copy_(src)

