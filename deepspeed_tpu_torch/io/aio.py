"""ctypes bindings and first-use build of the native async file I/O engine.

Counterpart of ``deepspeed_tpu/io/aio.py``: the same ``aio_handle``
surface over ``csrc/aio.cpp`` (the port's own copy of the JAX package's
source), which ``g++ -O2 -shared -fPIC -pthread -std=c++17`` builds at
first use into ``io/build/`` (git-ignored), under a name that hashes the
source, so an edited source rebuilds and an unchanged one loads at once.
Nothing builds at import.  ::

    h = aio_handle(block_size=1<<20, queue_depth=..., thread_count=8)
    h.sync_pwrite(array, path)          # parallel chunked pwrite
    h.sync_pread(array, path)
    op = h.async_pwrite(array, path)    # returns an op id at once
    h.wait(op)                          # 0 on success

The backend is the source's own automatic choice: io_uring where the
kernel has it, else a pool of pread/pwrite threads
(``aio_handle.backend`` says which).  With ``use_odirect`` it opens files
``O_DIRECT`` and, where the filesystem refuses that, retries buffered, as
the source documents.

Buffers are numpy arrays.  :func:`aligned_empty` gives 4096-byte aligned
ones (the O_DIRECT requirement), and with ``pinned`` carves them from
page-locked host memory, so that copies between them and the card run
asynchronously.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

_SRC = Path(__file__).resolve().parent / "csrc" / "aio.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "build"
GXX_FLAGS = ("-O2", "-shared", "-fPIC", "-pthread", "-std=c++17")
_build_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None

DIRECT_ALIGN = 4096


def _library_path() -> Path:
    """Where the built library lives: named by a hash of the source and
    the flags."""
    h = hashlib.sha256(_SRC.read_bytes())
    h.update(" ".join(GXX_FLAGS).encode())
    return BUILD_DIR / f"libdstpu_aio_{h.hexdigest()[:16]}.so"


def _ensure_built() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib_path = _library_path()
        if not lib_path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            # a private name, then an atomic rename: concurrent builders
            # (test workers) never load a half-written library
            tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o",
                                   str(tmp)], capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {_SRC} failed:\n{proc.stderr}")
            os.replace(tmp, lib_path)
        lib = ctypes.CDLL(str(lib_path))
        lib.aio_create2.restype = ctypes.c_void_p
        lib.aio_create2.argtypes = [ctypes.c_int, ctypes.c_int64,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_int]
        lib.aio_backend.restype = ctypes.c_int
        lib.aio_backend.argtypes = [ctypes.c_void_p]
        lib.aio_destroy.restype = None
        lib.aio_destroy.argtypes = [ctypes.c_void_p]
        for fn in (lib.aio_submit_read, lib.aio_submit_write):
            fn.restype = ctypes.c_int64
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        for fn in (lib.aio_pread, lib.aio_pwrite):
            fn.restype = ctypes.c_int
            fn.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                           ctypes.c_void_p, ctypes.c_int64, ctypes.c_int64]
        lib.aio_wait.restype = ctypes.c_int
        lib.aio_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.aio_prealloc.restype = ctypes.c_int
        lib.aio_prealloc.argtypes = [ctypes.c_char_p, ctypes.c_int64]
        _lib = lib
        return lib


def aligned_empty(nbytes: int, pinned: bool = False) -> np.ndarray:
    """Uninitialized 1-D uint8 array of ``nbytes`` whose data pointer is
    4096-byte aligned, the O_DIRECT eligibility requirement the native
    engine checks per chunk (numpy's allocator guarantees 16 bytes).
    ``pinned``: carved from a page-locked torch host tensor, which the
    returned array keeps alive, so that copies between it and a CUDA
    device run asynchronously (needs CUDA)."""
    if pinned:
        import torch

        raw = torch.empty(nbytes + DIRECT_ALIGN, dtype=torch.uint8,
                          pin_memory=True).numpy()
    else:
        raw = np.empty(nbytes + DIRECT_ALIGN, np.uint8)
    off = (-raw.ctypes.data) % DIRECT_ALIGN
    return raw[off:off + nbytes]


def _buf_ptr(arr: np.ndarray):
    if not arr.flags["C_CONTIGUOUS"]:
        raise ValueError("aio buffers must be C-contiguous")
    return arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes


class aio_handle:
    """The reference's ``aio_handle`` surface: thread-pooled,
    chunk-parallel file I/O with sync and async calls."""

    def __init__(self, block_size: int = 1 << 20, queue_depth: int = 128,
                 thread_count: int = 8, use_odirect: bool = False):
        """``queue_depth``: io_uring ops in flight per worker."""
        self._lib = _ensure_built()
        self._h = self._lib.aio_create2(int(thread_count), int(block_size),
                                        int(bool(use_odirect)), -1,
                                        int(queue_depth))
        self.backend = ("uring" if self._lib.aio_backend(self._h) == 1
                        else "threadpool")
        # submitted buffers stay alive until wait(): the C side reads them
        self._live: dict = {}

    def close(self) -> None:
        if getattr(self, "_h", None):
            self._lib.aio_destroy(self._h)
            self._h = None

    def __del__(self):
        self.close()

    # -- sync ----------------------------------------------------------

    def sync_pread(self, buffer: np.ndarray, path: str,
                   offset: int = 0) -> int:
        ptr, n = _buf_ptr(buffer)
        st = self._lib.aio_pread(self._h, path.encode(), ptr, n, offset)
        if st != 0:
            raise OSError(-st, os.strerror(-st), path)
        return n

    def sync_pwrite(self, buffer: np.ndarray, path: str,
                    offset: int = 0) -> int:
        ptr, n = _buf_ptr(buffer)
        _pretruncate(path, offset + n, exact=offset == 0)
        st = self._lib.aio_pwrite(self._h, path.encode(), ptr, n, offset)
        if st != 0:
            raise OSError(-st, os.strerror(-st), path)
        return n

    # -- async ---------------------------------------------------------

    def async_pread(self, buffer: np.ndarray, path: str,
                    offset: int = 0) -> int:
        ptr, n = _buf_ptr(buffer)
        op = self._lib.aio_submit_read(self._h, path.encode(), ptr, n,
                                       offset)
        self._live[op] = buffer
        return op

    def async_pwrite(self, buffer: np.ndarray, path: str,
                     offset: int = 0) -> int:
        ptr, n = _buf_ptr(buffer)
        # extend only: a shrink could cut an in-flight higher-offset chunk
        _pretruncate(path, offset + n, exact=False)
        op = self._lib.aio_submit_write(self._h, path.encode(), ptr, n,
                                        offset)
        self._live[op] = buffer
        return op

    def wait(self, op: int) -> int:
        st = self._lib.aio_wait(self._h, op)
        self._live.pop(op, None)
        if st != 0:
            raise OSError(-st, os.strerror(-st))
        return st


def _pretruncate(path: str, size: int, exact: bool = True) -> None:
    """Size the file before parallel chunk writes (chunk opens use
    O_CREAT without O_TRUNC: truncating per chunk would race).
    ``exact=False`` only ever extends, safe around in-flight writes;
    extensions go through the native ``aio_prealloc`` (fallocate), so the
    extents exist before the parallel writers reach them."""
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "ab"):
        pass
    cur = os.path.getsize(path)
    if cur < size:
        st = _ensure_built().aio_prealloc(path.encode(), size)
        if st != 0:
            raise OSError(-st, os.strerror(-st), path)
    elif cur > size and exact:
        os.truncate(path, size)
