"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each kernel source under ``ops/csrc/`` has a plain C interface and builds
into its own shared library for ``sm_90a`` (Hopper).  Libraries go into
``ops/build/`` (git-ignored), named by a hash of the source and the flags,
so a changed source rebuilds and an unchanged one loads at once.  Nothing
builds at import: a kernel's wrapper calls :func:`load` at its first
launch, and :func:`build_all` starts every ``nvcc`` together when a caller
wants the whole set up front.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    """One built kernel library: its path, the seconds ``nvcc`` took (0
    when it was already built) and what ``ptxas -v`` reported."""

    path: Path
    seconds: float
    log: str


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (set CUDA_HOME): the port's CUDA kernels are "
            "built from source at first use")
    return found


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:16]}.so"


def build_all(names: Iterable[str]) -> Dict[str, Built]:
    """Build the named kernels (``csrc/<name>.cu``), one ``nvcc`` per
    source, all started together.  Raises if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    done: Dict[str, Built] = {}
    t0 = time.perf_counter()
    for name in names:
        out = _target(name)
        if out.exists():
            done[name] = Built(out, 0.0, "")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs[name] = (out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, out)        # atomic: a reader never sees half a file
        done[name] = Built(out, time.perf_counter() - t0, log)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return done


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed."""
    return ctypes.CDLL(str(build_all([name])[name].path))
