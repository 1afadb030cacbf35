"""Deterministic fault injection.

Copy of ``deepspeed_tpu/resilience/faults.py`` for the sites and fault
kinds the port has: production code calls the cheap :func:`hook` (a
no-op while no injector is active), and an active :class:`FaultInjector`
turns chosen firings into transient ``OSError`` s, torn writes,
simulated process death, or a directive a collective honours,
reproducibly, keyed only on the per-site call count and the injector's
seed.

Instrumented sites:

========================  ==================================================
``ckpt.write_blob``       once per blob-write attempt (retry target)
``ckpt.write_record``     before each record buffer is written (torn/crash)
``ckpt.write_index``      before the manifest JSON is written
``ckpt.commit``           just before the atomic staging->tag rename
``ckpt.read_record``      before each shard-record read (retry target)
``swap.write_bucket``     before each NVMe moment-bucket write submit
                          (runtime/swap_tensor.py; the async submit and
                          its blocking retry alike): ``torn`` writes a
                          fraction then dies, ``oserror`` fails the op
``swap.read_bucket``      after each bucket read completes, before its
                          checksum check; fires again per blocking
                          re-read, so ``count`` models a transient flip
                          (healed) or a persistent one (quarantine,
                          ``SwapCorruptionError``)
``swap.write_item``       before each moment range the swapped tier
                          writes outside the step (a checkpoint load)
``swap.read_item``        after each moment range the swapped tier reads
                          outside the step (a checkpoint save), before
                          its checksum check (and per re-read)
``comm.all_reduce``       once per all_reduce call (comm/comm.py)
``comm.all_gather``       once per all_gather call
``comm.reduce_scatter``   once per reduce_scatter call
``comm.broadcast``        once per broadcast call
``comm.all_to_all``       once per all_to_all call
``comm.ppermute``         once per ppermute call
``comm.barrier``          once per ``comm.barrier()`` call
``kv.read_page``          per spilled-KV page per restore attempt
                          (inference/kv_tiering.py), before the page's
                          digest check; fires again per re-read, so
                          ``count`` models a transient flip (healed) or a
                          persistent one (quarantine, re-prefill)
``kv.write``              per tiered-KV NVMe write submit (spill
                          write-back and the degraded-mode probe):
                          ``io_error`` models a failing device
``handoff.import``        once per session at the decode-role replica's
                          handoff import (inference/v2/ragged_engine.py
                          ``import_handoff``), before the payload is
                          installed: ``bitflip`` corrupts the wire
                          payload (the donor's digests then fail the
                          restore: re-read, quarantine, re-prefill),
                          ``io_error``/``crash`` kill the import op
``router.dispatch``       once per router->replica dispatch
                          (serving/router.py ``_send``): ``io_error``
                          kills the dispatch, ``slow`` delays it
``replica.step``          once per engine step op on the replica thread
                          (serving/replica_set.py): ``crash``/``io_error``
                          is a replica dying mid-decode
``replica.hang``          beside ``replica.step``: ``hang``/``slow`` sleep
                          ``param`` seconds on the replica thread (a
                          wedged decode, the serving watchdog's quarry)
``http.flush``            before each SSE token-event flush
                          (serving/server.py): ``io_error`` breaks the
                          client socket mid-stream, ``slow`` delays it
========================  ==================================================

Fault kinds:

``oserror``   raise a transient ``OSError`` (retry/backoff target)
``torn``      write only ``param`` fraction of the bytes, then die
``crash``     raise :class:`SimulatedCrash` (process death mid-op)
``sigterm``   deliver a real SIGTERM (the preemption handler's quarry)
``corrupt``   comm sites: scale ``param`` fraction of this rank's result
              of the collective (a lossy link delivering corrupted data
              to one receiver: the desync detector's quarry)
``straggle``  comm sites: sleep ``param`` seconds before joining the
              collective (a slow rank; peers stall waiting for it)
``drop``      comm sites: skip the collective entirely on this rank, so
              peers hang in it (the collective watchdog's quarry)
``bitflip``   swap and kv read sites: flip ``param`` random bit(s) of
              the buffer just read (:func:`apply_bitflip`; silent
              corruption); :func:`flip_bit_in_file` models corruption
              on the media, which every re-read returns
``io_error``  raise ``OSError(EIO)``: a hard device error, which the KV
              tiers count toward their degraded mode and the serving
              death paths key on
``hang``      serving sites: sleep ``param`` seconds at the site (a
              wedged op, finite so tests end, longer than any watchdog
              deadline under test)
``slow``      serving sites: sleep ``param`` seconds (a straggling
              replica or socket, below the watchdog deadline)

A fault is scheduled with ``inject(site, kind, ...)`` (or the named
helpers); ``after`` skips that many firings first and ``count`` bounds
how many firings trigger.  Only one injector may be active per process.
:func:`FaultInjector.from_spec` parses the reference's wire format for
faults handed to worker processes.
"""
from __future__ import annotations

import errno
import os
import random
import signal
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["FaultInjector", "SimulatedCrash", "hook", "active",
           "apply_bitflip", "flip_bit_in_file"]


class SimulatedCrash(BaseException):
    """Emulates process death mid-operation.  Derives from
    ``BaseException`` so ordinary ``except Exception`` recovery/retry
    paths cannot swallow it — a real SIGKILL would not run them
    either."""


class _Fault:
    __slots__ = ("site", "kind", "count", "after", "param")

    def __init__(self, site: str, kind: str, count: int, after: int,
                 param: float):
        self.site = site
        self.kind = kind
        self.count = count          # remaining firings that trigger
        self.after = after          # firings to skip before arming
        self.param = param          # torn/corrupt: fraction; straggle: s


class FaultInjector:
    """Seeded, deterministic injector; use as a context manager.

    ``fired`` records every triggered fault as ``(site, kind, call#)``."""

    KINDS = ("oserror", "torn", "crash", "sigterm", "corrupt", "straggle",
             "drop", "bitflip", "io_error", "hang", "slow")

    def __init__(self, seed: int = 0):
        self.rng = random.Random(seed)
        self.faults: List[_Fault] = []
        self.calls: Dict[str, int] = {}
        self.fired: List[Tuple[str, str, int]] = []

    # -- scheduling -------------------------------------------------------

    def inject(self, site: str, kind: str, count: int = 1, after: int = 0,
               fraction: float = 0.5,
               param: Optional[float] = None) -> "FaultInjector":
        assert kind in self.KINDS, kind
        self.faults.append(_Fault(site, kind, count, after,
                                  fraction if param is None else param))
        return self

    def transient_oserror(self, site: str, count: int,
                          after: int = 0) -> "FaultInjector":
        """Raise ``OSError`` at the next ``count`` firings of ``site``
        (then heal)."""
        return self.inject(site, "oserror", count=count, after=after)

    def torn_write(self, site: str = "ckpt.write_record", after: int = 0,
                   fraction: float = 0.5) -> "FaultInjector":
        """Write only ``fraction`` of one record's bytes, then die."""
        return self.inject(site, "torn", after=after, fraction=fraction)

    def crash(self, site: str, after: int = 0) -> "FaultInjector":
        """Simulated process death at ``site``."""
        return self.inject(site, "crash", after=after)

    def sigterm(self, site: str, after: int = 0) -> "FaultInjector":
        """Deliver a real SIGTERM to this process when ``site`` fires
        (exercises an installed preemption handler)."""
        return self.inject(site, "sigterm", after=after)

    def corrupt(self, site: str, fraction: float = 0.05, after: int = 0,
                count: int = 1) -> "FaultInjector":
        """Corrupt ``fraction`` of this rank's collective result."""
        return self.inject(site, "corrupt", count=count, after=after,
                           param=fraction)

    def straggle(self, site: str, delay_s: float = 0.25, after: int = 0,
                 count: int = 1) -> "FaultInjector":
        """Delay this rank ``delay_s`` seconds before it joins the
        collective."""
        return self.inject(site, "straggle", count=count, after=after,
                           param=delay_s)

    def drop(self, site: str, after: int = 0,
             count: int = 1) -> "FaultInjector":
        """Skip the collective on this rank; peers hang in it until a
        watchdog deadline fires."""
        return self.inject(site, "drop", count=count, after=after)

    def io_error(self, site: str, after: int = 0,
                 count: int = 1) -> "FaultInjector":
        """Raise a hard ``OSError(EIO)`` at ``site``: a failing device
        (against :meth:`transient_oserror`); repeated firings trip the
        KV tiers' degraded mode."""
        return self.inject(site, "io_error", count=count, after=after)

    def hang(self, site: str, seconds: float = 2.0, after: int = 0,
             count: int = 1) -> "FaultInjector":
        """Wedge ``site`` for ``seconds`` (a sleep on the site's thread):
        long enough to blow any watchdog deadline under test, finite so
        the abandoned thread ends."""
        return self.inject(site, "hang", count=count, after=after,
                           param=seconds)

    def slow(self, site: str, seconds: float = 0.1, after: int = 0,
             count: int = 1) -> "FaultInjector":
        """Delay ``site`` by ``seconds``: a straggler below the watchdog
        deadline (the hedging threshold's quarry)."""
        return self.inject(site, "slow", count=count, after=after,
                           param=seconds)

    def bitflip(self, site: str, bits: int = 1, after: int = 0,
                count: int = 1) -> "FaultInjector":
        """Flip ``bits`` random bit(s) of the buffer a read site just
        filled (silent corruption between the tier and the device).
        ``count=1`` models a transient flip (a re-read returns clean
        bytes); a large ``count`` corrupts every re-read too, the
        quarantine path's quarry."""
        return self.inject(site, "bitflip", count=count, after=after,
                           param=bits)

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        """Parse the subprocess wire format: ``;``-separated faults, each
        a whitespace/comma-separated list of ``key=value`` tokens —
        ``site=`` and ``kind=`` required; ``after=``, ``count=``,
        ``param=`` optional; for ``hang``/``slow`` it is the delay in
        seconds, 2.0 when omitted.  Examples::

            site=comm.all_reduce kind=corrupt after=1 param=0.5
            site=replica.hang kind=hang after=3 param=2.5
        """
        inj = cls(seed=seed)
        for part in spec.split(";"):
            part = part.strip()
            if not part:
                continue
            kv: Dict[str, str] = {}
            for tok in part.replace(",", " ").split():
                k, eq, v = tok.partition("=")
                if eq != "=":
                    raise ValueError(f"bad fault-spec token {tok!r} in "
                                     f"{spec!r}")
                kv[k] = v
            if "site" not in kv or "kind" not in kv:
                raise ValueError(f"fault spec needs site= and kind=: "
                                 f"{part!r}")
            inj.inject(kv["site"], kv["kind"],
                       count=int(kv.get("count", 1)),
                       after=int(kv.get("after", 0)),
                       param=(float(kv["param"]) if "param" in kv
                              else 2.0 if kv["kind"] in ("hang", "slow")
                              else None))
        return inj

    # -- firing -----------------------------------------------------------

    def fire(self, site: str, **ctx: Any) -> Optional[Tuple[str, float]]:
        n = self.calls[site] = self.calls.get(site, 0) + 1
        for f in self.faults:
            if f.site != site or f.count <= 0:
                continue
            if f.after > 0:
                f.after -= 1
                continue
            f.count -= 1
            self.fired.append((site, f.kind, n))
            if f.kind == "oserror":
                raise OSError(f"[fault-injection] transient I/O error at "
                              f"{site} (call {n})")
            if f.kind == "io_error":
                raise OSError(errno.EIO, f"[fault-injection] hard I/O "
                              f"error at {site} (call {n})")
            if f.kind == "crash":
                raise SimulatedCrash(f"[fault-injection] crash at {site} "
                                     f"(call {n})")
            if f.kind == "sigterm":
                signal.raise_signal(signal.SIGTERM)
                return None
            # directives the site honours: torn (fraction of bytes kept),
            # corrupt (fraction of payload), straggle (delay seconds),
            # drop (skip the op), bitflip (bits to flip in the buffer
            # just read)
            return (f.kind, f.param)
        return None

    # -- install ----------------------------------------------------------

    def __enter__(self) -> "FaultInjector":
        global _ACTIVE
        assert _ACTIVE is None, "a FaultInjector is already active"
        _ACTIVE = self
        return self

    def __exit__(self, *exc) -> None:
        global _ACTIVE
        _ACTIVE = None


_ACTIVE: Optional[FaultInjector] = None


def active() -> Optional[FaultInjector]:
    return _ACTIVE


def hook(site: str, **ctx: Any) -> Optional[Tuple[str, float]]:
    """Instrumentation point.  Returns ``None`` (the common disarmed
    case), raises an injected failure, or returns a ``(kind, param)``
    directive the site must honour: ``("torn", fraction)`` at write
    sites; ``("corrupt", fraction)``, ``("straggle", delay_s)`` or
    ``("drop", 0)`` at comm sites; ``("bitflip", bits)`` at kv read sites
    (honoured via :func:`apply_bitflip`)."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.fire(site, **ctx)


def apply_bitflip(buf, nbits: float) -> None:
    """Honour a ``("bitflip", nbits)`` directive: flip ``nbits`` random
    bit(s) of ``buf`` (a contiguous numpy array) in place, at positions
    drawn from the active injector's seeded rng, so the corruption is
    reproducible from the seed alone."""
    import numpy as np

    rng = _ACTIVE.rng if _ACTIVE is not None else random.Random(0)
    view = buf.reshape(-1).view(np.uint8)
    for _ in range(max(1, int(nbits))):
        i = rng.randrange(view.size)
        view[i] ^= np.uint8(1 << rng.randrange(8))


def flip_bit_in_file(path: str, bit: Optional[int] = None,
                     seed: int = 0) -> int:
    """Flip one bit of ``path`` in place: corruption on the media, which
    every re-read returns (unlike the transient ``bitflip`` kind).
    ``bit`` is the absolute bit index; ``None`` picks one from ``seed``.
    Returns the flipped bit's index."""
    nbits = os.path.getsize(path) * 8
    if nbits == 0:
        raise ValueError(f"cannot flip a bit in the empty file {path}")
    if bit is None:
        bit = random.Random(seed).randrange(nbits)
    with open(path, "rb+") as f:
        f.seek(bit // 8)
        byte = f.read(1)[0]
        f.seek(bit // 8)
        f.write(bytes([byte ^ (1 << (bit % 8))]))
    return bit
