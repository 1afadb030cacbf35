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
``comm.all_reduce``       once per all_reduce call (comm/comm.py)
``comm.all_gather``       once per all_gather call
``comm.reduce_scatter``   once per reduce_scatter call
``comm.broadcast``        once per broadcast call
``comm.all_to_all``       once per all_to_all call
``comm.ppermute``         once per ppermute call
``comm.barrier``          once per ``comm.barrier()`` call
========================  ==================================================

The swap sites (``swap.*``) come with ROADMAP A11, the KV-tier, handoff
and serving sites with A9 and A10, and with them the kinds that only
those sites honour (``sigterm``, ``io_error``, ``bitflip``, ``hang``,
``slow``).

Fault kinds:

``oserror``   raise a transient ``OSError`` (retry/backoff target)
``torn``      write only ``param`` fraction of the bytes, then die
``crash``     raise :class:`SimulatedCrash` (process death mid-op)
``corrupt``   comm sites: scale ``param`` fraction of this rank's result
              of the collective (a lossy link delivering corrupted data
              to one receiver: the desync detector's quarry)
``straggle``  comm sites: sleep ``param`` seconds before joining the
              collective (a slow rank; peers stall waiting for it)
``drop``      comm sites: skip the collective entirely on this rank, so
              peers hang in it (the collective watchdog's quarry)

A fault is scheduled with ``inject(site, kind, ...)`` (or the named
helpers); ``after`` skips that many firings first and ``count`` bounds
how many firings trigger.  Only one injector may be active per process.
:func:`FaultInjector.from_spec` parses the reference's wire format for
faults handed to worker processes.
"""
from __future__ import annotations

import random
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["FaultInjector", "SimulatedCrash", "hook", "active"]


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

    KINDS = ("oserror", "torn", "crash", "corrupt", "straggle", "drop")

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

    @classmethod
    def from_spec(cls, spec: str, seed: int = 0) -> "FaultInjector":
        """Parse the subprocess wire format: ``;``-separated faults, each
        a whitespace/comma-separated list of ``key=value`` tokens —
        ``site=`` and ``kind=`` required; ``after=``, ``count=``,
        ``param=`` optional.  Example::

            site=comm.all_reduce kind=corrupt after=1 param=0.5
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
                       param=float(kv["param"]) if "param" in kv else None)
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
            if f.kind == "crash":
                raise SimulatedCrash(f"[fault-injection] crash at {site} "
                                     f"(call {n})")
            # directives the site honours: torn (fraction of bytes kept),
            # corrupt (fraction of payload), straggle (delay seconds),
            # drop (skip the op)
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
    ``("drop", 0)`` at comm sites."""
    if _ACTIVE is None:
        return None
    return _ACTIVE.fire(site, **ctx)
