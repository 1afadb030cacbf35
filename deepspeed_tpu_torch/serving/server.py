"""Network front door: stdlib-asyncio HTTP/1.1 + SSE endpoint over the
:class:`~.router.Router` — token streaming, cancellation, deadlines,
graceful drain.

Two threads, each owning exactly one world:

- the **asyncio loop thread** owns every socket: accept, parse, SSE
  writes, disconnect detection.  It never touches the router.
- the **router pump thread** owns ALL router state (the router's
  single-threaded-by-construction contract): it drains a command queue
  (submit / cancel / drain), runs ``pump``/``join`` rounds, and
  forwards the router's event stream.

Commands cross asyncio -> pump on a thread-safe ``queue.Queue``;
results and token events cross back via ``loop.call_soon_threadsafe``
into per-request ``asyncio.Queue``s, so tokens stream at HARVEST
granularity (the engine's deferred-harvest folding grain) with no
locks anywhere near engine or router state.

Capabilities the library layer cannot express:

- **client-disconnect cancellation**: an EOF watcher on every stream
  turns a vanished client into ``Router.cancel`` -> engine
  ``cancel(uid)`` — slot teardown, page refcount release, tiered-spill
  cleanup mid-decode, audit-clean under prefix-COW sharing.
- **deadlines as admission input**: ``deadline_ms`` rides into the
  router's typed admission (burned -> 429 ``DeadlineRejection``;
  expiring while queued -> SSE ``error`` event, never a slot).
- **graceful drain**: SIGTERM (``install_signal_handlers``) stops
  admission (503 + Retry-After), finishes every in-flight stream with
  zero dropped tokens, then runs the optional ``handoff`` callback on
  the pump thread — the place to hand prefix-cache-warm state to a
  successor via the router's existing ``retire_replica`` spill-format
  machinery.

Metrics (the process registry): ``dstpu_http_requests_total{code}``,
``dstpu_http_active_streams``, ``dstpu_http_stream_abort_total{reason}``
and socket-level ``dstpu_http_ttft_ms`` / ``dstpu_http_tpot_ms``
histograms; the same series names are recordable SLO objectives (fed
to the router's ``SLOSet`` on the pump thread).  Tracing: ``cat="http"``
accept/close instants and parse/admit/stream/flush spans; hard server
failures dump the flight ring with the active-connection table.
"""
from __future__ import annotations

import asyncio
import itertools
import queue
import signal
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np

from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.serving import protocol as proto
from deepspeed_tpu_torch.telemetry import flight, trace
from deepspeed_tpu_torch.telemetry import metrics as _metrics_mod

__all__ = ["FrontDoorServer"]


class _Stream:
    """Per-request bridge: the asyncio side awaits ``q``; the pump
    thread posts into it via ``call_soon_threadsafe``."""

    __slots__ = ("cid", "q", "rid")

    def __init__(self, cid: int, q: "asyncio.Queue") -> None:
        self.cid = cid
        self.q = q
        self.rid: Optional[int] = None


class FrontDoorServer:
    """Serve a router over HTTP/1.1 + SSE.

    Parameters
    ----------
    router:
        a :class:`~.router.Router`; the server flips its
        ``collect_events`` on and becomes the sole ``poll_events``
        consumer.  The caller keeps ownership (replicas are not closed
        on drain).
    host / port:
        bind address; ``port=0`` picks a free port (read it back from
        ``server.port`` after ``start()``).
    handoff:
        optional ``callable(router) -> Any`` run on the PUMP thread
        after drain completes (in-flight streams finished, admission
        closed) — e.g. ``lambda r: r.retire_replica("r0",
        target="r2")`` to hand prefix-cache-warm state to a successor.
        Its return value lands in ``handoff_result``.
    retry_after_s:
        ``Retry-After`` header value for 503 (draining) and 429
        responses.
    """

    def __init__(self, router: Any, host: str = "127.0.0.1",
                 port: int = 0, *, registry: Any = "auto",
                 retry_after_s: float = 2.0,
                 handoff: Optional[Callable[[Any], Any]] = None,
                 max_body: int = 1 << 20,
                 poll_interval_s: float = 0.005,
                 clock: Callable[[], float] = time.perf_counter) -> None:
        self.router = router
        router.collect_events = True
        self.host = host
        self.port = int(port)
        self.clock = clock
        self.retry_after_s = max(float(retry_after_s), 1.0)
        self.max_body = int(max_body)
        self._handoff = handoff
        self.handoff_result: Any = None
        self._poll = float(poll_interval_s)
        self._registry = registry

        self._cmds: "queue.Queue" = queue.Queue()
        self._streams: Dict[int, _Stream] = {}     # pump thread only
        self._cid = itertools.count()
        self._conns: Dict[int, Dict[str, Any]] = {}
        self._conns_lock = threading.Lock()
        self._handlers = 0                         # asyncio thread only

        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._server: Optional[asyncio.AbstractServer] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._pump_thread: Optional[threading.Thread] = None
        self._draining = False
        self._started = threading.Event()
        self._start_err: Optional[BaseException] = None
        self._aio_idle = threading.Event()
        self._drained = threading.Event()

    # -- metrics (resolved per observation: survives registry reset) -----

    def _reg(self):
        reg = self._registry
        if reg == "auto":
            reg = _metrics_mod.metrics
        return reg if (reg and getattr(reg, "enabled", False)) else None

    def _count_response(self, code: int) -> None:
        reg = self._reg()
        if reg and code:
            reg.counter("dstpu_http_requests_total",
                        "HTTP responses by status code",
                        labels=("code",)).labels(code=str(code)).inc()

    def _active_streams(self, delta: int) -> None:
        reg = self._reg()
        if reg:
            reg.gauge("dstpu_http_active_streams",
                      "SSE streams currently open").add(delta)

    def _count_abort(self, reason: str) -> None:
        reg = self._reg()
        if reg:
            reg.counter("dstpu_http_stream_abort_total",
                        "streams aborted before completion",
                        labels=("reason",)).labels(reason=reason).inc()

    def _observe_latency(self, name: str, value_ms: float) -> None:
        reg = self._reg()
        if reg:
            reg.histogram(f"dstpu_http_{name}",
                          f"socket-level {name} (ms)",
                          buckets=_metrics_mod.MS_BUCKETS
                          ).observe(value_ms)

    # -- lifecycle -------------------------------------------------------

    def start(self) -> "FrontDoorServer":
        """Bind, listen, and start the loop + pump threads; returns
        once the socket is accepting (``self.port`` is then real)."""
        if self._loop_thread is not None:
            raise RuntimeError("server already started")
        self._loop_thread = threading.Thread(
            target=self._run_loop, name="dstpu-frontdoor-aio",
            daemon=True)
        self._loop_thread.start()
        self._started.wait()
        if self._start_err is not None:
            raise RuntimeError(
                f"front door failed to bind {self.host}:{self.port}"
            ) from self._start_err
        self._pump_thread = threading.Thread(
            target=self._pump_loop, name="dstpu-frontdoor-pump",
            daemon=True)
        self._pump_thread.start()
        return self

    def install_signal_handlers(self,
                                signums: Tuple[int, ...] = (
                                    signal.SIGTERM,)) -> None:
        """SIGTERM -> ``begin_drain`` (rolling-restart contract).  Must
        run on the main thread (CPython's signal rule); the handler
        only flips flags and enqueues — safe at any interrupt point."""
        for s in signums:
            signal.signal(s, lambda _sig, _frm: self.begin_drain())

    def begin_drain(self) -> None:
        """Stop admitting (new requests get 503 + Retry-After), finish
        in-flight streams, then hand off + shut down.  Idempotent."""
        if self._draining:
            return
        self._draining = True
        self._cmds.put(("drain",))

    def wait_drained(self, timeout: Optional[float] = None) -> bool:
        return self._drained.wait(timeout)

    def serve_forever(self) -> None:
        """Blocking convenience for CLI use: start (if needed), then
        sleep until drained (SIGTERM or ``begin_drain``)."""
        if self._loop_thread is None:
            self.start()
        while not self._drained.wait(0.2):
            pass
        self.close()

    def close(self, timeout: float = 30.0) -> None:
        """Graceful teardown: drain, wait, join both threads.  The
        router and its replicas stay open (caller owns them)."""
        self.begin_drain()
        self._drained.wait(timeout)
        self._stop_loop()
        if self._loop_thread is not None:
            self._loop_thread.join(timeout=10.0)
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=10.0)

    @property
    def draining(self) -> bool:
        return self._draining

    def connection_table(self) -> List[Dict[str, Any]]:
        """Active-connection snapshot (rides flight dumps on server
        hard failures)."""
        now = self.clock()
        with self._conns_lock:
            rows = [dict(c) for c in self._conns.values()]
        for c in rows:
            c["age_s"] = round(now - c.pop("t_accept"), 3)
        return rows

    # -- pump thread: the only router caller -----------------------------

    def _pump_loop(self) -> None:
        r = self.router
        try:
            while True:
                busy = self._drain_cmds()
                if r.outstanding or r.queued:
                    r.pump()
                    r.join()
                    busy = True
                for ev in r.poll_events():
                    self._on_router_event(ev)
                if (self._draining and not r.outstanding
                        and self._cmds.empty() and not self._streams):
                    break
                if not busy:
                    try:
                        self._do_cmd(self._cmds.get(timeout=self._poll))
                    except queue.Empty:
                        pass
        except BaseException as e:
            flight.dump_on_fault(
                "frontdoor_pump_failure", e,
                extra={"active_connections": self.connection_table()})
            for st in list(self._streams.values()):
                self._post(st, ("error", "server_error"))
            self._streams.clear()
            self._drained.set()
            self._stop_loop()
            raise
        # graceful exit: wait for in-flight handlers to flush their
        # final SSE bytes before the listener goes away.  Keep draining
        # commands meanwhile — a handler that raced the drain flag gets
        # its DrainingRejection folded back instead of hanging on an
        # unserviced submit
        deadline = self.clock() + 60.0
        while True:
            if self._loop is not None:
                self._loop.call_soon_threadsafe(self._check_aio_idle)
            if (self._aio_idle.wait(timeout=0.02)
                    or self.clock() >= deadline):
                break
            self._drain_cmds()
        if self._handoff is not None:
            try:
                self.handoff_result = self._handoff(r)
            except Exception as e:
                flight.dump_on_fault(
                    "frontdoor_handoff_failure", e,
                    extra={"active_connections":
                           self.connection_table()})
        trace.event("http_drained", cat="http",
                    finished=int(r.stats_counters.get("finished", 0)))
        self._drained.set()
        self._stop_loop()

    def _drain_cmds(self) -> bool:
        busy = False
        while True:
            try:
                cmd = self._cmds.get_nowait()
            except queue.Empty:
                return busy
            self._do_cmd(cmd)
            busy = True

    def _do_cmd(self, cmd: Tuple) -> None:
        kind = cmd[0]
        r = self.router
        if kind == "submit":
            greq, st = cmd[1], cmd[2]
            try:
                rid = r.submit(np.asarray(greq.prompt, np.int32),
                               priority=greq.priority,
                               deadline_ms=greq.deadline_ms,
                               **greq.engine_kwargs())
            except Exception as e:
                self._post(st, ("rejected", e))
                return
            st.rid = rid
            self._streams[rid] = st
            self._post(st, ("accepted", rid))
        elif kind == "cancel":
            rid, reason = cmd[1], cmd[2]
            st = self._streams.pop(rid, None)
            if st is not None:
                r.cancel(rid)
                trace.event("http_cancel", cat="http", conn=st.cid,
                            rid=rid, reason=reason)
        elif kind == "drain":
            r.begin_drain()
            if self._loop is not None:
                self._loop.call_soon_threadsafe(self._check_aio_idle)
        elif kind == "observe":
            # SLOSet is single-threaded; socket latencies recorded here
            _, ttft_ms, tpot_ms = cmd
            if r.slo is not None:
                if ttft_ms is not None:
                    r.slo.record("http_ttft_ms", ttft_ms)
                if tpot_ms is not None:
                    r.slo.record("http_tpot_ms", tpot_ms)

    def _on_router_event(self, ev: Tuple[str, int, Any]) -> None:
        kind, rid, payload = ev
        st = self._streams.get(rid)
        if st is None:
            return
        if kind == "tokens":
            self._post(st, ("tokens", payload))
        elif kind == "finish":
            del self._streams[rid]
            self._post(st, ("finish", payload))
        elif kind == "deadline_expired":
            del self._streams[rid]
            self._post(st, ("expired", None))
        elif kind == "replica_death":
            # sampled request whose replica died mid-stream: replaying
            # on a survivor would contradict already-emitted tokens, so
            # the router failed it — surface a typed SSE error
            del self._streams[rid]
            self._post(st, ("replica_death", None))
        elif kind == "cancelled":
            # cancels originate from the handler; it stopped reading
            self._streams.pop(rid, None)

    def _post(self, st: _Stream, item: Tuple) -> None:
        loop = self._loop
        if loop is not None and not loop.is_closed():
            try:
                loop.call_soon_threadsafe(st.q.put_nowait, item)
            except RuntimeError:
                pass              # loop shut down mid-post

    # -- asyncio loop thread ---------------------------------------------

    def _run_loop(self) -> None:
        loop = asyncio.new_event_loop()
        self._loop = loop
        asyncio.set_event_loop(loop)
        try:
            self._server = loop.run_until_complete(asyncio.start_server(
                self._handle, self.host, self.port))
            self.port = self._server.sockets[0].getsockname()[1]
        except BaseException as e:
            self._start_err = e
            self._started.set()
            loop.close()
            return
        self._started.set()
        try:
            loop.run_forever()
        finally:
            self._server.close()
            loop.run_until_complete(self._server.wait_closed())
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop.run_until_complete(asyncio.gather(
                    *pending, return_exceptions=True))
            loop.close()

    def _stop_loop(self) -> None:
        loop = self._loop
        if loop is not None and loop.is_running():
            loop.call_soon_threadsafe(loop.stop)

    def _check_aio_idle(self) -> None:
        if self._draining and self._handlers == 0:
            self._aio_idle.set()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        cid = next(self._cid)
        self._handlers += 1
        conn = {"conn": cid,
                "peer": str(writer.get_extra_info("peername")),
                "path": "", "rid": None, "state": "accept",
                "tokens_streamed": 0, "t_accept": self.clock()}
        with self._conns_lock:
            self._conns[cid] = conn
        if trace.enabled:
            trace.event("http_accept", cat="http", conn=cid)
        code = 0
        try:
            code = await self._route(reader, writer, conn)
        except (ConnectionResetError, BrokenPipeError, OSError):
            pass                  # client went away; nothing to answer
        except asyncio.CancelledError:
            raise                 # loop shutdown
        except Exception as e:
            flight.dump_on_fault(
                "http_handler_failure", e,
                extra={"active_connections": self.connection_table()})
            code = 500
            try:
                writer.write(proto.json_response(
                    500, {"error": "internal_error"}))
                await writer.drain()
            except Exception:
                pass
        finally:
            self._count_response(code)
            if trace.enabled:
                trace.event("http_close", cat="http", conn=cid,
                            code=int(code))
            try:
                writer.close()
            except Exception:
                pass
            with self._conns_lock:
                self._conns.pop(cid, None)
            self._handlers -= 1
            self._check_aio_idle()

    async def _route(self, reader, writer, conn) -> int:
        cid = conn["conn"]
        t0 = self.clock()
        try:
            hreq = await proto.read_request(reader, self.max_body)
        except proto.ProtocolError as e:
            writer.write(proto.json_response(
                e.status, {"error": "protocol_error",
                           "detail": str(e)}))
            await writer.drain()
            return e.status
        finally:
            if trace.enabled:
                trace.add_complete("http_parse", t0, self.clock() - t0,
                                   cat="http", conn=cid)
        if hreq is None:
            return 0              # clean EOF before any bytes
        conn["path"] = hreq.path
        if hreq.path == "/healthz":
            if self._draining:
                writer.write(proto.json_response(
                    503, {"status": "draining"},
                    extra_headers=(("Retry-After",
                                    str(int(self.retry_after_s))),)))
                await writer.drain()
                return 503
            writer.write(proto.json_response(
                200, {"status": "ok",
                      "replicas": len(self.router.handles)}))
            await writer.drain()
            return 200
        if hreq.path == "/metrics":
            reg = self._reg()
            body = (reg.export_text() if reg else "").encode("utf-8")
            writer.write(proto.response(
                200, body, content_type="text/plain; version=0.0.4"))
            await writer.drain()
            return 200
        if hreq.path == "/v1/generate":
            if hreq.method != "POST":
                writer.write(proto.json_response(
                    405, {"error": "method_not_allowed"}))
                await writer.drain()
                return 405
            return await self._generate(hreq, reader, writer, conn)
        writer.write(proto.json_response(404, {"error": "not_found"}))
        await writer.drain()
        return 404

    # -- /v1/generate ----------------------------------------------------

    async def _generate(self, hreq, reader, writer, conn) -> int:
        cid = conn["conn"]
        retry = (("Retry-After", str(int(self.retry_after_s))),)
        if self._draining:
            writer.write(proto.json_response(
                503, {"error": "DrainingRejection",
                      "detail": "server is draining"},
                extra_headers=retry))
            await writer.drain()
            return 503
        try:
            greq = proto.GenerateRequest.from_body(hreq.body)
        except proto.ProtocolError as e:
            writer.write(proto.json_response(
                e.status, {"error": "bad_request", "detail": str(e)}))
            await writer.drain()
            return e.status
        st = _Stream(cid, asyncio.Queue())
        t_admit = self.clock()
        conn["state"] = "admit"
        self._cmds.put(("submit", greq, st))
        kind, payload = await st.q.get()
        if trace.enabled:
            trace.add_complete("http_admit", t_admit,
                               self.clock() - t_admit, cat="http",
                               conn=cid, accepted=kind == "accepted")
        if kind == "rejected":
            code, etype = proto.rejection_status(payload)
            if code == 500:
                flight.dump_on_fault(
                    "http_submit_failure", payload,
                    extra={"active_connections":
                           self.connection_table()})
            writer.write(proto.json_response(
                code, {"error": etype, "detail": str(payload)},
                extra_headers=retry if code in (429, 503) else ()))
            await writer.drain()
            return code
        rid = payload
        conn["rid"] = rid
        conn["state"] = "stream"
        if greq.stream:
            return await self._stream_sse(
                st, greq, reader, writer, conn, t_admit)
        return await self._respond_buffered(
            st, reader, writer, conn, t_admit)

    async def _watch_disconnect(self, reader) -> None:
        """Resolves when the peer goes away (EOF or reset).  With the
        request body fully consumed, any further bytes are junk — only
        the connection state matters."""
        try:
            while True:
                b = await reader.read(65536)
                if not b:
                    return
        except Exception:
            return

    async def _stream_sse(self, st, greq, reader, writer, conn,
                          t_admit) -> int:
        cid, rid = conn["conn"], st.rid
        self._active_streams(+1)
        writer.write(proto.sse_preamble())
        await writer.drain()
        t_stream0 = self.clock()
        t_first: Optional[float] = None
        t_last: Optional[float] = None
        ntok = 0
        abort: Optional[str] = None
        final: Optional[List[int]] = None
        watcher = asyncio.ensure_future(self._watch_disconnect(reader))
        try:
            while True:
                getter = asyncio.ensure_future(st.q.get())
                done, _ = await asyncio.wait(
                    {getter, watcher},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    abort = "client_disconnect"
                    break
                kind, payload = getter.result()
                now = self.clock()
                if kind == "tokens":
                    toks = [int(t) for t in payload]
                    if t_first is None:
                        t_first = now
                        self._observe_latency(
                            "ttft_ms", (now - t_admit) * 1e3)
                    t_last = now
                    ntok += len(toks)
                    conn["tokens_streamed"] = ntok
                    try:
                        d = faults.hook("http.flush", conn=cid, rid=rid)
                        if d is not None and d[0] in ("hang", "slow"):
                            await asyncio.sleep(float(d[1]))
                        writer.write(proto.sse_event(
                            "tokens", {"tokens": toks}))
                        await writer.drain()
                    except (ConnectionResetError, BrokenPipeError,
                            OSError):
                        abort = "write_error"
                        break
                elif kind == "finish":
                    final = [int(t) for t in payload]
                    break
                elif kind == "expired":
                    abort = "deadline_expired"
                    break
                elif kind == "replica_death":
                    abort = "replica_death"
                    break
                else:             # ("error", reason) — pump failure
                    abort = str(payload)
                    break
        finally:
            watcher.cancel()
            self._active_streams(-1)
        if final is not None:
            try:
                writer.write(proto.sse_event(
                    "done", {"tokens": final, "streamed": ntok}))
                if trace.enabled:
                    tf = self.clock()
                    await writer.drain()
                    trace.add_complete("http_flush", tf,
                                       self.clock() - tf, cat="http",
                                       conn=cid)
                else:
                    await writer.drain()
            except (ConnectionResetError, BrokenPipeError, OSError):
                abort = "write_error"
        if abort is not None:
            self._count_abort(abort)
            if abort in ("client_disconnect", "write_error"):
                # the router + engine reclaim the slot, pool pages and
                # any tiered spill state mid-decode
                self._cmds.put(("cancel", rid, abort))
            else:
                try:
                    writer.write(proto.sse_event("error",
                                                 {"error": abort}))
                    await writer.drain()
                except (ConnectionResetError, BrokenPipeError, OSError):
                    pass
        ttft_ms = ((t_first - t_admit) * 1e3
                   if t_first is not None else None)
        tpot_ms = None
        if (ntok >= 2 and t_first is not None and t_last is not None
                and t_last > t_first):
            tpot_ms = (t_last - t_first) * 1e3 / (ntok - 1)
            self._observe_latency("tpot_ms", tpot_ms)
        if ttft_ms is not None and self.router.slo is not None:
            self._cmds.put(("observe", ttft_ms, tpot_ms))
        if trace.enabled:
            trace.add_complete("http_stream", t_stream0,
                               self.clock() - t_stream0, cat="http",
                               conn=cid, tokens=ntok,
                               abort=abort or "")
        return 200

    async def _respond_buffered(self, st, reader, writer, conn,
                                t_admit) -> int:
        """``stream: false`` — buffer the whole generation, answer one
        JSON body (deadline expiry still gets its typed 429; a
        disconnect still cancels)."""
        rid = st.rid
        watcher = asyncio.ensure_future(self._watch_disconnect(reader))
        final: Optional[List[int]] = None
        abort: Optional[str] = None
        ntok = 0
        try:
            while True:
                getter = asyncio.ensure_future(st.q.get())
                done, _ = await asyncio.wait(
                    {getter, watcher},
                    return_when=asyncio.FIRST_COMPLETED)
                if getter not in done:
                    getter.cancel()
                    abort = "client_disconnect"
                    break
                kind, payload = getter.result()
                if kind == "tokens":
                    ntok += len(payload)
                elif kind == "finish":
                    final = [int(t) for t in payload]
                    break
                elif kind == "expired":
                    abort = "deadline_expired"
                    break
                elif kind == "replica_death":
                    abort = "replica_death"
                    break
                else:
                    abort = str(payload)
                    break
        finally:
            watcher.cancel()
        if abort is not None:
            self._count_abort(abort)
            if abort == "client_disconnect":
                self._cmds.put(("cancel", rid, abort))
                return 0
            code = 429 if abort == "deadline_expired" else 500
            writer.write(proto.json_response(
                code, {"error": ("DeadlineRejection" if code == 429
                                 else abort if abort == "replica_death"
                                 else "internal_error"),
                       "detail": abort}))
            await writer.drain()
            return code
        self._observe_latency("ttft_ms",
                              (self.clock() - t_admit) * 1e3)
        writer.write(proto.json_response(200, {"tokens": final}))
        await writer.drain()
        return 200
