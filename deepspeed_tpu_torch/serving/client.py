"""Asyncio SSE client + load generator for the network front door.

Measures what the server cannot: TTFT and TPOT **at the socket** —
wall-clock from the last request byte written to each SSE event
arriving, including HTTP parse, queueing, and kernel socket buffers.
The in-process bench numbers (``detail.frontdoor``'s control row) are
the same quantities without the network front door in the path; the
delta IS the front door's overhead.

Two load shapes:

- **closed-loop**: ``concurrency`` workers, each holding exactly one
  open stream, back-to-back for ``requests`` total — measures capacity
  at a fixed stream count.
- **open-loop Poisson**: arrivals at ``rate`` req/s from a seeded
  exponential inter-arrival clock, independent of completions — the
  honest latency-under-load shape (a closed loop self-throttles when
  the server slows down; an open loop keeps arriving).

``abort_after_events`` hard-aborts the TCP transport mid-stream after
N SSE events — the client half of disconnect-cancellation testing
(the server must reclaim the slot, pool pages and tiered spill state).
"""
from __future__ import annotations

import argparse
import asyncio
import json
import random
import time
from typing import Any, Callable, Dict, List, Optional

from deepspeed_tpu_torch.serving import protocol as proto

__all__ = ["sse_generate", "LoadGenerator", "bimodal_payload_fn",
           "percentile"]


def percentile(xs: List[float], q: float) -> float:
    """Nearest-rank percentile (no numpy needed client-side)."""
    if not xs:
        return float("nan")
    s = sorted(xs)
    i = min(int(q / 100.0 * len(s)), len(s) - 1)
    return s[i]


def bimodal_payload_fn(requests: int, *, short_len: int = 8,
                       long_len: int = 64, long_frac: float = 0.25,
                       max_new_tokens: int = 16, vocab: int = 64,
                       seed: int = 0,
                       deadline_ms: Optional[float] = None):
    """Seeded bimodal long-prefill / short-chat workload mix.

    Each request is independently a **long** prefill with probability
    ``long_frac`` (prompt length ``long_len``) or a **short** chat turn
    (``short_len``).  The split and every prompt token come from one
    ``random.Random(seed)`` stream, so the same seed reproduces the
    same workload byte-for-byte — required for bit-parity comparisons
    between serving topologies (fused vs. disaggregated) under the
    *same* traffic.

    Returns ``(payload_fn, kinds)``: the ``payload_fn`` to hand to
    :class:`LoadGenerator` and a per-request ``"long"``/``"short"``
    label list for phase-split latency reporting.
    """
    rng = random.Random(seed)
    kinds = ["long" if rng.random() < float(long_frac) else "short"
             for _ in range(int(requests))]
    prompts = [[rng.randrange(1, int(vocab)) for _ in
                range(long_len if k == "long" else short_len)]
               for k in kinds]

    def payload(i: int) -> Dict[str, Any]:
        p: Dict[str, Any] = {"prompt": prompts[i],
                             "max_new_tokens": int(max_new_tokens)}
        if deadline_ms is not None:
            p["deadline_ms"] = float(deadline_ms)
        return p

    return payload, kinds


async def sse_generate(host: str, port: int, payload: Dict[str, Any],
                       clock: Callable[[], float] = time.perf_counter,
                       abort_after_events: Optional[int] = None
                       ) -> Dict[str, Any]:
    """One ``POST /v1/generate`` over a raw socket; returns::

        {"status": int, "error": str|None, "tokens": [streamed...],
         "final": [prompt+generated]|None, "events": int,
         "ttft_s": float|None, "tpot_s": float|None, "total_s": float}

    ``ttft_s`` is last-request-byte -> first ``tokens`` event;
    ``tpot_s`` is the mean gap between streamed tokens after the
    first.  ``abort_after_events=N`` kills the TCP transport after N
    SSE events (disconnect-cancellation testing); the result then has
    ``error="client_abort"``.
    """
    body = json.dumps(payload).encode("utf-8")
    reader, writer = await asyncio.open_connection(host, port)
    out: Dict[str, Any] = {"status": 0, "error": None, "tokens": [],
                           "final": None, "events": 0, "ttft_s": None,
                           "tpot_s": None, "total_s": 0.0}
    t0 = clock()
    t_first: Optional[float] = None
    t_last: Optional[float] = None
    try:
        writer.write(
            b"POST /v1/generate HTTP/1.1\r\n"
            b"Host: " + host.encode("latin-1") + b"\r\n"
            b"Content-Type: application/json\r\n"
            b"Content-Length: " + str(len(body)).encode() + b"\r\n"
            b"Connection: close\r\n\r\n" + body)
        await writer.drain()
        t0 = clock()              # request fully written: the TTFT zero
        head = await reader.readuntil(b"\r\n\r\n")
        lines = head.decode("latin-1").split("\r\n")
        out["status"] = int(lines[0].split(" ")[1])
        headers = {}
        for ln in lines[1:]:
            if ":" in ln:
                k, _, v = ln.partition(":")
                headers[k.strip().lower()] = v.strip()
        if (out["status"] != 200
                or "text/event-stream" not in headers.get(
                    "content-type", "")):
            raw = await reader.read(int(headers.get("content-length",
                                                    65536)) or 65536)
            try:
                err = json.loads(raw.decode("utf-8"))
                out["error"] = err.get("error", "http_error")
                out["detail"] = err.get("detail", "")
                if out["status"] == 200:   # buffered (stream=false) reply
                    out["error"] = None
                    out["final"] = err.get("tokens")
            except (json.JSONDecodeError, UnicodeDecodeError):
                out["error"] = "http_error"
            return out
        parser = proto.SSEParser()
        while True:
            chunk = await reader.read(65536)
            if not chunk:
                if out["final"] is None and out["error"] is None:
                    out["error"] = "truncated_stream"
                return out
            for event, data in parser.feed(chunk):
                out["events"] += 1
                now = clock()
                if event == "tokens":
                    toks = json.loads(data)["tokens"]
                    if t_first is None:
                        t_first = now
                    t_last = now
                    out["tokens"].extend(int(t) for t in toks)
                elif event == "done":
                    obj = json.loads(data)
                    out["final"] = [int(t) for t in obj["tokens"]]
                    return out
                elif event == "error":
                    out["error"] = json.loads(data).get("error",
                                                        "error")
                    return out
                if (abort_after_events is not None
                        and out["events"] >= abort_after_events):
                    out["error"] = "client_abort"
                    writer.transport.abort()   # RST, not FIN: the
                    return out                 # rudest disconnect
    finally:
        out["total_s"] = clock() - t0
        if t_first is not None:
            out["ttft_s"] = t_first - t0
            n = len(out["tokens"])
            if n >= 2 and t_last is not None and t_last > t_first:
                out["tpot_s"] = (t_last - t_first) / (n - 1)
        try:
            writer.close()
        except Exception:
            pass


class LoadGenerator:
    """Drive a front door with N concurrent SSE streams and collect
    socket-level latency percentiles.

    Parameters
    ----------
    host / port:
        the front door.
    payload_fn:
        ``callable(i) -> dict`` building request ``i``'s JSON body
        (vary prompts for prefix-cache realism; keep them fixed for
        bit-parity checks).
    concurrency:
        closed-loop worker count == max open streams.
    rate:
        open-loop Poisson arrival rate (req/s); ``None`` (default)
        selects the closed loop.  Open-loop still caps open streams at
        ``concurrency`` (an arrival past the cap waits, and the wait
        shows up in TTFT — exactly what an overloaded open loop should
        report).
    seed:
        inter-arrival RNG seed (reproducible arrival process).
    kinds:
        optional per-request workload label (e.g. the ``"long"`` /
        ``"short"`` list from :func:`bimodal_payload_fn`); when given,
        the summary reports TTFT percentiles per label so a mixed
        workload's long-prefill tail doesn't hide inside the aggregate.
    """

    def __init__(self, host: str, port: int,
                 payload_fn: Callable[[int], Dict[str, Any]],
                 requests: int = 64, concurrency: int = 8,
                 rate: Optional[float] = None, seed: int = 0,
                 clock: Callable[[], float] = time.perf_counter,
                 kinds: Optional[List[str]] = None) -> None:
        self.host, self.port = host, int(port)
        self.payload_fn = payload_fn
        self.requests = int(requests)
        self.concurrency = max(int(concurrency), 1)
        self.rate = rate
        self.seed = int(seed)
        self.clock = clock
        self.kinds = list(kinds) if kinds is not None else None
        self.results: List[Dict[str, Any]] = []

    async def _one(self, i: int, sem: asyncio.Semaphore) -> None:
        async with sem:
            try:
                res = await sse_generate(self.host, self.port,
                                         self.payload_fn(i),
                                         clock=self.clock)
            except (OSError, asyncio.IncompleteReadError) as e:
                res = {"status": 0, "error": f"conn: {e}", "tokens": [],
                       "final": None, "events": 0, "ttft_s": None,
                       "tpot_s": None, "total_s": 0.0}
            res["i"] = i
            self.results.append(res)

    async def _run_async(self) -> None:
        sem = asyncio.Semaphore(self.concurrency)
        if self.rate is None:
            tasks = [asyncio.ensure_future(self._one(i, sem))
                     for i in range(self.requests)]
        else:
            rng = random.Random(self.seed)
            tasks = []
            for i in range(self.requests):
                tasks.append(asyncio.ensure_future(self._one(i, sem)))
                await asyncio.sleep(rng.expovariate(self.rate))
        await asyncio.gather(*tasks)

    def run(self) -> Dict[str, Any]:
        self.results = []
        t0 = self.clock()
        asyncio.run(self._run_async())
        wall = self.clock() - t0
        return self.summary(wall)

    def summary(self, wall_s: float) -> Dict[str, Any]:
        ok = [r for r in self.results if r["final"] is not None]
        errs: Dict[str, int] = {}
        for r in self.results:
            if r["error"]:
                errs[r["error"]] = errs.get(r["error"], 0) + 1
        ttft = [r["ttft_s"] * 1e3 for r in ok if r["ttft_s"] is not None]
        tpot = [r["tpot_s"] * 1e3 for r in ok if r["tpot_s"] is not None]
        by_kind: Dict[str, Any] = {}
        if self.kinds is not None:
            for kind in sorted(set(self.kinds)):
                ks = [r["ttft_s"] * 1e3 for r in ok
                      if r["ttft_s"] is not None
                      and r["i"] < len(self.kinds)
                      and self.kinds[r["i"]] == kind]
                by_kind[kind] = {
                    "requests": sum(1 for k in self.kinds if k == kind),
                    "ttft_ms_p50": round(percentile(ks, 50), 3),
                    "ttft_ms_p99": round(percentile(ks, 99), 3),
                }
        return {
            "mode": ("closed" if self.rate is None
                     else f"poisson@{self.rate:g}/s"),
            "requests": len(self.results), "completed": len(ok),
            "errors": errs, "concurrency": self.concurrency,
            "wall_s": round(wall_s, 3),
            "requests_per_s": round(len(ok) / wall_s, 3) if wall_s else 0.0,
            "tokens_streamed": sum(len(r["tokens"]) for r in ok),
            "ttft_ms_p50": round(percentile(ttft, 50), 3),
            "ttft_ms_p90": round(percentile(ttft, 90), 3),
            "ttft_ms_p99": round(percentile(ttft, 99), 3),
            "tpot_ms_p50": round(percentile(tpot, 50), 3),
            "tpot_ms_p99": round(percentile(tpot, 99), 3),
            **({"by_kind": by_kind} if by_kind else {}),
        }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="SSE load generator for the dstpu front door")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--rate", type=float, default=None,
                    help="open-loop Poisson arrival rate (req/s); "
                         "default closed-loop")
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-new-tokens", type=int, default=16)
    ap.add_argument("--vocab", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--long-frac", type=float, default=0.0,
                    help="bimodal mix: fraction of requests that are "
                         "long prefills (0 disables the mix)")
    ap.add_argument("--long-prompt-len", type=int, default=64,
                    help="prompt length of the long-prefill mode")
    args = ap.parse_args(argv)

    kinds: Optional[List[str]] = None
    if args.long_frac > 0.0:
        payload, kinds = bimodal_payload_fn(
            args.requests, short_len=args.prompt_len,
            long_len=args.long_prompt_len, long_frac=args.long_frac,
            max_new_tokens=args.max_new_tokens, vocab=args.vocab,
            seed=args.seed, deadline_ms=args.deadline_ms)
    else:
        rng = random.Random(args.seed)
        prompts = [[rng.randrange(1, args.vocab) for _ in
                    range(args.prompt_len)] for _ in range(args.requests)]

        def payload(i: int) -> Dict[str, Any]:
            p: Dict[str, Any] = {"prompt": prompts[i],
                                 "max_new_tokens": args.max_new_tokens}
            if args.deadline_ms is not None:
                p["deadline_ms"] = args.deadline_ms
            return p

    gen = LoadGenerator(args.host, args.port, payload,
                        requests=args.requests,
                        concurrency=args.concurrency, rate=args.rate,
                        seed=args.seed, kinds=kinds)
    summary = gen.run()
    print(json.dumps(summary, indent=2, sort_keys=True))
    return 0 if summary["completed"] == summary["requests"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
