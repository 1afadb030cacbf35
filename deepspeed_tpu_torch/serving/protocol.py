"""Wire protocol for the network front door: stdlib HTTP/1.1 + SSE.

No dependencies beyond asyncio's stream API — the server and client
both speak through these helpers, so the SSE framing and the request
schema are defined exactly once.

API schema (``POST /v1/generate``, JSON body)::

    {"prompt": [1, 17, 3, ...],        # required, non-empty int list
     "max_new_tokens": 64,             # optional
     "deadline_ms": 250.0,             # optional admission deadline
     "priority": 0,                    # optional router priority
     "stream": true,                   # SSE (default) vs buffered JSON
     "eos_token_id": 2,                # optional sampling params ...
     "do_sample": false, "temperature": 1.0, "top_k": 0, "top_p": 1.0}

SSE wire format (``Content-Type: text/event-stream``), one ``tokens``
event per engine HARVEST (the deferred-harvest pipeline's folding
grain — the honest streaming granularity), then exactly one terminal
event::

    event: tokens
    data: {"tokens": [437, 12]}

    event: done
    data: {"tokens": [<prompt + all generated>], "streamed": 12}

    event: error
    data: {"error": "deadline_expired"}
"""
from __future__ import annotations

import asyncio
import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

__all__ = ["ProtocolError", "HttpRequest", "GenerateRequest",
           "read_request", "sse_event", "sse_preamble", "SSEParser",
           "response", "json_response", "rejection_status", "REASONS"]

REASONS = {200: "OK", 400: "Bad Request", 404: "Not Found",
           405: "Method Not Allowed", 413: "Payload Too Large",
           429: "Too Many Requests", 500: "Internal Server Error",
           503: "Service Unavailable"}


class ProtocolError(ValueError):
    """Malformed HTTP or request schema; carries the response code."""

    def __init__(self, msg: str, status: int = 400) -> None:
        super().__init__(msg)
        self.status = int(status)


@dataclasses.dataclass
class HttpRequest:
    method: str
    target: str
    path: str
    query: Dict[str, str]
    headers: Dict[str, str]              # keys lower-cased
    body: bytes


async def read_request(reader: asyncio.StreamReader,
                       max_body: int = 1 << 20
                       ) -> Optional[HttpRequest]:
    """Parse one HTTP/1.1 request off ``reader``.  Returns None on a
    clean EOF before any bytes (client connected and left); raises
    :class:`ProtocolError` on anything malformed."""
    try:
        head = await reader.readuntil(b"\r\n\r\n")
    except asyncio.IncompleteReadError as e:
        if not e.partial:
            return None
        raise ProtocolError("truncated request head")
    except asyncio.LimitOverrunError:
        raise ProtocolError("request head too large", status=413)
    lines = head.decode("latin-1").split("\r\n")
    parts = lines[0].split(" ")
    if len(parts) != 3 or not parts[2].startswith("HTTP/1."):
        raise ProtocolError(f"bad request line {lines[0]!r}")
    method, target = parts[0].upper(), parts[1]
    path, _, qs = target.partition("?")
    query: Dict[str, str] = {}
    for kv in qs.split("&"):
        if kv:
            k, _, v = kv.partition("=")
            query[k] = v
    headers: Dict[str, str] = {}
    for line in lines[1:]:
        if not line:
            continue
        k, sep, v = line.partition(":")
        if not sep:
            raise ProtocolError(f"bad header line {line!r}")
        headers[k.strip().lower()] = v.strip()
    body = b""
    if "content-length" in headers:
        try:
            n = int(headers["content-length"])
        except ValueError:
            raise ProtocolError("bad Content-Length")
        if n < 0 or n > max_body:
            raise ProtocolError(f"body of {n} bytes exceeds the "
                                f"{max_body}-byte cap", status=413)
        try:
            body = await reader.readexactly(n)
        except asyncio.IncompleteReadError:
            raise ProtocolError("body shorter than Content-Length")
    return HttpRequest(method, target, path, query, headers, body)


_GEN_FIELDS = {"prompt", "max_new_tokens", "deadline_ms", "priority",
               "stream", "eos_token_id", "do_sample", "temperature",
               "top_k", "top_p"}


@dataclasses.dataclass
class GenerateRequest:
    """Validated ``/v1/generate`` body (the engine-facing half of the
    schema maps 1:1 onto ``put_request`` kwargs)."""

    prompt: List[int]
    max_new_tokens: int = 64
    deadline_ms: Optional[float] = None
    priority: int = 0
    stream: bool = True
    eos_token_id: Optional[int] = None
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0

    @classmethod
    def from_body(cls, body: bytes) -> "GenerateRequest":
        try:
            obj = json.loads(body.decode("utf-8") or "null")
        except (UnicodeDecodeError, json.JSONDecodeError) as e:
            raise ProtocolError(f"body is not valid JSON: {e}")
        if not isinstance(obj, dict):
            raise ProtocolError("body must be a JSON object")
        unknown = sorted(set(obj) - _GEN_FIELDS)
        if unknown:
            raise ProtocolError(f"unknown fields {unknown} "
                                f"(have {sorted(_GEN_FIELDS)})")
        prompt = obj.get("prompt")
        if (not isinstance(prompt, list) or not prompt
                or not all(isinstance(t, int) and not isinstance(t, bool)
                           for t in prompt)):
            raise ProtocolError(
                "'prompt' must be a non-empty list of token ids (ints)")
        out = cls(prompt=[int(t) for t in prompt])
        for name, typ in (("max_new_tokens", int), ("priority", int),
                          ("top_k", int)):
            if name in obj:
                v = obj[name]
                if not isinstance(v, int) or isinstance(v, bool):
                    raise ProtocolError(f"'{name}' must be an int")
                setattr(out, name, typ(v))
        for name in ("deadline_ms", "temperature", "top_p"):
            if name in obj:
                v = obj[name]
                if isinstance(v, bool) or not isinstance(v, (int, float)):
                    raise ProtocolError(f"'{name}' must be a number")
                setattr(out, name, float(v))
        for name in ("stream", "do_sample"):
            if name in obj:
                if not isinstance(obj[name], bool):
                    raise ProtocolError(f"'{name}' must be a bool")
                setattr(out, name, obj[name])
        if "eos_token_id" in obj and obj["eos_token_id"] is not None:
            v = obj["eos_token_id"]
            if not isinstance(v, int) or isinstance(v, bool):
                raise ProtocolError("'eos_token_id' must be an int")
            out.eos_token_id = int(v)
        if out.max_new_tokens < 1:
            raise ProtocolError("'max_new_tokens' must be >= 1")
        return out

    def engine_kwargs(self) -> Dict[str, Any]:
        """``put_request`` kwargs (deadline/priority/stream are router
        and transport concerns, never forwarded to the engine)."""
        kw: Dict[str, Any] = {"max_new_tokens": self.max_new_tokens}
        if self.eos_token_id is not None:
            kw["eos_token_id"] = self.eos_token_id
        if self.do_sample:
            kw.update(do_sample=True, temperature=self.temperature,
                      top_k=self.top_k, top_p=self.top_p)
        return kw


# -- SSE framing ---------------------------------------------------------

def sse_preamble() -> bytes:
    return (b"HTTP/1.1 200 OK\r\n"
            b"Content-Type: text/event-stream\r\n"
            b"Cache-Control: no-cache\r\n"
            b"Connection: close\r\n\r\n")


def sse_event(event: str, data: Any) -> bytes:
    return (f"event: {event}\ndata: "
            f"{json.dumps(data, separators=(',', ':'))}\n\n"
            ).encode("utf-8")


class SSEParser:
    """Incremental SSE parser: ``feed(bytes)`` returns completed
    ``(event, data)`` pairs; partial events stay buffered."""

    def __init__(self) -> None:
        self._buf = b""

    def feed(self, chunk: bytes) -> List[Tuple[str, str]]:
        self._buf += chunk
        out: List[Tuple[str, str]] = []
        while b"\n\n" in self._buf:
            block, self._buf = self._buf.split(b"\n\n", 1)
            event, data = "message", []
            for line in block.decode("utf-8").split("\n"):
                if line.startswith("event:"):
                    event = line[6:].strip()
                elif line.startswith("data:"):
                    data.append(line[5:].strip())
            if data:
                out.append((event, "\n".join(data)))
        return out


# -- responses -----------------------------------------------------------

def response(status: int, body: bytes = b"",
             content_type: str = "application/json",
             extra_headers: Tuple[Tuple[str, str], ...] = ()) -> bytes:
    head = [f"HTTP/1.1 {status} {REASONS.get(status, 'Unknown')}",
            f"Content-Type: {content_type}",
            f"Content-Length: {len(body)}",
            "Connection: close"]
    head += [f"{k}: {v}" for k, v in extra_headers]
    return ("\r\n".join(head) + "\r\n\r\n").encode("latin-1") + body


def json_response(status: int, obj: Any,
                  extra_headers: Tuple[Tuple[str, str], ...] = ()
                  ) -> bytes:
    return response(status, json.dumps(obj).encode("utf-8"),
                    extra_headers=extra_headers)


def rejection_status(exc: BaseException) -> Tuple[int, str]:
    """Map a typed router rejection to (HTTP status, error type).
    Unknown exceptions map to 500 — the caller dumps the flight ring
    for those."""
    from deepspeed_tpu_torch.serving.router import (DeadlineRejection,
                                              DrainingRejection,
                                              NeverSchedulableRejection,
                                              QueueFullRejection,
                                              RouterRejection,
                                              ShedRejection)
    etype = type(exc).__name__
    if isinstance(exc, NeverSchedulableRejection):
        return 400, etype
    if isinstance(exc, (DeadlineRejection, QueueFullRejection,
                        ShedRejection)):
        return 429, etype
    if isinstance(exc, DrainingRejection):
        return 503, etype
    if isinstance(exc, RouterRejection):
        return 503, etype
    return 500, etype
