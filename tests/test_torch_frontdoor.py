"""The front door over the port: the JAX package's
``tests/unit/serving/test_frontdoor.py`` cases on the port's
``FrontDoorServer`` (asyncio HTTP/1.1 + SSE on ``127.0.0.1:0``) over the
port's router and v2 engines.  Streamed tokens equal in-process serving
(the port's engine and the JAX engine on the same weights), a client
disconnect mid-stream cancels the request and gives its pages back, and
a disaggregated (1 prefill + 1 decode) router streams the same tokens.
"""
import asyncio
import json
import time

import numpy as np
import pytest

import torch_tier_helpers as tiers
from deepspeed_tpu_torch.serving import FrontDoorServer, ReplicaSet, Router
from deepspeed_tpu_torch.serving import protocol as proto
from deepspeed_tpu_torch.serving.client import (LoadGenerator,
                                                bimodal_payload_fn,
                                                sse_generate)
import torch_cpu  # noqa: F401  (one torch thread a process)

ENGINE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=8,
              decode_block_size=4, harvest_interval=3, num_pages=None)


@pytest.fixture(scope="module")
def tiny():
    return tiers.weights()


def _engine(w, **kw):
    return tiers.port_engine(w, pipeline=True, **{**ENGINE, **kw})


def _reference(w, prompts, max_new, make=None):
    eng = (make or _engine)(w)
    order = {eng.put_request(p, max_new_tokens=max_new): i
             for i, p in enumerate(prompts)}
    outs = {}
    while eng.has_work():
        eng.step()
        outs.update({order[u]: t for u, t in eng.get_outputs()})
    eng.sync()
    outs.update({order[u]: t for u, t in eng.get_outputs()})
    eng.close()
    return outs


@pytest.fixture(scope="module")
def served(tiny):
    """Two live replicas behind a listening front door."""
    rs = ReplicaSet(lambda i: _engine(tiny), 2)
    router = Router(rs, policy="least_tokens")
    srv = FrontDoorServer(router, port=0).start()
    yield srv, router, rs
    srv.close()
    rs.close()


async def _raw(host, port, request: bytes) -> bytes:
    reader, writer = await asyncio.open_connection(host, port)
    writer.write(request)
    await writer.drain()
    data = await reader.read(-1)
    writer.close()
    return data


def _get(srv, path) -> bytes:
    return asyncio.run(_raw(
        srv.host, srv.port,
        f"GET {path} HTTP/1.1\r\nHost: x\r\n\r\n".encode()))


def _post(srv, body: bytes, path="/v1/generate") -> bytes:
    return asyncio.run(_raw(
        srv.host, srv.port,
        (f"POST {path} HTTP/1.1\r\nHost: x\r\n"
         f"Content-Type: application/json\r\n"
         f"Content-Length: {len(body)}\r\n\r\n").encode() + body))


def _quiesce(router, timeout=15.0):
    """Wait until the router's pump thread has nothing outstanding: only
    then may the test thread read engine state."""
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout:
        if router.outstanding == 0 and router.queued == 0:
            time.sleep(0.1)       # let in-flight step ops fold
            if router.outstanding == 0:
                return
        time.sleep(0.02)
    raise AssertionError("router never quiesced")


class TestRoutesAndValidation:
    def test_healthz(self, served):
        srv, _, _ = served
        raw = _get(srv, "/healthz")
        assert raw.startswith(b"HTTP/1.1 200")
        body = json.loads(raw.split(b"\r\n\r\n", 1)[1])
        assert body == {"status": "ok", "replicas": 2}

    def test_unknown_path_404_and_bad_method_405(self, served):
        srv, _, _ = served
        assert _get(srv, "/nope").startswith(b"HTTP/1.1 404")
        assert _get(srv, "/v1/generate").startswith(b"HTTP/1.1 405")

    def test_malformed_bodies_400(self, served):
        srv, _, _ = served
        assert _post(srv, b"{not json").startswith(b"HTTP/1.1 400")
        assert _post(srv, b'{"prompt": []}').startswith(b"HTTP/1.1 400")
        assert _post(srv, b'{"prompt": [1], "wat": 1}').startswith(
            b"HTTP/1.1 400")
        big = json.dumps({"prompt": [1] * 120,
                          "max_new_tokens": 120}).encode()
        raw = _post(srv, big)
        assert raw.startswith(b"HTTP/1.1 400"), raw[:200]
        assert b"NeverSchedulableRejection" in raw

    def test_burned_deadline_is_typed_429(self, served):
        srv, router, _ = served
        res = asyncio.run(sse_generate(
            srv.host, srv.port,
            {"prompt": [1, 2, 3], "max_new_tokens": 4,
             "deadline_ms": 0.0}))
        assert res["status"] == 429
        assert res["error"] == "DeadlineRejection"
        assert router.stats_counters["rejected_deadline"] >= 1
        raw = _post(srv, json.dumps(
            {"prompt": [1, 2, 3], "deadline_ms": -1}).encode())
        assert b"Retry-After:" in raw

    def test_sse_frames_and_rejection_status(self):
        """The wire helpers: an SSE frame is ``event:``/``data:`` lines
        and a blank line, and each typed rejection maps to its status."""
        from deepspeed_tpu_torch.serving import router as r
        frame = proto.sse_event("tokens", {"rid": 3, "tokens": [5, 6]})
        assert frame.endswith(b"\n\n")
        assert b"event: tokens\n" in frame
        assert json.loads(frame.split(b"data: ", 1)[1]) == {
            "rid": 3, "tokens": [5, 6]}
        assert proto.rejection_status(r.QueueFullRejection("x"))[0] == 429
        assert proto.rejection_status(
            r.NeverSchedulableRejection("x"))[0] == 400


class TestStreaming:
    def test_sse_tokens_equal_inprocess_serving(self, served, tiny):
        """Streamed tokens over the socket are the port engine's
        in-process tokens and the JAX engine's, token for token."""
        srv, _, _ = served
        prompts = tiers.prompts((5, 9, 13, 7, 11, 6, 8, 10))
        ref = _reference(tiny, prompts, 12)
        jref = _reference(tiny, prompts, 12, make=lambda w: tiers.jax_engine(
            w, pipeline=True, **ENGINE))
        gen = LoadGenerator(
            srv.host, srv.port,
            lambda i: {"prompt": prompts[i].tolist(), "max_new_tokens": 12},
            requests=len(prompts), concurrency=8)
        summary = gen.run()
        assert summary["completed"] == len(prompts), summary
        for r in gen.results:
            i = r["i"]
            np.testing.assert_array_equal(r["final"], ref[i])
            np.testing.assert_array_equal(r["final"], jref[i])
            assert r["tokens"] == list(ref[i][len(prompts[i]):]), i
            assert r["events"] >= 3, (i, r["events"])
        assert summary["ttft_ms_p50"] > 0

    def test_buffered_mode_matches(self, served, tiny):
        srv, _, _ = served
        (p,) = tiers.prompts((6,), seed=9)
        ref = _reference(tiny, [p], 8)[0]
        res = asyncio.run(sse_generate(
            srv.host, srv.port,
            {"prompt": p.tolist(), "max_new_tokens": 8, "stream": False}))
        assert res["status"] == 200 and res["error"] is None
        np.testing.assert_array_equal(res["final"], ref)

    def test_metrics_endpoint_serves_http_series(self, served):
        srv, _, _ = served
        raw = _get(srv, "/metrics")
        assert raw.startswith(b"HTTP/1.1 200")
        text = raw.split(b"\r\n\r\n", 1)[1].decode()
        for name in ("dstpu_http_requests_total", "dstpu_http_ttft_ms",
                     "dstpu_http_active_streams",
                     "dstpu_serving_stage_seconds"):
            assert name in text, name

    def test_disconnect_mid_stream_reclaims_pages(self, served):
        srv, router, rs = served
        _quiesce(router)
        free0 = [h.engine.allocator.free_pages for h in rs.handles]
        cancels0 = sum(h.engine.cancels for h in rs.handles)
        (p,) = tiers.prompts((8,), seed=17)
        res = asyncio.run(sse_generate(
            srv.host, srv.port, {"prompt": p.tolist(), "max_new_tokens": 64},
            abort_after_events=1))
        assert res["error"] == "client_abort"
        assert len(res["tokens"]) < 64, "aborted before completion"
        t0 = time.monotonic()
        while time.monotonic() - t0 < 20.0:
            if (sum(h.engine.cancels for h in rs.handles) > cancels0
                    and router.outstanding == 0
                    and [h.engine.allocator.free_pages
                         for h in rs.handles] == free0):
                break
            time.sleep(0.05)
        assert sum(h.engine.cancels for h in rs.handles) == cancels0 + 1
        assert [h.engine.allocator.free_pages for h in rs.handles] == free0
        _quiesce(router)
        for h in rs.handles:
            h.engine.audit_kv_sharing()
        assert router.stats_counters["cancelled"] >= 1

    def test_8_concurrent_streams(self, served):
        srv, _, _ = served
        prompts = tiers.prompts((6,) * 8, seed=21)
        gen = LoadGenerator(
            srv.host, srv.port,
            lambda i: {"prompt": prompts[i].tolist(), "max_new_tokens": 6},
            requests=8, concurrency=8)
        summary = gen.run()
        assert summary["completed"] == 8, summary


def test_disaggregated_front_door_streams_fused_tokens(tiny):
    """SSE through a 1 prefill + 1 decode router under the bimodal mix:
    every stream's tokens are a fused engine's, the long prompts handed
    off their KV, and both replicas end with every page free."""
    kw = dict(kv_tiering={"host_pages": 64})
    rs = ReplicaSet(lambda i: _engine(tiny, **kw), 2)
    router = Router(rs, policy="least_tokens")
    router.set_roles({"r0": "prefill", "r1": "decode"})
    srv = FrontDoorServer(router, port=0).start()
    try:
        payload, kinds = bimodal_payload_fn(
            6, short_len=5, long_len=40, vocab=64, max_new_tokens=10,
            long_frac=0.5, seed=3)
        bodies = [payload(i) for i in range(6)]
        gen = LoadGenerator(srv.host, srv.port, lambda i: bodies[i],
                            requests=len(bodies), concurrency=6)
        summary = gen.run()
        assert summary["completed"] == len(bodies), summary
        prompts = [np.asarray(b["prompt"], np.int32) for b in bodies]
        ref = _reference(tiny, prompts, 10,
                         make=lambda w: _engine(w, **kw))
        for r in gen.results:
            np.testing.assert_array_equal(r["final"], ref[r["i"]])
        _quiesce(router)
        s = router.stats()
        n_long = kinds.count("long")
        assert n_long == sum(1 for p in prompts if p.size >= 16)
        assert n_long and s["handoffs"] == s["handoff_kv"] == n_long
        for h in rs.handles:
            h.engine.audit_kv_sharing()
            assert h.engine.allocator.free_pages == h.engine.num_pages - 1
    finally:
        srv.close()
        rs.close()
