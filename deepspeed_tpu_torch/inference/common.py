"""Conventions shared by the inference engines.

Counterpart of ``deepspeed_tpu/inference/common.py``: the host-path stage
timer, ``kv_quant_block``, ``logits_of`` and ``normalize_params``; and
:func:`capture_graph`, the CUDA-graph capture both engines use where the
reference compiles its decode loops with ``jax.jit``.
"""
from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch
from torch import nn

from deepspeed_tpu_torch.inference.quantization import quantize_model_
from deepspeed_tpu_torch.telemetry import trace
from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics
from deepspeed_tpu_torch.utils.logging import log_dist


class HostStageStats:
    """Per-dispatch host-path breakdown for the serving engines.

    Every hot-loop stage is bracketed:

    - ``plan``:     host-side scheduling (here: allocating the KV cache)
    - ``upload``:   host->device transfers of the prompt
    - ``dispatch``: enqueueing the prefill and decode work on the device
    - ``device``:   host BLOCKED waiting on device results (the harvest)
    - ``harvest``:  folding fetched tokens back into request state

    ``serving_stages()`` reports per-dispatch milliseconds plus
    ``host_bound_fraction`` = host-stage time / (host + device-wait)
    — ~1.0 means the loop never waits on the device (host-bound),
    ~0.0 means the host keeps the device saturated (device-bound).

    The stage names and counters are the reference's, so the engines
    report the same keys.  In the ragged v2 engine a dispatch is one
    fused tick or one decode block, and ``ticks`` counts model ticks (a
    K-tick block counts K); ``spill``, ``restore``, ``prefix`` and the
    ``prefix_*`` counters are KV tiering's and the prefix cache's.
    Speculation times its draft catch-up under ``draft`` and its blocks
    under ``verify``; ``spec_dispatches`` counts speculative blocks,
    ``spec_proposed`` and ``spec_accepted`` the draft tokens the blocks
    proposed and accepted (device counts, folded at harvests) and
    ``spec_tokens`` the tokens they emitted, reported as
    ``serving_stages()['speculation']``.
    Every bracket also lands as a ``cat="serving"`` tracer span when the
    tracer is on, and in the ``dstpu_serving_stage_seconds`` histogram
    under its stage and ``replica`` label (a scale-out replica's metric
    identity; ``""`` for a solo engine) when the registry is on.  With
    ``enable_cuda_graph`` an engine's decode work replays CUDA graphs:
    ``graph_captures`` counts captures (each after one eager warm-up),
    ``graph_replays`` replays and ``graph_capture_s`` the host seconds
    spent capturing; the engines report the three only when graphs are on
    (:meth:`graph_stages`).
    """

    STAGES = ("plan", "upload", "dispatch", "device", "harvest", "draft",
              "verify", "spill", "restore", "prefix")

    def __init__(self, replica: str = ""):
        self.replica = str(replica)
        self._hists: Dict[str, Any] = {}
        self._hist_fam = None
        self.reset()

    def set_replica(self, replica: str) -> None:
        """Re-label after construction (``ReplicaSet`` names the engines
        built without one); the next bracket lands under the new label."""
        self.replica = str(replica)
        self._hists.clear()
        self._hist_fam = None

    def reset(self) -> None:
        self.seconds: Dict[str, float] = {s: 0.0 for s in self.STAGES}
        self.ticks = 0            # model ticks (a K-tick block counts K)
        self.dispatches = 0       # generate calls, fused ticks, blocks
        self.meta_uploads = 0     # host->device metadata arrays sent
        self.blocking_gets = 0    # blocking device->host fetches
        self.harvests = 0         # deferred-harvest fold-backs
        self.spec_dispatches = 0  # speculative draft+verify blocks
        self.spec_proposed = 0    # draft tokens proposed (device count)
        self.spec_accepted = 0    # draft tokens accepted (device count)
        self.spec_tokens = 0      # tokens emitted by speculative blocks
        self.prefix_hits = 0      # admissions that attached cached pages
        self.prefix_misses = 0    # admissions that attached nothing
        self.prefix_hit_pages = 0   # cached pages attached
        self.prefix_hit_tokens = 0  # prefill tokens skipped via the cache
        self.prefix_cow_copies = 0  # copy-on-write page copies
        self.graph_captures = 0   # CUDA graphs captured
        self.graph_replays = 0    # CUDA graph replays
        self.graph_capture_s = 0.0  # host seconds spent capturing

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.seconds[name] += dt
            if trace.enabled:
                trace.add_complete(name, t0, dt, cat="serving")
            if _metrics.enabled:
                self._stage_hist(name).observe(dt)

    def _stage_hist(self, name: str):
        """The registry child of this stage, looked up once."""
        h = self._hists.get(name)
        if h is None or self._hist_fam is not _metrics.get(
                "dstpu_serving_stage_seconds"):
            self._hist_fam = _metrics.histogram(
                "dstpu_serving_stage_seconds",
                "Serving host-path stage bracket durations (s)",
                labels=("stage", "replica"))
            h = self._hist_fam.labels(stage=name, replica=self.replica)
            self._hists[name] = h
        return h

    def serving_stages(self) -> Dict[str, Any]:
        d = max(self.dispatches, 1)
        out: Dict[str, Any] = {
            f"{s}_ms": round(self.seconds[s] * 1e3 / d, 4)
            for s in self.STAGES}
        host = sum(self.seconds[s] for s in self.STAGES if s != "device")
        dev = self.seconds["device"]
        out["host_s"] = round(host, 4)
        out["device_wait_s"] = round(dev, 4)
        out["host_bound_fraction"] = (round(host / (host + dev), 4)
                                      if host + dev > 0 else None)
        out.update(ticks=self.ticks, dispatches=self.dispatches,
                   meta_uploads=self.meta_uploads,
                   blocking_gets=self.blocking_gets,
                   harvests=self.harvests)
        if self.spec_dispatches:
            sd = self.spec_dispatches
            out["speculation"] = {
                "spec_dispatches": sd,
                "draft_ms": round(self.seconds["draft"] * 1e3 / sd, 4),
                "verify_ms": round(self.seconds["verify"] * 1e3 / sd, 4),
                "proposed": self.spec_proposed,
                "accepted": self.spec_accepted,
                "acceptance_rate": round(
                    self.spec_accepted / max(self.spec_proposed, 1), 4),
                "mean_accepted_len": round(
                    self.spec_accepted / max(self.spec_tokens -
                                             self.spec_accepted, 1), 4),
                "tokens": self.spec_tokens,
                "effective_tokens_per_dispatch": round(
                    self.spec_tokens / sd, 2),
            }
        return out

    def graph_stages(self) -> Dict[str, Any]:
        return {"graph_captures": self.graph_captures,
                "graph_replays": self.graph_replays,
                "graph_capture_s": round(self.graph_capture_s, 4)}


# one capture at a time in the process: the caching allocator routes a
# capture's allocations to its graph's pool, and two engines capturing at
# once from two replica threads would interleave their pools' traffic
_CAPTURE_LOCK = threading.Lock()


def capture_graph(fn: Callable[[], Any], *, warmup: Optional[Callable] = None,
                  pool=None, generators: Sequence[torch.Generator] = ()):
    """Capture ``fn()`` into a ``torch.cuda.CUDAGraph``; returns
    ``(graph, outputs)``.  One eager warm-up call first (``warmup``, or
    ``fn`` itself) on a side stream, as CUDA-graph capture wants: it runs
    for real, so the caller arranges for it to write nothing live.
    ``pool``: a memory pool shared with other graphs
    (``torch.cuda.graph_pool_handle()``).  ``generators``: CUDA
    generators the captured work draws from, registered so that every
    replay advances them (``CUDAGraph.register_generator_state``).  A
    failure raises; nothing falls back to eager execution.

    Several engines may share the process and the card, each stepped
    from its own thread (the scale-out replicas).  So the capture runs
    in ``thread_local`` error mode: the default ``global`` mode forbids
    unsafe CUDA calls (an allocation, a pinned host buffer, a stream
    sync) from every thread while one captures, and another replica's
    work would fail or invalidate the capture.  ``thread_local`` holds
    only the capturing thread to that, and the capture's own stream
    (non-blocking, like every stream torch makes) takes no implicit
    dependency on the other threads' work.  Captures themselves take
    one process-wide lock, so that two never interleave."""
    graph = torch.cuda.CUDAGraph()
    if generators and not hasattr(graph, "register_generator_state"):
        raise NotImplementedError(
            f"torch {torch.__version__} cannot register a generator with a "
            "CUDA graph (CUDAGraph.register_generator_state): sampled v1 "
            "decoding under enable_cuda_graph needs it (ROADMAP A8b)")
    with _CAPTURE_LOCK:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            (warmup or fn)()
        torch.cuda.current_stream().wait_stream(side)
        for gen in generators:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, pool=pool,
                              capture_error_mode="thread_local"):
            out = fn()
    return graph, out


def kv_quant_block(pools, fmt: str, dequant_path: str,
                   num_pages: int) -> Dict[str, Any]:
    """``serving_stages()['kv_quant']`` sub-dict for a quantized paged
    pool (a list of per-layer ``PagedKVPool``): exact byte accounting
    (1-byte payload pages vs fp32 scale rows), the dequant-free read
    route, and written-scale statistics.  Copies the scales to the host:
    call at stats time, never in the serving loop."""
    payload = sum(p.pages.numel() * p.pages.element_size() for p in pools)
    scale_bytes = sum(p.scales.numel() * p.scales.element_size()
                      for p in pools if p.scales is not None)
    flat = torch.cat([p.scales.reshape(-1) for p in pools
                      if p.scales is not None] or
                     [torch.zeros(0)]).cpu()
    # the write path floors every written scale at the smallest normal
    # fp32, so exact zeros are rows never written
    nz = flat[flat != 0.0]
    return {
        "format": fmt,
        "dequant_path": dequant_path,
        "pool_bytes": payload + scale_bytes,
        "payload_bytes": payload,
        "scale_bytes": scale_bytes,
        "num_pages": int(num_pages),
        "scale_rows_written": int(nz.numel()),
        "scale_min": float(nz.min()) if nz.numel() else 0.0,
        "scale_max": float(nz.max()) if nz.numel() else 0.0,
        "scale_mean": float(nz.double().mean()) if nz.numel() else 0.0,
    }


def logits_of(out):
    """Models may return (logits, aux) tuples (e.g. Mixtral's router
    loss); serving wants the logits."""
    return out[0] if isinstance(out, tuple) else out


def normalize_params(model: nn.Module,
                     params: Optional[Mapping[str, torch.Tensor]] = None, *,
                     dtype: torch.dtype, device: torch.device,
                     generator: Optional[torch.Generator] = None,
                     keep_fp32: bool = False,
                     quantize: Optional[Dict[str, Any]] = None) -> nn.Module:
    """Put ``model``'s weights on ``device`` in the serving ``dtype``.

    ``params`` is a ``state_dict`` (e.g. from the flax bridge) loaded into
    the model.  A model built on the meta device is materialised directly
    in ``dtype`` on ``device``, so a large model never stages fp32 weights
    anywhere; with no ``params`` it is materialised and drawn from
    ``generator`` one module at a time in ``modules()`` order, by the
    class's ``init_module_weights`` (the stream ``init_weights`` draws).
    A model with real weights and no ``params`` keeps its weights, cast
    and moved.  Only parameters take ``dtype``: buffers (the int8 payload
    and fp32 scales of a model already quantized,
    ``inference/quantization.py``) keep theirs.  With ``keep_fp32`` the
    parameters a module names in its ``fp32_params`` (an MoE router) stay
    fp32, as the JAX v2 engine, which casts no parameter, keeps them; the
    v1 engine casts every one, as the JAX v1 engine does.

    ``quantize``: the keyword arguments of
    :func:`~deepspeed_tpu_torch.inference.quantization.quantize_model_`
    (``fmt`` and its options), applied once the weights are in place.  A
    meta model with no ``params`` is drawn and quantized module by
    module: the device holds the quantized model and one module's
    full-precision weights at most (``mixtral-8x7b``: 43.7 GiB in int8
    where its bf16 weights alone, 87.0 GiB, would not fit the card).  The
    generator draws the same stream in the same order, so the buffers are
    those of the whole model drawn and then quantized."""
    kept = {id(getattr(mod, name)) for mod in model.modules()
            for name in getattr(mod, "fp32_params", ())} \
        if keep_fp32 else set()
    draw = None
    if any(p.is_meta for p in model.parameters()):
        model.to(dtype=dtype)               # on meta: no memory touched
        for p in model.parameters():
            if id(p) in kept:
                p.data = p.data.float()
        if params is None:
            if not hasattr(model, "init_module_weights"):
                raise TypeError(
                    f"{type(model).__name__} on the meta device with no "
                    "params: the model draws its weights with "
                    "init_module_weights(module, generator), which this "
                    "class does not have")
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)

            def draw(mod: nn.Module) -> None:
                mod.to_empty(device=device, recurse=False)
                model.init_module_weights(mod, generator)
        else:
            model.to_empty(device=device)
    else:
        model.to(device=device)
        for p in model.parameters():
            if p.is_floating_point():
                p.data = p.data.to(torch.float32 if id(p) in kept else dtype)
    if params is not None:
        model.load_state_dict(params, strict=True)
    if quantize is not None:
        b0, b1 = quantize_model_(model, draw=draw, **quantize)
        log_dist(f"weights -> {quantize['fmt']}: {b0 / 2**20:.1f} MiB -> "
                 f"{b1 / 2**20:.1f} MiB ({b0 / max(b1, 1):.2f}x)"
                 f"{', built module by module' if draw else ''}",
                 ranks=[0])
    elif draw is not None:
        for mod in model.modules():
            draw(mod)
    if draw is not None and any(t.is_meta for t in model.state_dict(
            keep_vars=True).values()):
        raise RuntimeError("a module was left on the meta device: "
                           "init_module_weights must draw them all")
    return model
