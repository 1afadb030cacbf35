"""Conventions shared by the inference engines.

Counterpart of ``deepspeed_tpu/inference/common.py``: the host-path stage
timer, ``kv_quant_block``, ``logits_of`` and ``normalize_params``.
"""
from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any, Dict, Mapping, Optional

import torch
from torch import nn


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
    K-tick block counts K); the stages and ``prefix_*`` counters of
    features not ported yet (speculation, tiering, prefix cache) stay 0.
    ``replica`` is the reference's metric label of a scale-out replica.
    The reference's trace-span and metrics-histogram hooks arrive with the
    telemetry port.
    """

    STAGES = ("plan", "upload", "dispatch", "device", "harvest", "draft",
              "verify", "spill", "restore", "prefix")

    def __init__(self, replica: str = ""):
        self.replica = str(replica)
        self.reset()

    def reset(self) -> None:
        self.seconds: Dict[str, float] = {s: 0.0 for s in self.STAGES}
        self.ticks = 0            # model ticks (a K-tick block counts K)
        self.dispatches = 0       # generate calls, fused ticks, blocks
        self.meta_uploads = 0     # host->device metadata arrays sent
        self.blocking_gets = 0    # blocking device->host fetches
        self.harvests = 0         # deferred-harvest fold-backs
        self.prefix_hits = 0      # admissions that attached cached pages
        self.prefix_misses = 0    # admissions that attached nothing
        self.prefix_hit_pages = 0   # cached pages attached
        self.prefix_hit_tokens = 0  # prefill tokens skipped via the cache
        self.prefix_cow_copies = 0  # copy-on-write page copies

    @contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0

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
        return out


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
                     generator: Optional[torch.Generator] = None
                     ) -> nn.Module:
    """Put ``model``'s weights on ``device`` in the serving ``dtype``.

    ``params`` is a ``state_dict`` (e.g. from the flax bridge) loaded into
    the model.  A model built on the meta device is materialised directly
    in ``dtype`` on ``device``, so a large model never stages fp32 weights
    anywhere; with no ``params`` its weights are then drawn from
    ``generator`` by ``model.init_weights``.  A model with real weights
    and no ``params`` keeps its weights, cast and moved."""
    if any(p.is_meta for p in model.parameters()):
        model.to(dtype=dtype)               # on meta: no memory touched
        model.to_empty(device=device)
        if params is None:
            if generator is None:
                generator = torch.Generator(device=device).manual_seed(0)
            model.init_weights(generator)
    else:
        model.to(device=device, dtype=dtype)
    if params is not None:
        model.load_state_dict(params, strict=True)
    return model
