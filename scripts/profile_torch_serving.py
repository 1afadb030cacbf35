#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving paths, on one GPU.

    python3 scripts/profile_torch_serving.py [--mode v1|v2] [--new 16]
                                             [--model llama3-8b|
                                                      qwen1.5-moe-a2.7b]
                                             [--weights bf16|int8|fp8|
                                                        fp6|w8a8]
                                             [--cuda-graph]
                                             [--spec ngram|draft]
                                             [--long-context]
                                             [--disagg]
                                             [--root DIR] [--out FILE]

Builds ``llama3-8b`` at full width and depth with random seeded weights
(bf16, made on the card; ``--weights`` int8, fp8, fp6 or w8a8 then serves
them in that format: int8 in groups of 128 in v1 and 2048 in v2, fp6 in
groups of 128 in v1 and 2048 in v2, each dequantized at use; w8a8 through
``W8A8Linear``'s GEMM in v2 and expanded at use in v1) and traces with
``torch.profiler``:

- ``v1`` (``init_inference``): serves 4 prompts x 1000 tokens once to
  warm up, then traces (a) a prefill (``generate`` of one token) and
  (b) a whole ``generate`` of ``--new`` tokens;
- ``v2`` (``RaggedInferenceEngineV2``, 16 slots, 512-token prefill
  chunks, 64-token pages, 8-tick decode blocks): warms up on one small
  run, submits 16 requests of 600 prompt tokens and 64 new tokens, then
  traces (a) a fused tick that mixes decode tokens with a prefill chunk
  and (b) a decode block (unpipelined, so that one step is one whole
  block).

``--model qwen1.5-moe-a2.7b`` (v2, bf16) serves the sparse-MoE preset at
full size instead (24 layers, 60 experts of 1408, 4 a token, a shared
expert), the same way.  Its windows also split the device time by
module, from labelled ranges around each layer's attention, shared
expert and MoE layer (the router's logits and top-k gating, the expert
``bmm``s, and the rest of the layer: the routing plan's sorts, the
dispatch and combine gathers); the ranges record only eager work, so
the split comes from a run without ``--cuda-graph``, whose kernels are
those a replayed block runs.

``--cuda-graph`` turns on ``enable_cuda_graph``: the v2 decode block and
the v1 decode steps replay CUDA graphs (captured during the warm-up);
the fused tick and the prefill stay eager.

``--spec ngram|draft`` (v2, graphs on): speculative decoding with k = 4,
n-gram drafting or a draft model of TinyLlama's shape with Llama 3's
vocabulary (random seeded weights); the traced decode block is one
replayed speculative block (in draft mode the one after the block whose
step caught the draft's pools up), and its device time is split by kernel
class: GEMMs, paged attention (``rpa_*``), verify sampling (arg-max,
softmax, sort and scan kernels) and the rest, in all and per tick (the
draft's steps fall in the same classes as the verify's).

``--long-context`` (v2, graphs on): long context (``kv_tiering``
``long_context``, `chip_smoke.py` phase 21's settings: 64-token pages, a
17-page pool, sink 1, window 8, groups of 4, 24 host and 64 NVMe pages
under the git-ignored ``build/profile_lc``, removed afterwards) serves
one 4064 + 32 request and traces one decode tick once the prompt is in
(its middle parked: 13 groups): the busy share, the top kernels, and
the tick split by labelled ranges, each with its host ms and the device
ms of what it launched: ``pagein`` (the tier store's verified ``peek``
of every parked group), ``h2d`` (each (layer, group) slice's copies
into the device ring), ``staged_stats`` (the chunk dispatches, less the
``h2d`` nested in them), ``finish`` (the 32 blocks over the pool with
the carry), ``head`` (norm, LM head and sampling) and ``park``.

``--disagg`` (v2, graphs and the pipeline on, `chip_smoke.py` phase
23's settings): 16 requests, 8 x 32 and 8 x 1024 tokens + 64 each,
through a fused engine and through a prefill and a decode replica
behind the router (``set_roles``), the replicas on their own threads
over the same module, each with 192 pinned host pages.  Each side runs
the traffic once to capture its graphs, then once timed without the
profiler and once traced.  The timed run clocks every router round
(``pump`` then ``join``) and every replica op (``step``,
``export_handoff``, ``import_handoff``) on the host: per replica its
busy ms by op, and the ms it sat idle inside rounds it worked in,
held by the round's join while the other replica's op ran; and the
rounds' ms beside the sum over rounds of the busier replica's ms.  The
traced run gives the device busy share and the top kernels of both
replicas together (the profiler's host ranges follow only the thread
that started it; the device activity is the whole process's).

With quantized weights the v2 windows' device time is also split by
kernel class, in all and per tick, with launches a tick: the W8A8 GEMM
(``w8a8_*``), the first design's K3 and K4, the weight formats'
dequants and #7 (``dequant*``), other GEMMs (cuBLAS, ``torch._int_mm``),
paged attention (``rpa_*``) and the rest (elementwise: norms, RoPE,
SwiGLU, residuals, sampling), and the gaps (wall less device busy time).

``--root DIR`` imports the port from another checkout (for example the
parent commit's, unpacked with ``git archive`` into a git-ignored
directory), so that one script traces both.

For each window it prints the wall time, the device busy share (the
union of device intervals over wall time: the rest is the device waiting
on the host), and the kernels that take the most device time.  ``--out``
also writes the numbers as JSON.  Needs a CUDA GPU.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def profile(fn, top: int, ranges=()):
    """Wall ms, device busy share and the top kernels of one call.  Busy
    time is the union of the device events' intervals (kernels, copies,
    memsets; not the device-side spans of labelled ranges), so nothing is
    counted twice.  ``ranges``: names of ``record_function`` ranges whose
    host ms (their own wall time) and device ms (the kernels and copies
    launched inside them) are summed under ``"ranges"``."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and e.name != "Command Buffer Full"
           and not getattr(e, "is_user_annotation", False)
           and e.name not in ranges]
    busy_us, end = 0.0, float("-inf")
    for start, stop in sorted((e.time_range.start, e.time_range.end)
                              for e in dev):
        busy_us += max(0.0, stop - max(start, end))
        end = max(end, stop)
    by_name = {}
    for e in dev:
        calls, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (calls + 1, us + e.time_range.elapsed_us())
    total = sum(us for _, us in by_name.values())
    rows = [{"kernel": name[:90], "calls": calls, "device_ms": us / 1e3,
             "share": us / total}
            for name, (calls, us) in sorted(by_name.items(),
                                            key=lambda kv: -kv[1][1])[:top]]
    out = {"wall_ms": wall * 1e3, "device_busy_ms": busy_us / 1e3,
           "device_busy_share": busy_us / 1e3 / (wall * 1e3),
           "top_kernels": rows}
    if ranges:
        out["ranges"] = {name: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0}
                         for name in ranges}
        for e in prof.events():
            if (e.name in ranges
                    and e.device_type == torch.autograd.DeviceType.CPU):
                r = out["ranges"][e.name]
                r["calls"] += 1
                r["host_ms"] += e.time_range.elapsed_us() / 1e3
                r["device_ms"] += getattr(
                    e, "device_time_total",
                    getattr(e, "cuda_time_total", 0.0)) / 1e3
    return out


# kernel classes of a traced speculative block, by name
CLASSES = (("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
           ("paged_attention", ("rpa_",)),
           ("verify_sampling", ("argmax", "softmax", "sort", "scan",
                                "cumsum", "topk")))


# kernel classes of a traced window over quantized weights, by name: the
# first design's K3 and K4 before the W8A8 GEMM's own names
WEIGHT_CLASSES = (("k3_k4", ("w8a8_rows_kernel", "w8a8_epilogue_kernel")),
                  ("w8a8_gemm", ("w8a8_",)),
                  ("dequantize", ("dequant",)),
                  ("gemm", ("gemm", "xmma", "nvjet", "cutlass", "cublas")),
                  ("paged_attention", ("rpa_",)))


def by_class(prof_rows, ticks: int, classes=CLASSES):
    """Device ms and launches of a traced window's kernels by class, in
    all and per tick."""
    out = {name: [0.0, 0] for name, _ in classes}
    out["rest"] = [0.0, 0]
    for row in prof_rows:
        name = row["kernel"].lower()
        cls = next((c for c, keys in classes
                    if any(k in name for k in keys)), "rest")
        out[cls][0] += row["device_ms"]
        out[cls][1] += row["calls"]
    return {k: {"ms": ms, "ms_per_tick": ms / ticks, "launches": n,
                "launches_per_tick": n / ticks}
            for k, (ms, n) in out.items()}


# labelled ranges of an MoE model's layers (``label_moe``)
MOE_RANGES = ("attention", "shared_expert", "moe", "moe_gating",
              "moe_experts")


def label_moe(module) -> None:
    """Wrap each layer's attention, shared expert and MoE layer, and the
    MoE layer's gating and expert FFN, in ``record_function`` ranges."""
    from deepspeed_tpu_torch.moe.layer import MoE

    def wrap(obj, attr, tag):
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            with torch.profiler.record_function(tag):
                return fn(*a, **k)
        setattr(obj, attr, wrapped)

    for layer in module.model.layers:
        wrap(layer.self_attn, "forward", "attention")
        if getattr(layer, "shared_expert", None) is not None:
            wrap(layer.shared_expert, "forward", "shared_expert")
    for mod in module.modules():
        if isinstance(mod, MoE):
            wrap(mod, "forward", "moe")
            wrap(mod, "gating", "moe_gating")
            wrap(mod, "_expert_ffn", "moe_experts")


def moe_split(res) -> dict:
    """Device ms a tick by module from the ranges of ``label_moe``: the
    MoE layer's routing (plan, dispatch, combine) is its range less the
    gating's and the experts'; ``rest`` is the device busy time outside
    every range (embedding, norms, LM head, sampling)."""
    r = {k: v["device_ms"] for k, v in res["ranges"].items()}
    t = res["ticks"]
    split = {"attention": r["attention"],
             "shared_expert": r["shared_expert"],
             "moe_gating": r["moe_gating"], "moe_experts": r["moe_experts"],
             "moe_routing": r["moe"] - r["moe_gating"] - r["moe_experts"]}
    split["rest"] = res["device_busy_ms"] - sum(split.values())
    return {k: {"ms": v, "ms_per_tick": v / t} for k, v in split.items()}


def profile_v2(top: int, weights: str, graph: bool, spec=None,
               model_name: str = "llama3-8b"):
    """Trace one mixed fused tick and one decode block of the v2 engine
    (a speculative block with ``spec``)."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.models.qwen2_moe import Qwen2MoeForCausalLM
    from deepspeed_tpu_torch.models.qwen2_moe import \
        get_config as moe_config

    moe = model_name != "llama3-8b"
    cfg = moe_config(model_name) if moe else get_config(model_name)
    with torch.device("meta"):
        model = (Qwen2MoeForCausalLM if moe else LlamaForCausalLM)(cfg)
    kw = {}
    if spec is not None:
        graph = True
        kw["speculation"] = {"mode": spec, "k": 4}
        if spec == "draft":
            with torch.device("meta"):
                kw["draft_model"] = LlamaForCausalLM(get_config(
                    "llama-1b", vocab_size=cfg.vocab_size,
                    rope_theta=500000.0, max_position_embeddings=8192))
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(0),
        max_seqs=16, max_seq_len=2048, prefill_chunk=512, page_size=64,
        decode_block_size=8, pipeline=False,
        config={"enable_cuda_graph": graph},
        quantize_weights=None if weights == "bf16" else weights, **kw)
    rng = np.random.default_rng(0)
    if moe:
        label_moe(engine.module)

    def submit(n, prompt, new):
        for _ in range(n):
            engine.put_request(rng.integers(0, cfg.vocab_size, size=prompt),
                               max_new_tokens=new)

    submit(16, 300, 24)                                    # warm-up
    while engine.has_work():
        engine.step()
    engine.get_outputs()
    submit(16, 600, 64)
    out = {"device": torch.cuda.get_device_name(0), "mode": "v2",
           "model": model_name,
           "weights": weights, "cuda_graph": graph, "spec": spec,
           "requests": 16, "prompt": 600, "new_tokens": 64}
    st = engine.host_stats

    def traced_step(want_block: bool):
        while True:
            live = [r for r in engine.slots if r is not None]
            decoding = [r for r in live if r.prefill_done >= r.ctx_len]
            if want_block == (len(decoding) == len(live)) and (
                    want_block or decoding):
                break
            engine.step()
        if want_block and spec == "draft":
            # the first block after prefill brings the draft's pools up
            # to the cursors (eager catch-up prefill): trace the next
            engine.step()
        ticks = st.ticks
        every = (spec is not None and want_block) or weights != "bf16"
        res = profile(engine.step, 10**6 if every else top,
                      MOE_RANGES if moe else ())
        res["ticks"] = st.ticks - ticks
        res["tokens_in_batch"] = (len(decoding) if want_block else None)
        if moe and not (graph and want_block):
            res["by_module"] = moe_split(res)
        if weights != "bf16":
            res["by_class"] = by_class(res["top_kernels"], res["ticks"],
                                       WEIGHT_CLASSES)
            res["by_class"]["gaps"] = {
                "ms": res["wall_ms"] - res["device_busy_ms"],
                "ms_per_tick": (res["wall_ms"] - res["device_busy_ms"]) /
                res["ticks"]}
            if spec is None:
                res["top_kernels"] = res["top_kernels"][:top]
        return res

    out["fused_tick"] = traced_step(want_block=False)
    out["decode_block"] = traced_step(want_block=True)
    assert out["fused_tick"]["ticks"] == 1
    assert out["decode_block"]["ticks"] == engine.decode_block_size
    if spec is not None:
        block = out["decode_block"]
        assert engine.host_stats.graph_replays > 0
        block["by_class"] = by_class(block["top_kernels"], block["ticks"])
        block["top_kernels"] = block["top_kernels"][:top]
    while engine.has_work():
        engine.step()
    out["serving_stages"] = {k: v for k, v in engine.serving_stages().items()
                             if not isinstance(v, dict)}
    return out


LC_RANGES = ("pagein", "h2d", "staged_stats", "finish", "head", "park")

DISAGG_OPS = ("step", "export_handoff", "import_handoff")
DISAGG_ROLES = {"r0": "prefill", "r1": "decode"}


def round_split(rounds, ops):
    """Host ms of the timed router run: per replica its busy ms by op and
    the ms it sat idle inside the rounds it worked in (the round held
    open by the other replica); the rounds' total beside the sum of the
    busier replica's ms a round."""
    out = {"rounds": len(rounds),
           "round_ms": sum(b - a for a, b in rounds) * 1e3}
    busier = 0.0
    per = {name: {"busy_ms": {op: 0.0 for op in DISAGG_OPS},
                  "ops": {op: 0 for op in DISAGG_OPS},
                  "held_idle_ms": 0.0, "rounds_worked": 0}
           for name in ops}
    for a, b in rounds:
        most = 0.0
        for name, spans in ops.items():
            busy = 0.0
            for op, t0, t1 in spans:
                inside = min(t1, b) - max(t0, a)
                if inside > 0:
                    busy += inside
                    per[name]["busy_ms"][op] += inside * 1e3
                    if t0 >= a:
                        per[name]["ops"][op] += 1
            if busy > 0:
                per[name]["rounds_worked"] += 1
                per[name]["held_idle_ms"] += (b - a - busy) * 1e3
            most = max(most, busy)
        busier += most
    out["busier_replica_ms"] = busier * 1e3
    out["replicas"] = {DISAGG_ROLES[n]: v for n, v in per.items()}
    return out


def profile_disagg(top: int):
    """Trace the 1P1D router and the fused engine over phase 23's
    traffic, warm."""
    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config
    from deepspeed_tpu_torch.serving import ReplicaSet, Router

    cfg = get_config("llama3-8b")
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    kw = dict(max_seqs=16, max_seq_len=2048, prefill_chunk=512,
              page_size=64, decode_block_size=8, pipeline=True,
              config={"enable_cuda_graph": True})
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(0, cfg.vocab_size, size=1024 if i % 2 else 32),
             64) for i in range(16)]
    control = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(0),
        device="cuda", **kw)

    def run_control():
        for p, n in reqs:
            control.put_request(p, max_new_tokens=n)
        while control.has_work():
            control.step()
            control.stream_deltas()
            control.get_outputs()

    out = {"device": torch.cuda.get_device_name(0), "mode": "disagg",
           "requests": "8 x 32 + 8 x 1024, + 64 each"}
    run_control()                                  # its capture
    caps = control.host_stats.graph_captures
    out["control"] = profile(run_control, top)
    assert control.host_stats.graph_captures == caps
    module = control.module
    del control
    rs = ReplicaSet(lambda i: RaggedInferenceEngineV2(
        module, device="cuda", kv_tiering={"host_pages": 192}, **kw), 2)
    ops = {h.name: [] for h in rs.handles}
    for h in rs.handles:
        for op in DISAGG_OPS:
            fn = getattr(h.engine, op)

            def clocked(*a, fn=fn, spans=ops[h.name], op=op, **k):
                t0 = time.perf_counter()
                try:
                    return fn(*a, **k)
                finally:
                    spans.append((op, t0, time.perf_counter()))

            setattr(h.engine, op, clocked)
    try:
        router = Router(rs, policy="least_tokens")
        router.set_roles(DISAGG_ROLES)
        rounds = []

        def run_router():
            for p, n in reqs:
                router.submit(p, max_new_tokens=n)
            while router.outstanding or router.queued:
                t0 = time.perf_counter()
                router.pump()
                router.join()
                rounds.append((t0, time.perf_counter()))
            router.get_outputs()

        run_router()                               # the captures
        engines = [h.engine for h in rs.handles]
        caps = [e.host_stats.graph_captures for e in engines]
        for spans in ops.values():
            spans.clear()
        rounds.clear()
        t0 = time.perf_counter()
        run_router()
        out["router_timed"] = dict(round_split(rounds, ops),
                                   wall_ms=(time.perf_counter() - t0) * 1e3)
        out["router"] = profile(run_router, top)
        assert [e.host_stats.graph_captures for e in engines] == caps
        st = router.stats()
        assert st["replica_deaths"] == 0 and st["handoff_kv"] == 3 * 8, st
        out["handoffs"] = st["handoff_kv"]
    finally:
        rs.close()
    return out


def profile_lc(top: int):
    """Trace one long-context decode tick of ``llama3-8b`` (4064 + 32 on a
    17-page pool), split by labelled ranges."""
    import shutil

    from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config

    cfg = get_config("llama3-8b")
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    spill = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "build", "profile_lc")
    engine = RaggedInferenceEngineV2(
        model, generator=torch.Generator(device="cuda").manual_seed(0),
        max_seqs=8, max_seq_len=4096, prefill_chunk=512, page_size=64,
        num_pages=17, decode_block_size=8,
        config={"enable_cuda_graph": True},
        kv_tiering=dict(long_context=True, sink_pages=1, window_pages=8,
                        chunk_pages=4, host_pages=24, nvme_pages=64,
                        nvme_dir=spill))
    rng = np.random.default_rng(0)
    engine.put_request(rng.integers(0, cfg.vocab_size, size=4064),
                       max_new_tokens=32)
    req = engine.waiting[0]
    while len(req.generated) < 3:          # prompt in, two decode ticks
        engine.step()
    drv = engine._lc

    def label(obj, name, tag):
        fn = getattr(obj, name)

        def wrapped(*a, **k):
            with torch.profiler.record_function(tag):
                return fn(*a, **k)

        setattr(obj, name, wrapped)

    label(engine.tiering, "peek", "pagein")
    label(drv, "_stage", "h2d")
    label(drv, "_park", "park")
    label(engine, "_sample", "head")
    label(engine.module.lm_head, "forward", "head")
    for layer in engine.module.model.layers:
        label(layer, "chunk_stats", "staged_stats")
        label(layer, "forward", "finish")
    staged = drv.staged_dispatches
    res = profile(engine.step, top, LC_RANGES)
    # the h2d copies run inside the staged-stats range: count them once
    rg = res["ranges"]
    for k in ("host_ms", "device_ms"):
        rg["staged_stats"][k] -= rg["h2d"][k]
    res["staged_dispatches"] = drv.staged_dispatches - staged
    res["parked_groups"] = req.lc_parked
    while engine.has_work():
        engine.step()
    out = {"device": torch.cuda.get_device_name(0), "mode": "v2",
           "long_context": True, "prompt": 4064, "new_tokens": 32,
           "decode_tick": res,
           "serving_stages": {k: v for k, v in engine.serving_stages()[
               "kv_tiering"].items() if k.startswith("pagein")}}
    engine.close()
    shutil.rmtree(spill, ignore_errors=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("v1", "v2"), default="v1")
    ap.add_argument("--new", type=int, default=16,
                    help="new tokens in the traced v1 generate")
    ap.add_argument("--weights", default="bf16",
                    choices=("bf16", "int8", "fp8", "fp6", "w8a8"))
    ap.add_argument("--model", default="llama3-8b",
                    choices=("llama3-8b", "qwen1.5-moe-a2.7b"),
                    help="the v2 model (qwen1.5-moe-a2.7b: bf16, no "
                         "speculation)")
    ap.add_argument("--root", default=None,
                    help="import the port from this checkout")
    ap.add_argument("--cuda-graph", action="store_true",
                    help="replay decode blocks and steps from CUDA graphs")
    ap.add_argument("--spec", choices=("ngram", "draft"), default=None,
                    help="trace a replayed speculative block (v2)")
    ap.add_argument("--long-context", action="store_true",
                    help="trace one long-context decode tick (v2)")
    ap.add_argument("--disagg", action="store_true",
                    help="trace the 1P1D router beside a fused engine")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--out", default=None, help="write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serving: needs a CUDA GPU", file=sys.stderr)
        return 2
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    if args.long_context:
        return report(profile_lc(args.top), ("decode_tick",), args.out)
    if args.disagg:
        out = profile_disagg(args.top)
        print(f"router, timed: {json.dumps(out['router_timed'])}")
        return report(out, ("control", "router"), args.out)
    if args.model != "llama3-8b" and (args.mode != "v2" or args.spec or
                                      args.weights != "bf16"):
        ap.error("--model qwen1.5-moe-a2.7b profiles v2 in bf16 only")
    if args.mode == "v2" or args.spec is not None:
        return report(profile_v2(args.top, args.weights, args.cuda_graph,
                                 args.spec, args.model),
                      ("fused_tick", "decode_block"),
                      args.out)
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models.llama import LlamaForCausalLM, get_config

    cfg = get_config("llama3-8b")
    with torch.device("meta"):
        model = LlamaForCausalLM(cfg)
    config = {"dtype": "bfloat16", "max_out_tokens": 2048,
              "enable_cuda_graph": args.cuda_graph}
    if args.weights != "bf16":
        config["quant"] = {"enabled": True, "qtype": args.weights}
    engine = deepspeed_tpu_torch.init_inference(
        model, config=config,
        generator=torch.Generator(device="cuda").manual_seed(0))
    prompts = torch.randint(0, cfg.vocab_size, (4, 1000),
                            generator=torch.Generator().manual_seed(0))
    engine.generate(prompts, max_new_tokens=4)             # warm-up
    engine.generate(prompts, max_new_tokens=args.new)      # its capture
    out = {"device": torch.cuda.get_device_name(0), "weights": args.weights,
           "cuda_graph": args.cuda_graph, "batch": 4, "prompt": 1000,
           "new_tokens": args.new}
    out["prefill"] = profile(
        lambda: engine.generate(prompts, max_new_tokens=1), args.top)
    out["generate"] = profile(
        lambda: engine.generate(prompts, max_new_tokens=args.new), args.top)
    return report(out, ("prefill", "generate"), args.out)


def report(out, windows, path) -> int:
    for name in windows:
        r = out[name]
        print(f"{name}: wall {r['wall_ms']:.1f} ms, device busy "
              f"{r['device_busy_ms']:.1f} ms ({r['device_busy_share']:.1%})")
        for row in r["top_kernels"]:
            print(f"  {row['device_ms']:9.3f} ms {row['share']:6.1%} "
                  f"x{row['calls']:<5d} {row['kernel']}")
        for cls, v in {**r.get("by_class", {}),
                       **r.get("by_module", {})}.items():
            print(f"  {cls}: {v['ms']:.3f} ms, {v['ms_per_tick']:.3f} ms a "
                  "tick" + (f", {v['launches_per_tick']:g} launches a tick"
                            if "launches" in v else ""))
        for tag, v in r.get("ranges", {}).items():
            print(f"  {tag}: x{v['calls']} host {v['host_ms']:.2f} ms, "
                  f"device {v['device_ms']:.2f} ms")
    if "serving_stages" in out:
        print(f"serving_stages: {out['serving_stages']}")
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
