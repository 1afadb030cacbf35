"""Ragged / continuous-batching inference engine (v2) for the H100.

Counterpart of ``deepspeed_tpu/inference/v2/ragged_engine.py`` (the
reference ``InferenceEngineV2``, ``inference/v2/engine_v2.py:30``, with
Dynamic SplitFuse scheduling): requests of different lengths share one
running batch, and a sequence joins the moment a slot frees.

- **Blocked KV.**  KV lives in fixed-size pages addressed by a
  per-sequence page table (:mod:`~deepspeed_tpu_torch.inference.paged`);
  device memory scales with pages, not ``max_seqs x max_seq_len``.
  Allocation is host-side (:class:`PageAllocator`): on demand with
  eviction when the pool runs dry, or worst case at admission.
- **One fused forward per tick.**  A ``[1, T]`` token batch,
  ``T = max_seqs + prefill_chunk``, carries one decode token for every
  ready sequence AND this tick's prefill chunk(s); raggedness lives in
  int32 metadata (``cu_q_lens`` et al.).  Every layer writes its K/V
  rows into its pool in place and runs the hand-written ragged
  paged-attention kernel (``ops/csrc/ragged_paged_attn.cu``), over
  full-width or int8/fp8 pages.
- **The decode block.**  When every live sequence is past prefill,
  ``step()`` runs ``decode_block_size`` decode ticks in a Python loop
  that enqueues everything on the current stream: ``kv_lens``, write
  rows and positions derive from the ``pos``/``active``/``remaining``
  carry on the device, sampling is batched and position-keyed on the
  device, and nothing is read on the host until the block's one
  device-to-host copy.  The host round trip amortizes to 1/K.  Every
  block runs over one set of static device buffers
  (:mod:`~deepspeed_tpu_torch.inference.v2.graphs`), loaded by ``copy_``.
- **CUDA graphs** (``enable_cuda_graph`` in the config, A8b).  The
  block is captured once per ``sampled`` flag over those buffers and
  replayed: one launch a block where the Python loop issues over a
  thousand a tick.
- **The pipelined host path** (``pipeline=True``, the default, A8a),
  the reference's software pipeline: the decode carry stays resident on
  the device across blocks, the host plans block k+1 from an exact
  projection of every sequence's length and budget while the device
  runs block k (at most ``async_depth`` blocks in flight, on the
  bounded window of :mod:`~deepspeed_tpu_torch.utils.async_stage`), and
  tokens are harvested in one blocking copy every ``harvest_interval``
  blocks.  A harvest is forced wherever the unpipelined engine could
  reap, admit or evict, so the blocks dispatched and their inputs are
  the unpipelined engine's: outputs are bit-identical with the pipeline
  on or off, greedy or sampled.  In steady state a block makes no
  upload (the page table only when it grows) and no blocking fetch.

Greedy outputs equal the JAX engine's token for token, pipelined or not
(same scheduling, same admission and eviction decisions); sampled
outputs agree in distribution, drawn from a position-keyed hash instead of
JAX's threefry streams (:mod:`~deepspeed_tpu_torch.inference.sampling`).

- **Quantized weights.**  ``quantize_weights`` stores every matmul
  weight as int8 with fp32 group scales, fp8 e4m3 with one scale a
  tensor, or packed fp6 e3m2 with group scales (groups of 2048, the
  quantizer's default, as the reference passes none), quantized once when
  the engine is built and dequantized at use in every model tick; or, with
  ``"w8a8"`` on a module class with ``w8a8_native``, as int8 with one
  scale an output channel that every Linear consumes natively (activations
  quantized per row, an int8 product with int32 sums), the embedding as
  group-wise int8 (:mod:`~deepspeed_tpu_torch.inference.quantization`).

- **KV tiering** (``kv_tiering``, :mod:`~deepspeed_tpu_torch.inference.
  kv_tiering`).  When every live sequence is page-stalled, the coldest
  one is parked in pinned host RAM, overflowing to NVMe, instead of being
  evicted: its live pages are packed on the device and copied to the
  host in one transfer, digested per page, and on re-admission verified
  and written back into fresh pages in place (``index_copy_``: the pool
  tensors a captured decode block replays over are never rebound).  A
  payload that fails verification beyond repair is quarantined and the
  request re-prefills from the front of the queue.  Eviction remains
  for when the tiers are full.  ``export_parked``/``import_parked`` move
  parked sessions between engines in spill format.  The pipelined loop
  starts NVMe -> host reads for the queue's spilled head while a block
  runs.
- **The prefix cache** (``prefix_cache``, :mod:`~deepspeed_tpu_torch.
  inference.prefix_cache`).  Admission attaches every fully matched,
  resident prefix page read-only (refcounted) and prefills only the
  suffix; a full match copies its last page on write (COW) and
  re-prefills one token, so the first token comes from the same fused
  tick as without the cache.  Full prefill pages register as they
  complete.  With tiering on, cold index pages demote into the tiers
  under their prefix hash and revive at a later match, and a spilled
  sequence keeps its shared prefix pages resident behind spill-holds.
- **Speculative decoding** (``speculation``, A9.4).  Each tick of a
  speculative decode block drafts ``k`` tokens a slot, by prompt lookup
  over a device-resident token history (``ngram``) or with a small
  same-vocab draft model that keeps its own paged pools on the target's
  page table and cursors (``draft``), and the target scores all ``k+1``
  positions in one ragged chunk of ``k+1`` rows a slot, for about one
  weight read.  Greedy slots accept the longest prefix that matches the
  target's argmax, so their output is the non-speculative output;
  sampled slots use rejection sampling with keyed draws, so their output
  is distributed as plain sampling
  (:func:`~deepspeed_tpu_torch.inference.sampling.speculative_verify`).
  Rollback is position rollback: rows written for rejected positions are
  written again before any query attends to them.  The block runs with
  no host read, is captured in a CUDA graph like the plain block, and
  pipelines: the host keeps bounds on each slot's advance (one to
  ``k+1`` tokens a tick), grows pages to the fast bound and forces a
  harvest as soon as a finish is possible.  Unlike the reference, each
  tick's first draft step also writes the draft's row one below the
  cursor, which after a tick that accepted every proposal holds the
  last proposal, a token no draft step processed.
- **Long context** (``kv_tiering={"long_context": True, ...}``, A9.5).
  A request whose KV outgrows the device pool keeps only its sink pages,
  a recent window and the group in flight resident; the middle parks in
  the tiers in groups of ``chunk_pages`` and streams back every tick
  through a layer-major chunked attention scan that folds flash stats
  into the paged kernels' carry
  (:mod:`~deepspeed_tpu_torch.inference.v2.long_context`).  Such a
  sequence ticks eagerly, outside the fused batch and the decode block;
  while one is live the other sequences take the fused tick.

- **Disaggregated serving** (A9.7).  A request put with
  ``handoff=True`` (the scale-out router marks long prompts so on a
  prefill-role replica) runs its prefill and first token here, then
  leaves its slot before any decode block: ``_handoff_sweep`` spills its
  KV to the tiers (or, without room, folds it to a re-prefill
  continuation) and parks it for :meth:`export_handoff`.  The blobs are
  :meth:`export_parked`'s, and :meth:`import_handoff` on a decode-role
  replica admits them through the spilled-request path, each restored
  page verified against the donor's spill-time digest, so greedy tokens
  equal a fused engine's.  The ``handoff.import`` fault site can flip
  wire bits: the restore then quarantines the payload and re-prefills.
- **Telemetry.**  Lifecycle events (submit, admit, prefill chunks,
  decode blocks, spill, restore, prefix, handoff, reap) go to the
  process tracer when it is on; ``slo`` objectives are fed every reaped
  request, and ``trace_sample`` arms tail-based sampling
  (:mod:`~deepspeed_tpu_torch.telemetry`).

- **Sparse MoE.**  Mixtral and Qwen2-MoE serve like Llama: every row of
  a tick is routed, padding and inactive rows included, so capacity
  drops the copies the JAX engine drops; the router stays fp32, as the
  JAX engine (which casts no parameter) leaves it.  ``quantize_weights``
  "int8", "fp8" and "fp6" quantize the expert banks too, each expanded
  whole once a layer a tick; "w8a8" is refused, as the JAX engine
  refuses it (an expert bank is no Linear a native W8A8 product reads).
  A Mixtral or Qwen2-MoE draft model serves like a dense one; its
  catch-up chunks are padded to ``prefill_chunk`` rows, as the JAX
  engine pads them, so its capacity sees the JAX draft's rows.
- **The control plane** (``control``, A10b).  :meth:`knob_registry` is
  the engine's typed knob surface; an armed
  :class:`~deepspeed_tpu_torch.control.controller.Controller` ticks every
  ``interval`` steps on the host loop, seeded from a per-host profile
  before any capture.  The knobs that a captured block bakes in
  (``decode_block_size``, ``spec_k``) are offline only; setting one
  drops the captured graphs, so the next block captures again.

Not ported yet, raising ``NotImplementedError`` that names its ROADMAP
item: tensor parallelism (A7a).
"""
from __future__ import annotations

import dataclasses
import itertools
import time
import weakref
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.common import (HostStageStats,
                                                  kv_quant_block, logits_of,
                                                  normalize_params)
from deepspeed_tpu_torch.inference.config import (ControlConfig,
                                                  KVTieringConfig,
                                                  PrefixCacheConfig,
                                                  SpeculationConfig,
                                                  load_inference_config)
from deepspeed_tpu_torch.inference.kv_tiering import (KVRestoreError,
                                                      TieredKVStore)
from deepspeed_tpu_torch.inference.paged import (KV_CACHE_DTYPES,
                                                 PageAllocator, PagedKVPool,
                                                 RaggedMeta, kv_dequant_path,
                                                 pages_for)
from deepspeed_tpu_torch.inference.prefix_cache import (ROOT_HASH,
                                                        PrefixCacheIndex)
from deepspeed_tpu_torch.inference.quantization import check_format
from deepspeed_tpu_torch.inference.sampling import (ROLE_DRAFT,
                                                    filter_logits_batched,
                                                    gumbel_noise,
                                                    position_keys,
                                                    role_keys,
                                                    sample_logits_batched,
                                                    speculative_verify)
from deepspeed_tpu_torch.inference.v2.graphs import DecodeBlockGraphs
from deepspeed_tpu_torch.moe.layer import is_moe
from deepspeed_tpu_torch.ops.ragged_paged_attention import PAGE_SIZES
from deepspeed_tpu_torch.resilience import faults
from deepspeed_tpu_torch.telemetry import trace
from deepspeed_tpu_torch.telemetry.metrics import metrics as _metrics
from deepspeed_tpu_torch.telemetry.requests import RequestLatencyTracker
from deepspeed_tpu_torch.telemetry.slo import SLOSet, TailSampler
from deepspeed_tpu_torch.utils.async_stage import (BoundedAsyncStage,
                                                   StageTimers)
from deepspeed_tpu_torch.utils.logging import log_dist, logger

# the upper bounds of the engine.harvest_interval and engine.async_depth
# knobs (the reference's), which size the harvest ring
_HARVEST_HI, _DEPTH_HI = 16, 8

# _block_arrays' order
_BLOCK_ARRAYS = ("last_tok", "pos", "active", "remaining", "eos_ids",
                 "do_sample", "temperature", "top_k", "top_p", "seeds")


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch v2 engine yet: ROADMAP {item}")


def _tiering_config(kv_tiering) -> KVTieringConfig:
    """A dict means ``enabled`` unless it says otherwise."""
    if isinstance(kv_tiering, dict):
        return KVTieringConfig(**{"enabled": True, **kv_tiering})
    return kv_tiering


def _spec_config(speculation) -> SpeculationConfig:
    """A mode string or a dict means a :class:`SpeculationConfig`."""
    if isinstance(speculation, str):
        return SpeculationConfig(mode=speculation)
    if isinstance(speculation, dict):
        return SpeculationConfig(**speculation)
    return speculation


def _llama_family(cfg) -> bool:
    """A Llama-family module config of this package: per-token positions
    through attention and a paged-cache config."""
    return dataclasses.is_dataclass(cfg) and {
        "rope_theta", "paged_decode", "decode"} <= {
            f.name for f in dataclasses.fields(cfg)}


def _prefix_config(prefix_cache) -> PrefixCacheConfig:
    """A bool switches the cache; a dict means ``enabled`` unless it
    says otherwise."""
    if isinstance(prefix_cache, bool):
        return PrefixCacheConfig(enabled=prefix_cache)
    if isinstance(prefix_cache, dict):
        return PrefixCacheConfig(**{"enabled": True, **prefix_cache})
    return prefix_cache


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                    # [P] int32
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    # prefill->decode handoff: the engine runs the prefill and the first
    # token, then parks the session for export_handoff instead of
    # decoding it here
    handoff: bool = False
    # runtime state
    slot: int = -1
    prefill_done: int = 0                 # context tokens already cached
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # prefill SOURCE: the prompt, or prompt + already-generated tokens
    # after an eviction (the continuation re-prefills its own output)
    ctx: Optional[np.ndarray] = None
    # tiered-KV spill metadata while the sequence's pages sit in host RAM
    # or on NVMe (None: not spilled); the page bytes live in the engine's
    # TieredKVStore under the uid.  With a prefix cache, "shared_pages"
    # are shared prefix pages held resident by spill-holds instead of
    # spilled (only private pages go to the tiers)
    spilled: Optional[Dict[str, Any]] = None
    # prefix-cache registration cursor: pc_pages full pages of ctx are in
    # the index, pc_parent is the chain hash there, and pc_cached counts
    # the prefill tokens this admission skipped by attaching
    pc_parent: int = ROOT_HASH
    pc_pages: int = 0
    pc_cached: int = 0
    # long context (kv_tiering.long_context): the KV outgrows the device
    # pool, so only the sinks and the recent window stay resident and the
    # LongContextDriver ticks the sequence outside the fused batch.
    # lc_parked counts the middle page GROUPS parked in the tiers under
    # "mid-<uid>-<g>" (always a contiguous prefix of the middle)
    lc: bool = False
    lc_parked: int = 0

    @property
    def ctx_len(self) -> int:
        return int(self.ctx.size if self.ctx is not None
                   else self.prompt.size)

    @property
    def length(self) -> int:
        # tokens in the KV cache: prefilled context + tokens generated
        # AFTER that context (an evicted continuation's ctx already
        # contains its earlier output)
        return self.prefill_done + len(self.generated) - \
            (self.ctx_len - self.prompt.size)


class RaggedInferenceEngineV2:
    """``put_request`` -> repeated ``step()`` -> ``get_outputs``.

    One ``step()`` = (admit waiting requests into free slots, reserving
    KV pages) + EITHER one fused SplitFuse tick (any sequence still
    prefilling: a decode token for every ready sequence plus prompt
    chunks, in one ``T = max_seqs + prefill_chunk`` batch) OR one
    ``decode_block_size``-tick decode block (everyone decoding).
    """

    def __init__(self, model: nn.Module, params: Any = None,
                 max_seqs: int = 8, max_seq_len: int = 512,
                 prefill_chunk: int = 128, seed: int = 0,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 topology=None, decode_block_size: int = 8,
                 kv_cache_dtype: Optional[str] = None,
                 kv_pool_bytes: Optional[int] = None,
                 quantize_weights: Optional[str] = None,
                 kv_reserve: str = "on_demand",
                 pipeline: Optional[bool] = None,
                 async_depth: Optional[int] = None,
                 harvest_interval: Optional[int] = None,
                 speculation: Any = None,
                 draft_model=None, draft_params: Any = None,
                 draft_kv_cache_dtype: Optional[str] = None,
                 kv_tiering: Any = None, prefix_cache: Any = None,
                 slo: Any = None, trace_sample: Optional[int] = None,
                 replica: Optional[str] = None, control: Any = None,
                 config: Any = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        """``model``: a Llama-family module of this package, Mixtral and
        Qwen2-MoE included (build it under ``torch.device("meta")`` to
        have its weights made directly in its ``config.dtype`` on the
        card).  ``params``: a
        ``state_dict`` (e.g. from the flax bridge); without one a meta
        model gets random weights from ``generator``.  ``seed`` keys the
        position-keyed sampling draws (the reference's ``rng``).
        ``device``: ``cuda`` by default, the CPU only when asked for.

        ``kv_cache_dtype``: ``None`` (config ``v2.kv_cache_dtype``
        decides; "none" by default) | "none" | "int8" | "fp8" |
        "fp8_e4m3" — the pool's page format.  ``kv_pool_bytes`` sizes the
        pool by a byte budget when ``num_pages`` is not given.
        ``kv_reserve``: "on_demand" (admit on context + one decode
        block of pages, grow per block, evict and requeue as a
        continuation when the pool runs dry) or "worst_case" (reserve
        prompt + max_new_tokens at admission).  ``quantize_weights``:
        ``None``, "int8", "fp8", "fp6" (weight-only; int8 and fp6 in groups
        of 2048) or "w8a8" (int8 weights and activations, products in
        int8; needs a module class with ``w8a8_native``, else it raises).
        ``replica`` is the scale-out metric label.  ``pipeline``,
        ``async_depth``, ``harvest_interval``: the pipelined host path
        (module docstring);
        ``None`` takes the config's ``v2`` subtree (on, 2, 4 by
        default).  ``config["enable_cuda_graph"]`` replays decode blocks
        from CUDA graphs on ``cuda`` (a failed capture raises); a CPU
        engine runs the same static buffers eagerly.
        ``kv_tiering``: ``None`` (the config's ``v2.kv_tiering`` decides;
        off by default), a dict (``enabled`` unless it says otherwise) or
        a :class:`KVTieringConfig`: the host-RAM and NVMe spill tiers
        (module docstring); needs ``kv_reserve="on_demand"``.
        ``prefix_cache``: ``None`` (the config decides; off by default),
        a bool, a dict or a :class:`PrefixCacheConfig`.
        ``speculation``: ``None`` (the config's ``v2.speculation``
        decides; off by default), a mode string ("off", "ngram",
        "draft"), a dict or a :class:`SpeculationConfig` (``k`` drafted
        tokens a tick, the ``ngram`` length).  ``mode="draft"`` needs
        ``draft_model`` (a Llama-family module of this package with the
        target's vocabulary, built under ``torch.device("meta")`` to have
        its weights made on the card) and ``draft_params`` as
        ``params``; ``draft_kv_cache_dtype`` is its pools' format, the
        target's by default.  ``kv_tiering["long_context"]`` serves a
        request whose KV outgrows the pool by partial residency (module
        docstring; ``sink_pages``, ``window_pages``, ``chunk_pages``);
        it refuses ``quantize_weights`` and models outside
        ``LlamaForCausalLM``.  ``slo``: ``None`` (the config's
        ``v2.slo`` decides; off by default), objective strings like
        ``"ttft_ms_p99 <= 150"`` or an :class:`SLOSet`: every reaped
        request feeds it, ``serving_stages()["slo"]`` reports the burn.
        ``trace_sample``: tail-based trace sampling 1-in-N (kwarg >
        config ``v2.trace_sample`` > env ``DSTPU_TRACE_SAMPLE``); N > 0
        arms the process tracer's sampling mode.  ``replica`` labels this
        engine's metric children (scale-out serving).  ``control``:
        ``None`` (the config's ``v2.control`` decides; off by default), a
        bool, a dict (``enabled`` unless it says otherwise) or a
        :class:`ControlConfig`: the closed-loop controller (module
        docstring).  ``topology`` raises ``NotImplementedError``."""
        mcfg = getattr(model, "config", None)
        if not _llama_family(mcfg):
            raise TypeError(
                "the ragged engine needs a Llama-family module of this "
                "package (per-token positions through attention and a "
                "paged-cache config)")
        icfg = load_inference_config(config)      # defaults without one
        v2cfg = icfg.v2
        kv_tiering = _tiering_config(
            v2cfg.kv_tiering if kv_tiering is None else kv_tiering)
        prefix_cache = _prefix_config(
            v2cfg.prefix_cache if prefix_cache is None else prefix_cache)
        speculation = _spec_config(
            v2cfg.speculation if speculation is None else speculation)
        if config is not None:
            slo = v2cfg.slo if slo is None else slo
            trace_sample = (v2cfg.trace_sample if trace_sample is None
                            else trace_sample)
            control = v2cfg.control if control is None else control
        self._check_unported(topology, quantize_weights)
        if quantize_weights == "w8a8" and not getattr(
                type(model), "w8a8_native", False):
            why = " (its expert banks are no Linear)" if is_moe(model) else ""
            raise ValueError(
                f"quantize_weights='w8a8' needs a model whose layers all "
                f"consume w8a8 weights natively (LlamaForCausalLM); "
                f"{type(model).__name__} does not{why}: use weight-only "
                f"'int8', as the JAX v2 engine asks")
        # kwarg > config > default, as for every v2 knob
        pipeline = v2cfg.pipeline if pipeline is None else pipeline
        async_depth = (v2cfg.async_depth if async_depth is None
                       else async_depth)
        harvest_interval = (v2cfg.harvest_interval
                            if harvest_interval is None else harvest_interval)
        kv_cache_dtype = str(v2cfg.kv_cache_dtype if kv_cache_dtype is None
                             else kv_cache_dtype)
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of "
                             f"{KV_CACHE_DTYPES}, got {kv_cache_dtype!r}")
        if int(page_size) not in PAGE_SIZES:
            raise ValueError(f"page_size {page_size} not in {PAGE_SIZES} "
                             "(the paged-attention kernel's tiles)")
        if kv_reserve not in ("on_demand", "worst_case"):
            raise ValueError(f"kv_reserve must be on_demand|worst_case, "
                             f"got {kv_reserve!r}")
        if kv_tiering.enabled and kv_reserve != "on_demand":
            raise ValueError(
                "kv_tiering needs kv_reserve='on_demand': the spill tiers "
                "are the on-demand model's overflow, and a worst-case "
                "reservation could never admit what they hold")
        self.kv_cache_dtype = kv_cache_dtype
        self.device = resolve_device(device)
        self.dtype = mcfg.dtype
        self.pipeline = bool(pipeline)
        self.async_depth = max(int(async_depth), 1)
        self.harvest_interval = max(int(harvest_interval), 1)

        self.page_size = int(page_size)
        self.pages_per_seq = pages_for(max_seq_len, self.page_size)
        if num_pages is None and kv_pool_bytes is not None:
            page_bytes = self._page_bytes(mcfg)
            num_pages = max(2, int(kv_pool_bytes) // page_bytes)
        if num_pages is None:
            # full provisioning: every slot can reach max_seq_len
            num_pages = 1 + max_seqs * self.pages_per_seq
        self.num_pages = int(num_pages)
        self.cfg = dataclasses.replace(
            mcfg, decode=True, paged_decode=True, max_cache_len=max_seq_len,
            kv_page_size=self.page_size, kv_num_pages=self.num_pages,
            kv_cache_dtype=kv_cache_dtype,
            **({"weight_quant": "w8a8"} if quantize_weights == "w8a8"
               else {}))
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len
        self.prefill_chunk = prefill_chunk
        self.T = max_seqs + prefill_chunk          # fused batch width
        self.decode_block_size = max(int(decode_block_size), 1)
        self.kv_reserve = kv_reserve
        self.evictions = 0
        self.seed = int(seed)
        self.replica = "" if replica is None else str(replica)
        self.host_stats = HostStageStats(replica=self.replica)
        # the pipelined window's substrate counters (submitted/completed
        # blocks, submit_wait back-pressure): serving_stages()'s
        # ``pipeline_window``
        self._pipe_timers = StageTimers(cat="serving")
        self.request_latency = RequestLatencyTracker(replica=self.replica)
        # SLO objectives and tail-based trace sampling, evaluated at reap
        # time on the host, never in the dispatch path
        if slo is None or slo is False or (isinstance(slo, (list, tuple))
                                           and not slo):
            self.slo = None
        elif isinstance(slo, SLOSet):
            self.slo = slo
        else:
            self.slo = SLOSet(list(slo))
        n = int(trace_sample) if trace_sample is not None else trace.sample_n
        self._tail_sampler = (TailSampler(n=n)
                              if (trace.sampling or n > 0) else None)
        if n > 0 and not trace.sampling:
            # an explicit engine or config N arms the tracer's sampling
            # mode as DSTPU_TRACE_SAMPLE does
            trace.configure(enabled=True, sampling=True, sample_n=n)

        # an MoE router stays fp32, as the JAX v2 engine leaves it; a
        # quantized meta model is built module by module
        self.quantize_weights = quantize_weights
        self.module = normalize_params(
            model, params, dtype=self.dtype, device=self.device,
            generator=generator, keep_fp32=True,
            quantize=None if quantize_weights is None else dict(
                fmt=quantize_weights, native_w8a8=True)).eval()
        self.allocator = PageAllocator(self.num_pages, self.page_size)
        self.page_table = np.full((max_seqs, self.pages_per_seq), -1,
                                  np.int32)
        self.cache = self._make_pools(self.cfg, kv_cache_dtype)
        # decode-block constants: every slot is one 1-token sequence (a
        # k+1-token one in a verify tick); a draft catch-up chunk is one
        # sequence
        self._block_cu = torch.arange(max_seqs + 1, dtype=torch.int32,
                                      device=self.device)
        self._block_ns = torch.tensor([max_seqs], dtype=torch.int32,
                                      device=self.device)
        self._one_seq = torch.ones((1,), dtype=torch.int32,
                                   device=self.device)
        self._no_rows = torch.zeros((0,), dtype=torch.int64,
                                    device=self.device)
        self._setup_speculation(speculation, mcfg, draft_model,
                                draft_params, draft_kv_cache_dtype,
                                generator)
        self.enable_cuda_graph = bool(icfg.enable_cuda_graph)
        # every decode block runs over these static buffers, replayed
        # from CUDA graphs with enable_cuda_graph on cuda, eagerly else
        self._graphs = DecodeBlockGraphs(self, capture=self.enable_cuda_graph)
        if self.enable_cuda_graph and not self._graphs.capturing:
            log_dist("ragged engine: enable_cuda_graph on the CPU runs "
                     "the decode block's static buffers eagerly (CUDA "
                     "graphs exist only on cuda)", ranks=[0])
        # device-resident decode-loop state while the pipeline runs
        # ahead of the host (None: host state is authoritative), and the
        # harvest ring each pipelined block's outputs are copied into
        self._dev: Optional[Dict[str, Any]] = None
        self._rings: Dict[bool, Tuple[torch.Tensor, ...]] = {}
        self._uid = itertools.count()
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_seqs
        self.finished: List[Request] = []
        self._unclaimed: Dict[int, np.ndarray] = {}
        self._stalled: List[Request] = []
        self._last_tokens = np.zeros((max_seqs,), np.int64)
        # streaming cursor: generated-token count already reported per
        # uid (stream_deltas); cancels counts cancellations at any stage
        self._stream_cursor: Dict[int, int] = {}
        self.cancels = 0
        # prefill->decode handoff: sessions parked by _handoff_sweep, out
        # of the slots and out of the waiting queue, until export_handoff
        self._handoff_ready: List[Request] = []
        self.handoffs = 0              # sessions exported to a decoder
        self.handoff_folds = 0         # handoffs folded to a re-prefill

        # every pool leaf as [num_pages, bytes a page] uint8 views: the
        # spill gather, the restore scatter and the COW copy move page
        # bytes through them, in place (float8 has no index_copy_ on
        # every backend, bytes do)
        self._page_views = [
            t.view(torch.uint8).view(self.num_pages, -1)
            for pool in self.cache for t in (pool.pages, pool.scales)
            if t is not None]
        # -- tiered KV spill store (device pool -> host RAM -> NVMe)
        self._tier_cfg = kv_tiering
        self.tiering: Optional[TieredKVStore] = None
        # queued spilled sequences prefetched ahead of a possible reap
        self.prefetch_lookahead = max(int(kv_tiering.prefetch_lookahead), 1)
        self._sched_seq = 0            # step counter for victim coldness
        self._last_sched = np.zeros((max_seqs,), np.int64)
        self.spills = 0                # sessions spilled to the tiers
        self.restores = 0              # sessions restored from them
        if kv_tiering.enabled:
            self.tiering = TieredKVStore(
                page_shapes=[(v.shape[1],) for v in self._page_views],
                page_dtypes=[np.uint8] * len(self._page_views),
                pages_per_seq=self.pages_per_seq,
                host_pages=kv_tiering.host_pages,
                nvme_pages=kv_tiering.nvme_pages,
                nvme_dir=kv_tiering.nvme_dir,
                use_odirect=kv_tiering.use_odirect,
                prefetch=kv_tiering.prefetch, verify=kv_tiering.verify,
                checksum=kv_tiering.checksum,
                max_reread=kv_tiering.max_reread,
                nvme_fail_threshold=kv_tiering.nvme_fail_threshold,
                probe_every=kv_tiering.probe_every,
                pinned=self.device.type == "cuda")
        # -- cross-request prefix cache over the paged pool
        self._pfx_cfg = prefix_cache
        self._pfx: Optional[PrefixCacheIndex] = None
        if prefix_cache.enabled:
            self._pfx = PrefixCacheIndex(
                self.allocator, self.page_size,
                max_entries=prefix_cache.max_index_entries,
                min_match_pages=prefix_cache.min_match_pages)
            if self.tiering is not None:
                # under pool pressure, cold single-reference prefix pages
                # demote into the tiers keyed by prefix hash (one restore
                # serves every waiter) instead of being dropped; through
                # a proxy, so that the index holds no cycle to the engine
                me = weakref.proxy(self)
                self._pfx.demote = lambda e: me._pfx_demote(e)
                self._pfx.drop_spilled = self.tiering.drop
        # -- long context: LongContextDriver (its refusals raise here, at
        # construction)
        self._lc = None
        if self.tiering is not None and kv_tiering.long_context:
            from deepspeed_tpu_torch.inference.v2.long_context import \
                LongContextDriver
            self._lc = LongContextDriver(self)
        note = ""
        if self.tiering is not None:
            note = (f" kv_tiering=host:{kv_tiering.host_pages}"
                    f"+nvme:{kv_tiering.nvme_pages}p")
            if self._lc is not None:
                note += (f" long_context=sink:{kv_tiering.sink_pages}"
                         f"/window:{kv_tiering.window_pages}"
                         f"/chunk:{kv_tiering.chunk_pages}")
        if self._pfx is not None:
            note += (f" prefix_cache=max:{prefix_cache.max_index_entries}"
                     f"/min:{prefix_cache.min_match_pages}p")
        if self.spec_mode != "off":
            note += f" spec={self.spec_mode}/k={self.spec_k}"
        log_dist(
            f"RaggedInferenceEngineV2: max_seqs={max_seqs} "
            f"max_seq_len={max_seq_len} prefill_chunk={prefill_chunk} "
            f"pages={self.num_pages}x{self.page_size} "
            f"kv={kv_cache_dtype} decode_block={self.decode_block_size} "
            f"pipeline={self.pipeline} cuda_graph={self.enable_cuda_graph}"
            f"{note} device={self.device} (paged KV, fused SplitFuse step)",
            ranks=[0])
        self._setup_control(control)

    # -- construction helpers -------------------------------------------

    @staticmethod
    def _check_unported(topology, quantize_weights) -> None:
        """Raise for every feature asked for that this port lacks."""
        if topology is not None:
            raise _unported("tensor-parallel serving (topology)", "A7a")
        if quantize_weights is not None:
            check_format(quantize_weights)

    def _setup_control(self, control) -> None:
        """The closed-loop control plane (the reference's
        ``ragged_engine.py:715-757``): ticks on this host loop (``step``
        counts engine steps), no thread of its own.  ``DSTPU_CONTROL=0``
        disarms it whatever the config says.  A profile seeds the knobs
        here, before any warm-up or capture, so the knobs a captured
        block bakes in are still fair game."""
        from deepspeed_tpu_torch.control import (Controller, control_enabled,
                                                 engine_signal_feed,
                                                 host_fingerprint,
                                                 load_profile, prefetch_rule)

        if control is None:
            control = ControlConfig()
        elif isinstance(control, bool):
            control = ControlConfig(enabled=control)
        elif isinstance(control, dict):
            control = ControlConfig(**{"enabled": True, **control})
        self._control_cfg = control
        self._controller: Optional[Controller] = None
        self._control_steps = 0
        if not (control.enabled and control_enabled()):
            return
        knobs = self.knob_registry()
        prof = load_profile(control.profile,
                            fingerprint=host_fingerprint(self.device))
        if prof is not None:
            applied = knobs.apply_profile(prof.knobs)
            if applied:
                log_dist(f"control plane seeded from host profile "
                         f"{prof.key}: {applied}", ranks=[0])
        rules = [prefetch_rule()] if self.tiering is not None else []
        self._controller = Controller(
            knobs, engine_signal_feed(self), objective=control.objective,
            settle=control.settle, hysteresis=control.hysteresis,
            cooldown=control.cooldown, guard_window=control.guard_window,
            guard_reverts=control.guard_reverts, freeze=control.freeze,
            smooth=control.smooth, rules=rules)

    def _make_pools(self, c, fmt: str) -> List[PagedKVPool]:
        """One pool a layer of model config ``c``, in page format
        ``fmt``, over this engine's page ids."""
        return [PagedKVPool(self.num_pages, self.page_size,
                            c.num_key_value_heads, c.head_dim, fmt,
                            c.dtype, self.device)
                for _ in range(c.num_hidden_layers)]

    def _setup_speculation(self, speculation: SpeculationConfig, mcfg,
                           draft_model, draft_params, draft_kv_cache_dtype,
                           generator) -> None:
        """Speculative decoding's settings and, in draft mode, the draft
        model: its weights through :func:`normalize_params` as the
        target's, and its own paged pools over the target's page ids (the
        page table and cursors are shared; storage format
        ``draft_kv_cache_dtype``, the target's by default)."""
        self.spec_mode = speculation.mode
        self.spec_k = int(speculation.k)
        self.spec_ngram = int(speculation.ngram)
        # draft KV coverage per slot: positions below it hold the draft
        # model's K/V (reset whenever a slot changes hands); a
        # speculative block writes the two rows below its cursor itself
        self._draft_len = np.zeros((self.max_seqs,), np.int64)
        self.draft_catchup_chunks = 0      # catch-up prefill calls
        self._draft_module: Optional[nn.Module] = None
        self._draft_moe = False
        self._draft_cache: List[PagedKVPool] = []
        self.draft_kv_cache_dtype: Optional[str] = None
        if self.spec_mode != "draft":
            return
        if draft_model is None:
            raise ValueError(
                "speculation.mode='draft' needs a draft model: pass "
                "draft_model=<a small same-vocab Llama-family module of "
                "this package> and draft_params=... (the config's "
                "speculation.draft_model preset name is for CLIs to build "
                "one)")
        dmcfg = getattr(draft_model, "config", None)
        # an MoE draft routes every row of a catch-up chunk together
        # (capacity couples them): its chunks are padded as the JAX
        # engine pads them
        self._draft_moe = is_moe(draft_model)
        if not _llama_family(dmcfg):
            raise TypeError("the draft model must be a Llama-family module "
                            "of this package (the ragged paged decode "
                            "path's requirement)")
        if dmcfg.vocab_size != mcfg.vocab_size:
            raise ValueError(
                f"draft vocab {dmcfg.vocab_size} != target vocab "
                f"{mcfg.vocab_size}: speculative verify compares token "
                "ids, the models must share a tokenizer")
        fmt = str(self.kv_cache_dtype if draft_kv_cache_dtype is None
                  else draft_kv_cache_dtype)
        if fmt not in KV_CACHE_DTYPES:
            raise ValueError(f"draft_kv_cache_dtype must be one of "
                             f"{KV_CACHE_DTYPES}, got {fmt!r}")
        self.draft_kv_cache_dtype = fmt
        self._draft_cfg = dataclasses.replace(
            dmcfg, decode=True, paged_decode=True,
            max_cache_len=self.max_seq_len, kv_page_size=self.page_size,
            kv_num_pages=self.num_pages, kv_cache_dtype=fmt)
        self._draft_module = normalize_params(
            draft_model, draft_params, dtype=dmcfg.dtype,
            device=self.device, generator=generator).eval()
        self._draft_cache = self._make_pools(self._draft_cfg, fmt)

    def _page_bytes(self, mcfg) -> int:
        """Device bytes ONE page costs across every layer's pool (payload
        plus scale rows), counted from the pool tensors of a 2-page pool
        built on the meta device."""
        probe = [PagedKVPool(2, self.page_size, mcfg.num_key_value_heads,
                             mcfg.head_dim, self.kv_cache_dtype,
                             mcfg.dtype, torch.device("meta"))
                 for _ in range(mcfg.num_hidden_layers)]
        return sum(p.nbytes() for p in probe) // 2

    # -- request API ----------------------------------------------------

    def set_replica(self, replica: str) -> None:
        """Assign the scale-out metric label after construction
        (``ReplicaSet`` names engines built without one)."""
        self.replica = str(replica)
        self.host_stats.set_replica(self.replica)
        self.request_latency.set_replica(self.replica)

    def validate_request(self, prompt, max_new_tokens: int = 64) -> None:
        """The submit-time schedulability checks, without enqueuing —
        raises ``ValueError`` for a request that could never run on
        THIS engine."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(
                "max_new_tokens must be >= 1 (prefill seeds the first "
                "token)")
        total = prompt.size + max_new
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) = "
                f"{total} exceeds the engine token budget "
                f"max_seq_len={self.max_seq_len} — the request can never "
                "be scheduled; shorten the prompt or raise max_seq_len")
        total_pages = self.allocator.pages_for(total)
        usable = self.num_pages - 1
        if self.tiering is None:
            if total_pages > usable:
                raise ValueError(
                    f"request needs {total_pages} KV pages but the engine "
                    f"owns {usable} usable pages — even after evicting "
                    "every other sequence it could never be scheduled; "
                    "raise num_pages")
            return
        # with tiering, two bounds named apart: (1) with long context,
        # the RESIDENT WINDOW (sinks + window + group in flight + the
        # growth frontier) must fit the device pool; without it the
        # working-set bound stays an admission-time check, so a request
        # beyond the device pool is accepted while the others can spill
        # (max_new_tokens is a budget, not a promise); (2) the total
        # must fit the combined tiers
        if self._tier_cfg.long_context:
            resident_need = min(total_pages, self._lc_resident_pages())
            if resident_need > usable:
                raise ValueError(
                    f"request needs {resident_need} HBM-resident KV pages "
                    "(the partial-residency window: sink_pages + "
                    "window_pages + chunk_pages + 1) but the HBM tier "
                    f"owns {usable} usable pages — raise num_pages or "
                    "shrink the kv_tiering sink_pages/window_pages/"
                    "chunk_pages knobs")
        cap = usable + self.tiering.budget_pages
        if total_pages > cap:
            raise ValueError(
                f"request needs {total_pages} KV pages in total but the "
                f"combined tiers — HBM ({usable} usable) + host "
                f"({self.tiering.host_budget}) + NVMe "
                f"({self.tiering.nvme_budget}) — hold only {cap} — it "
                "could never be scheduled; raise num_pages or the "
                "kv_tiering host_pages/nvme_pages budgets")

    def put_request(self, prompt, **kw) -> int:
        """Queue a request; raises ``ValueError`` AT SUBMIT TIME for a
        request that could never be scheduled (admitting one would
        deadlock the FIFO queue behind an unschedulable head)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = int(kw.get("max_new_tokens", 64))
        self.validate_request(prompt, max_new)
        req = Request(uid=next(self._uid), prompt=prompt, **kw)
        if (self._lc is not None and self.allocator.pages_for(
                prompt.size + max_new) > self.num_pages - 1):
            # the whole KV cannot be resident: decode it under partial
            # residency (LongContextDriver)
            req.lc = True
        self.waiting.append(req)
        self.request_latency.on_submit(req.uid)
        if trace.enabled:
            trace.event("request_submit", cat="request", uid=req.uid,
                        prompt_len=int(prompt.size), max_new=max_new)
        return req.uid

    def get_outputs(self) -> List[Tuple[int, np.ndarray]]:
        out = list(self._unclaimed.items())
        self._unclaimed = {}
        out += [(r.uid, np.concatenate([r.prompt,
                                        np.asarray(r.generated, np.int32)]))
                for r in self.finished]
        self.finished = []
        for uid, _ in out:
            self._stream_cursor.pop(uid, None)
        return out

    def stream_deltas(self) -> List[Tuple[int, List[int], int, bool]]:
        """Incremental token harvest for streaming front ends: one
        ``(uid, new_tokens, total_generated, done)`` tuple per request
        whose generated-token count grew since the last call, plus every
        newly finished request.  Call BEFORE :meth:`get_outputs` in the
        same tick — collecting an output clears its cursor."""
        out: List[Tuple[int, List[int], int, bool]] = []
        cur = self._stream_cursor
        live = [r for r in self.slots if r is not None]
        for r in itertools.chain(live, self.waiting, self._handoff_ready):
            n = len(r.generated)
            seen = cur.get(r.uid, 0)
            if n > seen:
                out.append((r.uid, [int(t) for t in r.generated[seen:]],
                            n, False))
                cur[r.uid] = n
        for r in self.finished:
            n = len(r.generated)
            seen = cur.pop(r.uid, 0)
            out.append((r.uid, [int(t) for t in r.generated[seen:]],
                        n, True))
        return out

    def cancel(self, uid: int) -> Optional[str]:
        """Cancel one request at any stage, releasing its slot and pool
        pages, or its spilled payload and the spill-holds on its shared
        prefix pages, and a long-context request's parked groups.
        Returns the stage it was cancelled at (``"queued"`` /
        ``"spilled"`` / ``"handoff"`` / ``"prefill"`` / ``"decode"`` /
        ``"lc"`` / ``"finished"``) or ``None`` for an unknown uid (never
        submitted, or already collected)."""
        stage: Optional[str] = None
        # fold an active pipelined carry first: the target may be
        # mid-decode inside it, and the teardown re-anchors host state so
        # that the slot release below is authoritative (the target may
        # finish in this harvest, and then it is in ``finished``)
        dv = self._dev
        if dv is not None and any(r.uid == uid for r in dv["reqs"]):
            self._pipeline_harvest(teardown=True)
        for r in list(self.waiting):
            if r.uid == uid:
                self.waiting.remove(r)
                stage = "queued"
                if r.spilled is not None:
                    self._drop_spilled(r)
                    stage = "spilled"
                break
        if stage is None:
            # parked for a handoff the router never collected: release it
            # like a waiting spilled session
            for r in list(self._handoff_ready):
                if r.uid == uid:
                    self._handoff_ready.remove(r)
                    if r.spilled is not None:
                        self._drop_spilled(r)
                    stage = "handoff"
                    break
        if stage is None:
            for i, r in enumerate(self.slots):
                if r is None or r.uid != uid:
                    continue
                stage = ("lc" if r.lc
                         else "prefill" if r.prefill_done < r.ctx_len
                         else "decode")
                self._drop_lc_parked(r)
                self._release_slot(i)
                break
        if stage is None:
            for r in list(self.finished):
                if r.uid == uid:
                    self.finished.remove(r)
                    stage = "finished"
                    break
        if stage is None and uid in self._unclaimed:
            del self._unclaimed[uid]
            stage = "finished"
        if stage is None:
            return None
        self.cancels += 1
        self._stream_cursor.pop(uid, None)
        self.request_latency.on_cancel(uid)
        if trace.enabled:
            trace.event("request_cancel", cat="request", uid=int(uid),
                        stage=stage)
        return stage

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def sync(self) -> int:
        """Fold pipelined in-flight device work back into the host request
        state (the deferred harvest, now); returns the tokens folded.  A
        no-op when the pipeline is off or idle.  Call it before reading
        ``slots[*].generated`` between ``step()`` calls."""
        if self._dev is None:
            return 0
        return self._pipeline_harvest()

    def drain(self) -> Dict[int, np.ndarray]:
        """Run until every queued and resident request finishes; returns
        ``{uid: tokens}`` for everything reaped on the way (the replica
        shutdown half of the engine handle; ``close()`` releases the
        resources after)."""
        outs: Dict[int, np.ndarray] = {}
        # nobody is coming to collect a pending handoff during a drain:
        # finish those sessions here, through the normal spilled or
        # continuation re-admission path
        for r in self._handoff_ready:
            r.handoff = False
            self.waiting.append(r)
        self._handoff_ready = []
        while self.has_work():
            self.step()
            outs.update(self.get_outputs())
        self.sync()
        outs.update(self.get_outputs())
        return outs

    def _release_slot(self, i: int) -> None:
        """Free slot ``i``: its pages, its page-table row and its draft
        KV coverage."""
        self.allocator.free(i)
        self.page_table[i, :] = -1
        self.slots[i] = None
        self._draft_len[i] = 0

    def _drop_spilled(self, r: Request) -> None:
        """Release a parked request's spill-holds on shared prefix pages
        and its payload in the tiers."""
        for p in r.spilled.get("shared_pages", ()):
            self.allocator.decref(p)
        if self.tiering is not None:
            self.tiering.drop(r.uid)

    def _drop_lc_parked(self, r: Request) -> None:
        """Drop a long-context request's parked middle groups from the
        tiers."""
        if self.tiering is not None:
            for g in range(r.lc_parked):
                self.tiering.drop(f"mid-{r.uid}-{g}")
        r.lc_parked = 0

    def _reprefill(self, r: Request) -> None:
        """Make ``r`` a continuation that re-prefills prompt + its own
        generated tokens (greedy continuations are exact)."""
        r.ctx = np.concatenate([r.prompt, np.asarray(r.generated, np.int32)])
        r.prefill_done = 0
        r.pc_parent, r.pc_pages, r.pc_cached = ROOT_HASH, 0, 0

    def export_parked(self) -> List[Dict[str, Any]]:
        """Pop every PARKED session (the waiting queue: not yet admitted,
        spilled, or queued as a re-prefill continuation) as portable
        blobs for :meth:`import_parked` on another engine.  A spilled
        session's private pages travel in spill format (packed bytes and
        the spill-time digests, ``TieredKVStore.export_spilled``), so the
        receiver's restore verifies them end to end.  Shared prefix pages
        are rows of THIS engine's pool and cannot travel: a session
        holding any folds to a re-prefill continuation, which gives the
        same greedy output and pays its prefill again.  Pending handoffs
        the router never pulled leave with them: they are parked sessions
        like any other."""
        sessions = []
        for r in itertools.chain(self.waiting, self._handoff_ready):
            blob = self._session_blob(r)
            if trace.enabled:
                trace.event("request_export", cat="request", uid=r.uid,
                            spilled=blob["spill"] is not None)
            sessions.append(blob)
        self.waiting.clear()
        self._handoff_ready = []
        return sessions

    def _session_blob(self, r: Request) -> Dict[str, Any]:
        """The portable blob of one parked session (the reference's keys)."""
        blob: Dict[str, Any] = {
            "uid": int(r.uid),
            "prompt": np.asarray(r.prompt, np.int32),
            "max_new_tokens": int(r.max_new_tokens),
            "eos_token_id": r.eos_token_id,
            "do_sample": bool(r.do_sample),
            "temperature": float(r.temperature),
            "top_k": int(r.top_k),
            "top_p": float(r.top_p),
            "generated": [int(t) for t in r.generated],
            "ctx": None if r.ctx is None else np.asarray(r.ctx, np.int32),
            "prefill_done": int(r.prefill_done),
            "spill": None}
        if r.spilled is None:
            return blob
        shared = r.spilled.get("shared_pages", ())
        n_priv = int(r.spilled.get("n_pages", 0))
        holds = self.tiering is not None and self.tiering.holds(r.uid)
        if shared or (n_priv > 0 and not holds):
            # fold to a re-prefill continuation; release the spill-holds
            # and the orphaned payload
            self._drop_spilled(r)
            blob["ctx"] = np.concatenate(
                [r.prompt, np.asarray(r.generated, np.int32)])
            blob["prefill_done"] = 0
        else:
            blob["spill"] = {
                "last_tok": int(r.spilled["last_tok"]),
                "live_tokens": int(r.spilled["live_tokens"]),
                "payload": (self.tiering.export_spilled(r.uid)
                            if n_priv > 0 else None)}
        return blob

    def import_parked(self, sessions: List[Dict[str, Any]]) -> List[int]:
        """Install exported sessions as waiting requests under FRESH uids
        (uids are per engine), each spill payload parked in the local
        tiers with the donor's digests.  Returns the new uids in input
        order.  A payload the local tiers cannot hold folds to a
        re-prefill continuation."""
        new_uids: List[int] = []
        for s in sessions:
            req = Request(uid=next(self._uid),
                          prompt=np.asarray(s["prompt"], np.int32),
                          max_new_tokens=int(s.get("max_new_tokens", 64)),
                          eos_token_id=s.get("eos_token_id"),
                          do_sample=bool(s.get("do_sample", False)),
                          temperature=float(s.get("temperature", 1.0)),
                          top_k=int(s.get("top_k", 0)),
                          top_p=float(s.get("top_p", 1.0)))
            req.generated = [int(t) for t in s.get("generated", ())]
            ctx = s.get("ctx")
            req.ctx = None if ctx is None else np.asarray(ctx, np.int32)
            req.prefill_done = int(s.get("prefill_done", 0))
            sp = s.get("spill")
            if sp is not None:
                payload = sp.get("payload")
                installed = payload is None
                if payload is not None and self.tiering is not None:
                    try:
                        self.tiering.import_spilled(req.uid, payload)
                        installed = True
                    except (ValueError, RuntimeError):
                        installed = False
                if installed:
                    req.spilled = {
                        "last_tok": int(sp["last_tok"]),
                        "n_pages": (int(payload["n_pages"])
                                    if payload is not None else 0),
                        "live_tokens": int(sp["live_tokens"]),
                        "shared_pages": []}
                else:
                    self._reprefill(req)
            self.waiting.append(req)
            self.request_latency.on_submit(req.uid)
            if trace.enabled:
                trace.event("request_import", cat="request", uid=req.uid,
                            donor_uid=int(s.get("uid", -1)),
                            spilled=req.spilled is not None)
            new_uids.append(req.uid)
        return new_uids

    # -- disaggregated serving: prefill -> decode handoff ---------------

    def export_handoff(self) -> List[Dict[str, Any]]:
        """Pop every session parked by :meth:`_handoff_sweep` (prefill and
        first token done, KV spilled to the tiers or folded to a re-prefill
        continuation) as blobs for :meth:`import_handoff` on a decode-role
        replica.  The wire format is :meth:`export_parked`'s: the receiver
        admits the session through the spilled-request path, so greedy
        outputs equal a fused engine's."""
        sessions: List[Dict[str, Any]] = []
        for r in self._handoff_ready:
            blob = self._session_blob(r)
            self.handoffs += 1
            self._stream_cursor.pop(r.uid, None)
            self.request_latency.on_handoff_out(r.uid)
            if trace.enabled:
                trace.event("request_handoff", cat="request", uid=r.uid,
                            spilled=blob["spill"] is not None,
                            generated=len(blob["generated"]))
            sessions.append(blob)
        self._handoff_ready = []
        return sessions

    def import_handoff(self, sessions: List[Dict[str, Any]],
                       export_t: Optional[float] = None) -> List[int]:
        """Decode-role half of the handoff: install the sessions through
        :meth:`import_parked` (fresh uids, payloads parked in the local
        tiers with the DONOR's digests, so the restore verifies end to
        end) and stamp the export -> import stall (``export_t`` on
        ``time.perf_counter``'s clock) on each request's latency record.
        The ``handoff.import`` fault site fires once a session before it
        is installed; a ``bitflip`` directive corrupts the wire payload,
        which the digest-verified restore catches (re-read, then
        quarantine and re-prefill)."""
        for s in sessions:
            sp = s.get("spill")
            payload = None if sp is None else sp.get("payload")
            d = faults.hook("handoff.import", uid=int(s.get("uid", -1)))
            if (d is not None and d[0] == "bitflip"
                    and payload is not None):
                buf = np.frombuffer(bytearray(payload["payload"]), np.uint8)
                faults.apply_bitflip(buf, d[1])
                payload["payload"] = buf.tobytes()
        new_uids = self.import_parked(sessions)
        if export_t is not None:
            stall = max(time.perf_counter() - float(export_t), 0.0)
            for uid in new_uids:
                self.request_latency.on_handoff_stall(uid, stall)
        return new_uids

    # -- the control plane's knobs (A10b) ---------------------------------

    def _set_block_shape(self, decode_block_size: int, spec_k: int) -> None:
        """Change a knob that a captured block bakes in: a live pipeline
        is harvested and torn down first, then the captured graphs, their
        outputs and the harvest rings are dropped, so that the next block
        captures again (counted in ``graph_captures``)."""
        if self._dev is not None:
            self._pipeline_harvest(teardown=True)
        self.decode_block_size = max(int(decode_block_size), 1)
        self.spec_k = max(int(spec_k), 1)
        self._graphs.reset()
        self._rings.clear()

    def knob_registry(self):
        """The engine's typed knob surface for the control plane
        (:class:`~deepspeed_tpu_torch.control.knobs.KnobRegistry`), the
        reference's knobs with the same names, bounds, kinds and
        ``recompiles`` flags.

        Online-safe knobs: ``harvest_interval`` is read fresh each
        pipelined step; ``async_depth`` re-sizes the live decode window in
        place (it back-pressures on the next submit).  The harvest ring
        is sized for the knobs' upper bounds, so neither can lap it.
        ``decode_block_size`` and ``spec_k`` are baked into captured block
        shapes, so they carry ``recompiles=True``: reachable only by the
        offline sweep or profile seeding, never the online policy.
        Setting one drops the captured graphs (:meth:`_set_block_shape`).
        With tiering on, the tier store's prefetch toggle and IO-window
        depths ride along under ``kv.*``."""
        from deepspeed_tpu_torch.control.knobs import Knob, KnobRegistry

        reg = KnobRegistry()

        def _set_harvest(v):
            self.harvest_interval = max(int(v), 1)

        def _set_depth(v):
            self.async_depth = max(int(v), 1)
            if self._dev is not None:
                self._dev["window"].depth = self.async_depth

        reg.register(Knob(
            "engine.harvest_interval",
            lambda: self.harvest_interval, _set_harvest,
            lo=1, hi=_HARVEST_HI, step=1, kind="int",
            doc="pipelined decode blocks between token harvests"))
        reg.register(Knob(
            "engine.async_depth",
            lambda: self.async_depth, _set_depth,
            lo=1, hi=_DEPTH_HI, step=1, kind="int",
            doc="in-flight decode blocks in the pipeline window"))
        reg.register(Knob(
            "engine.decode_block_size",
            lambda: self.decode_block_size,
            lambda v: self._set_block_shape(v, self.spec_k),
            lo=1, hi=16, step=1, kind="int", recompiles=True,
            doc="device ticks per decode block (captured shape)"))
        if self.spec_mode != "off":
            reg.register(Knob(
                "engine.spec_k", lambda: self.spec_k,
                lambda v: self._set_block_shape(self.decode_block_size, v),
                lo=1, hi=8, step=1, kind="int", recompiles=True,
                doc="speculative draft length (captured shape)"))
        if self.tiering is not None:
            t = self.tiering

            def _set_prefetch(v):
                t.prefetch_enabled = bool(v) and t.nvme_budget > 0

            def _set_wdepth(v):
                t._writes.depth = max(int(v), 1)

            def _set_rdepth(v):
                t._reads.depth = max(int(v), 1)

            reg.register(Knob(
                "kv.prefetch", lambda: t.prefetch_enabled,
                _set_prefetch, kind="bool",
                doc="NVMe read-ahead on tier restore"))
            reg.register(Knob(
                "kv.write_depth", lambda: t._writes.depth, _set_wdepth,
                lo=1, hi=8, step=1, kind="int",
                doc="bounded spill write-back window depth"))
            reg.register(Knob(
                "kv.read_depth", lambda: t._reads.depth, _set_rdepth,
                lo=1, hi=8, step=1, kind="int",
                doc="bounded restore read-ahead window depth"))

            def _set_lookahead(v):
                self.prefetch_lookahead = max(int(v), 1)

            def _set_window(v):
                self._tier_cfg.window_pages = max(int(v), 1)

            reg.register(Knob(
                "kv.prefetch_lookahead",
                lambda: self.prefetch_lookahead, _set_lookahead,
                lo=1, hi=64, step=1, kind="int",
                doc="queued spilled sequences prefetched ahead of reap"))
            reg.register(Knob(
                "kv.window_pages",
                lambda: int(self._tier_cfg.window_pages), _set_window,
                lo=1, hi=64, step=1, kind="int",
                doc="recent device-resident pages per partially-resident "
                    "sequence (long-context residency window)"))
        return reg

    # -- stats ------------------------------------------------------------

    def serving_stages(self) -> Dict[str, Any]:
        """Per-dispatch host-path breakdown + ``host_bound_fraction``
        (:class:`~deepspeed_tpu_torch.inference.common.HostStageStats`),
        the quantized pool's ``kv_quant`` block, pool pressure and the
        per-request latency percentiles; with tiering the tier store's
        stats (``kv_tiering``), with the prefix cache the index's and the
        admissions' counters (``prefix_cache``), after any handoff its
        counts (``handoff``), with an armed controller its counts, knobs
        and frozen knobs (``control``), with objectives the SLO burn
        (``slo``), and with the metrics registry on its flat view
        (``metrics``)."""
        out = self.host_stats.serving_stages()
        if self.tiering is not None:
            out["kv_tiering"] = self.tiering.stats()
        if self._pfx is not None:
            st = self.host_stats
            pc = self._pfx.stats()
            pc.update(hit_requests=st.prefix_hits,
                      miss_requests=st.prefix_misses,
                      hit_tokens=st.prefix_hit_tokens,
                      cow_copies=st.prefix_cow_copies)
            out["prefix_cache"] = pc
        if self.kv_cache_dtype != "none":
            out["kv_quant"] = kv_quant_block(
                self.cache, self.kv_cache_dtype,
                kv_dequant_path(self.device), self.num_pages)
        usable = max(self.num_pages - 1, 1)
        in_use = usable - self.allocator.free_pages
        out["pool"] = {
            "num_pages": self.num_pages,
            "pages_in_use": int(in_use),
            "waiting_requests": len(self.waiting),
            "pressure": round(in_use / usable + len(self.waiting), 4)}
        if self.handoffs or self.handoff_folds or self._handoff_ready:
            out["handoff"] = {"exported": int(self.handoffs),
                              "folds": int(self.handoff_folds),
                              "pending": len(self._handoff_ready)}
        if self._pipe_timers.seconds or self._pipe_timers.counters:
            out["pipeline_window"] = self._pipe_timers.snapshot()
        if self.enable_cuda_graph:
            out.update(self.host_stats.graph_stages())
        if self._controller is not None:
            out["control"] = self._controller.stats()
        out["requests"] = self.request_latency.summary()
        if self.slo is not None:
            out["slo"] = self.slo.flat_summary()
        if _metrics.enabled:
            out["metrics"] = _metrics.scalar_summary()
            if self._tail_sampler is not None:
                out["trace_sampling"] = dict(self._tail_sampler.counters())
        return out

    def audit_kv_sharing(self) -> Dict[str, int]:
        """Refcount-conservation audit: every slot's page-table row is
        exactly the pages the allocator says it owns, and every page's
        refcount equals the holders that reach it: page-table rows,
        resident prefix-index entries and spill-holds on parked
        requests' shared prefixes (spilled payloads hold no pool page).
        Raises ``AssertionError`` on a leak; returns the allocator's
        counts."""
        external: Dict[int, int] = {}
        if self._pfx is not None:
            for e in self._pfx._entries.values():
                if e.state == "resident":
                    external[e.page] = external.get(e.page, 0) + 1
        for r in itertools.chain(self.waiting, self._handoff_ready):
            if r.spilled is not None:
                for p in r.spilled.get("shared_pages", ()):
                    external[p] = external.get(p, 0) + 1
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            row = [int(p) for p in self.page_table[s] if p >= 0]
            owned = self.allocator.owned_pages(s)
            assert row == owned, (
                f"slot {s}: page-table row {row} != allocator "
                f"ownership {owned}")
        return self.allocator.audit(external=external)

    def close(self) -> None:
        """Release the tier store (AIO handle, staging buffers, digest
        pool, spill files) and the prefix cache's holds.  Idempotent; a
        no-op with both off."""
        for r in itertools.chain(self.waiting, self._handoff_ready):
            if r.spilled is not None:
                for p in r.spilled.get("shared_pages", ()):
                    self.allocator.decref(int(p))
                r.spilled["shared_pages"] = []
        if self._pfx is not None:
            self._pfx.clear()
            self._pfx = None
        if self.tiering is not None:
            self.tiering.close()
            self.tiering = None

    def cache_bytes(self) -> int:
        """Device bytes held by the paged KV pools (scales with
        ``num_pages``, not with ``max_seqs * max_seq_len``)."""
        return sum(p.nbytes() for p in self.cache)

    # -- host <-> device funnels (every transfer is counted and timed) ---

    def _staged(self, x: np.ndarray) -> torch.Tensor:
        """A copy of ``x`` to send to the device (the host array may
        change before the copy runs): pinned on ``cuda``, so that the
        copy is queued on the stream without waiting for the device (the
        caching host allocator keeps the buffer until the copy has run)."""
        t = torch.from_numpy(np.ascontiguousarray(x))
        return t.pin_memory() if self.device.type == "cuda" else t.clone()

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        with self.host_stats.stage("upload"):
            self.host_stats.meta_uploads += 1
            return self._staged(x).to(self.device, non_blocking=True)

    def _upload_into(self, dst: torch.Tensor, x: np.ndarray) -> None:
        """Upload ``x`` into the static buffer ``dst`` (one counted
        upload, queued on the stream)."""
        with self.host_stats.stage("upload"):
            self.host_stats.meta_uploads += 1
            with torch.inference_mode():
                dst.copy_(self._staged(x), non_blocking=True)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """Blocking device -> host copy: the serving loop's only sync
        point (``host_stats.blocking_gets`` counts them)."""
        with self.host_stats.stage("device"):
            self.host_stats.blocking_gets += 1
            return t.cpu().numpy()

    @torch.inference_mode()
    def _forward(self, token_ids, positions, meta: RaggedMeta,
                 logit_rows=None) -> torch.Tensor:
        """One paged forward over a ``[1, T]`` batch: every layer writes
        its rows into its pool and attends; logits of ``logit_rows``
        (all ``T`` rows when None)."""
        out = logits_of(self.module(token_ids, positions=positions,
                                    kv_cache=self.cache, ragged_meta=meta,
                                    logit_rows=logit_rows))
        return out if logit_rows is not None else out[0]

    # -- the decode block -------------------------------------------------

    @torch.inference_mode()
    def _decode_block(self, sampled: bool, last_tok, pos, active, remaining,
                      page_table, eos_ids, do_sample, temperature, top_k,
                      top_p, seeds):
        """K decode ticks over ``[1, max_seqs]`` batches, enqueued on the
        current stream with no host read: write rows, ``kv_lens`` and
        positions derive from the carry on the device, sampling is
        batched and position-keyed on the device.  Finished rows park on
        the trash page.  Returns the whole carry and the block's tokens,
        ``(last_tok, pos, active, remaining, toks [K,S], mask [K,S])``,
        as the reference's block does (``ragged_engine.py:1611-1616``),
        so that a pipelined loop chains blocks on the device."""
        page, max_len = self.page_size, self.max_seq_len
        table0 = page_table.clamp_min(0).long()
        toks, produced = [], []
        for _ in range(self.decode_block_size):
            dest_page = table0.gather(1, (pos // page)[:, None])[:, 0]
            dest = torch.where(active, dest_page * page + pos % page, 0)
            meta = RaggedMeta(
                kv_lens=torch.where(active, pos + 1, 1).int(),
                page_indices=page_table, cu_q_lens=self._block_cu,
                num_seqs=self._block_ns, new_kv_dest=dest)
            logits = self._forward(last_tok[None],
                                   torch.where(active, pos, 0)[None], meta)
            # position-keyed rows: the draw at cache position `pos` is
            # the fused tick's draw for the same (uid, position)
            keys = position_keys(self.seed, seeds, pos) if sampled else None
            nxt = sample_logits_batched(logits, keys, do_sample,
                                        temperature, top_k, top_p)
            nxt = torch.where(active, nxt, last_tok)
            hit_eos = active & (nxt == eos_ids)
            remaining = remaining - active.long()
            toks.append(nxt)
            produced.append(active)
            pos = torch.where(active, pos + 1, pos)
            active = (active & ~hit_eos & (remaining > 0) &
                      (pos + 1 < max_len))
            last_tok = nxt
        return (last_tok, pos, active, remaining, torch.stack(toks),
                torch.stack(produced))

    def _block_arrays(self, reqs: List[Request]):
        """Host numpy decode-block state for ``reqs``."""
        S = self.max_seqs
        last_tok = np.asarray(self._last_tokens, np.int64)
        pos = np.zeros((S,), np.int64)
        active = np.zeros((S,), bool)
        remaining = np.zeros((S,), np.int64)
        eos_ids = np.full((S,), -1, np.int64)
        do_sample = np.zeros((S,), bool)
        temperature = np.ones((S,), np.float32)
        top_k = np.zeros((S,), np.int64)
        top_p = np.ones((S,), np.float32)
        seeds = np.zeros((S,), np.int64)   # per-row sampling key (uid)
        for r in reqs:
            s = r.slot
            pos[s] = min(r.length - 1, self.max_seq_len - 1)
            active[s] = True
            remaining[s] = r.max_new_tokens - len(r.generated)
            if r.eos_token_id is not None:
                eos_ids[s] = r.eos_token_id
            do_sample[s] = r.do_sample
            temperature[s] = r.temperature
            top_k[s] = r.top_k
            top_p[s] = r.top_p
            seeds[s] = r.uid
        return (last_tok, pos, active, remaining, eos_ids, do_sample,
                temperature, top_k, top_p, seeds)

    def _fold_block(self, reqs: List[Request], toks: np.ndarray,
                    mask: np.ndarray) -> int:
        """Fold one harvested [K, S] block into request state."""
        produced = 0
        for r in reqs:
            new = toks[mask[:, r.slot], r.slot]
            r.generated.extend(int(t) for t in new)
            produced += int(new.size)
            if new.size:
                self.request_latency.on_tokens(r.uid, len(r.generated))
        return produced

    def _block_inputs(self, reqs: List[Request]) -> Dict[str, np.ndarray]:
        """Every decode-block input for ``reqs``, by name."""
        inputs = dict(zip(_BLOCK_ARRAYS, self._block_arrays(reqs)))
        inputs["page_table"] = self.page_table
        return inputs

    def _step_block(self, reqs: List[Request], spec: bool = False) -> int:
        """Run one decode block, speculative when ``spec`` (after the
        draft's catch-up), and fold its tokens into the host request
        state: one metadata upload and one blocking copy per block."""
        st = self.host_stats
        S = self.max_seqs
        rows = self.decode_block_size * (self.spec_k + 1 if spec else 1)
        with st.stage("plan"):
            inputs = (self._spec_inputs(reqs) if spec
                      else self._block_inputs(reqs))
            sampled = bool(inputs["do_sample"].any())
        if spec:
            self._draft_catchup(reqs)
        self._graphs.ensure(sampled, spec)       # before the loads
        for name, a in inputs.items():
            self._graphs.load(name, a)
        if trace.enabled:
            trace.event("decode_block", cat="request",
                        uids=[r.uid for r in reqs],
                        ticks=self.decode_block_size, spec=bool(spec))
        with st.stage("verify" if spec else "dispatch"):
            st.dispatches += 1
            st.spec_dispatches += int(spec)
            out = self._graphs.run(sampled, spec)
            packed = torch.cat([out[4].reshape(-1), out[5].reshape(-1).long(),
                                out[0]] +
                               ([torch.stack(out[6:8])] if spec else []))
        st.ticks += self.decode_block_size
        packed = self._fetch(packed)
        st.harvests += 1
        with st.stage("harvest"):
            n = rows * S
            toks = packed[:n].reshape(rows, S)
            mask = packed[n:2 * n].reshape(rows, S).astype(bool)
            self._last_tokens = np.array(packed[2 * n:2 * n + S], np.int64)
            produced = self._fold_block(reqs, toks, mask)
            for r in reqs:
                self._maybe_finish(r)
            if spec:
                self._fold_spec(reqs, produced, int(packed[-2]),
                                int(packed[-1]))
            self._reap()
        return produced

    # -- speculative decoding (A9.4) --------------------------------------

    def _spec_grow_want(self, plen: int, rem: int) -> int:
        """Token coverage one speculative block needs for a slot at cache
        length ``plen`` with ``rem`` budget left: every tick WRITES k+1
        rows ahead of the cursor however many are accepted, so pages
        cover the widest span (writes past ``max_seq_len`` go to the
        trash page and need no backing)."""
        K1 = self.spec_k + 1
        ticks = min(self.decode_block_size, max(int(rem), 1))
        return int(min(plen + ticks * K1, self.max_seq_len))

    def _hist_array(self, reqs: List[Request]) -> np.ndarray:
        """The drafters' token history ``[S, max_seq_len + 1]``:
        ``hist[s, i]`` is the token at cache position ``i`` (prompt +
        generated, exact in the decode phase); the last column is the
        trash column inactive rows write to.  Built from host state at
        every block entry and pipeline start."""
        hist = np.zeros((self.max_seqs, self.max_seq_len + 1), np.int64)
        for r in reqs:
            seq = np.concatenate([r.prompt,
                                  np.asarray(r.generated, np.int32)])
            n = min(r.length, self.max_seq_len)
            hist[r.slot, :n] = seq[:n]
        return hist

    def _spec_inputs(self, reqs: List[Request]) -> Dict[str, np.ndarray]:
        """A speculative block's inputs: the decode block's, and the
        token history."""
        return dict(self._block_inputs(reqs), hist=self._hist_array(reqs))

    def _draft_catchup(self, reqs: List[Request]) -> None:
        """Bring the draft model's paged KV up to one below each slot's
        cursor (positions ``< length - 2``; the speculative block's first
        draft step processes the last two), in chunks of
        ``prefill_chunk`` tokens, one sequence a call.  A no-op for covered slots: inside a decode
        phase the speculative block keeps the draft's KV in step, so
        this runs at admission and re-admission (evict, spill and
        restore included).  A shared prefix page's draft rows are
        written by each sharer with the same tokens at the same
        positions.  An MoE draft's chunk is padded to ``prefill_chunk``
        rows as the JAX engine pads every chunk
        (``ragged_engine.py:1740-1764``): pad rows carry token 0 at the
        positions past ``take`` (clamped to ``max_seq_len - 1``), belong
        to no sequence and write their K/V to the trash page, so the
        draft's routing and capacity see the JAX draft's rows."""
        if self.spec_mode != "draft":
            return
        st = self.host_stats
        C, page = self.prefill_chunk, self.page_size
        with st.stage("draft"):
            for r in reqs:
                target = r.length - 2
                lo = int(self._draft_len[r.slot])
                if lo >= target:
                    continue
                seq = np.concatenate([r.prompt,
                                      np.asarray(r.generated, np.int32)])
                while lo < target:
                    take = min(C, target - lo)
                    rows = C if self._draft_moe else take
                    pos = np.arange(lo, lo + take)
                    pg = self.page_table[r.slot, pos // page]
                    assert (pg > 0).all(), "write into unallocated page"
                    ids = np.zeros((rows,), np.int64)
                    ids[:take] = seq[lo:lo + take]
                    qpos = np.minimum(np.arange(lo, lo + rows),
                                      self.max_seq_len - 1)
                    wdest = np.zeros((rows,), np.int64)   # pads: trash
                    wdest[:take] = pg * page + pos % page
                    ids, positions, kv_lens, table, cu, dest = [
                        self._upload(a) for a in (
                            ids[None], qpos[None].astype(np.int64),
                            np.asarray([lo + take], np.int32),
                            self.page_table[r.slot][None],
                            np.asarray([0, take], np.int32), wdest)]
                    meta = RaggedMeta(kv_lens, table, cu, self._one_seq,
                                      dest)
                    with torch.inference_mode():
                        self._draft_module(ids, positions=positions,
                                           kv_cache=self._draft_cache,
                                           ragged_meta=meta,
                                           logit_rows=self._no_rows)
                    self.draft_catchup_chunks += 1
                    lo += take
                self._draft_len[r.slot] = target

    def _ngram_propose(self, hist, pos, last_tok):
        """Prompt-lookup drafting: the most recent earlier occurrence of
        the trailing n-gram proposes the k tokens that followed it; no
        match proposes the last token repeated (any proposal is safe:
        bad drafts are rejected).  Positions past the history read the
        reference's zero padding."""
        S, L = hist.shape[0], self.max_seq_len
        n, k = self.spec_ngram, self.spec_k
        dev = hist.device
        ar = torch.arange(L, device=dev)
        histp = torch.nn.functional.pad(hist[:, :L], (0, n + k))
        tpos = (pos[:, None] - (n - 1) +
                torch.arange(n, device=dev)[None, :]).clamp(0, L - 1)
        tail = hist.gather(1, tpos)                              # [S, n]
        match = torch.ones((S, L), dtype=torch.bool, device=dev)
        for t in range(n):
            match &= histp[:, t:t + L] == tail[:, t:t + 1]
        match &= ar[None, :] <= (pos[:, None] - n)
        best = torch.where(match, ar[None, :] + 1, 0).argmax(dim=1)
        cidx = best[:, None] + n + torch.arange(k, device=dev)[None, :]
        cand = histp.gather(1, cidx)                             # [S, k]
        return torch.where(match.any(dim=1)[:, None], cand,
                           last_tok[:, None].expand(S, k))

    def _draft_propose(self, sampled, hist, last_tok, pos, active,
                       page_table, table0, do_sample, temperature, top_k,
                       top_p, seeds):
        """k draft-model decode steps against the shared page table over
        the draft's pools: the proposals ``[S, k]`` and, when ``sampled``,
        the draft's filtered distributions ``[S, k, V]`` (sampled rows
        draw their proposal from it, keyed by ROLE_DRAFT at the position
        they process).  The first step is a ``[1, 2S]`` tick over the
        tokens at ``pos - 1`` (from ``hist``) and ``pos``: after a tick
        that accepted all k proposals the row at ``pos - 1`` holds the
        last proposal, which no draft step processed (the reference's
        draft attends to a stale row there); otherwise it writes the same
        token again.  A decoding slot has ``pos >= 1``.  The later steps
        are ``[1, S]`` ticks."""
        S, L = self.max_seqs, self.max_seq_len
        page, pp = self.page_size, self.pages_per_seq
        rows = torch.arange(S, device=pos.device)
        cur = last_tok
        toks, probs = [], []
        for i in range(self.spec_k):
            w = 2 if i == 0 else 1
            dpos = pos + i
            qtok = (torch.stack([hist[rows, (pos - 1).clamp_min(0)], cur],
                                dim=1) if i == 0 else cur[:, None])
            qpos = dpos[:, None] + torch.arange(1 - w, 1, device=pos.device)
            qvalid = active[:, None] & (qpos >= 0) & (qpos < L)
            dp = table0.gather(1, (qpos.clamp_min(0) // page).clamp(
                max=pp - 1))
            meta = RaggedMeta(
                kv_lens=torch.where(active, dpos + 1, w).int(),
                page_indices=page_table, cu_q_lens=self._block_cu * w,
                num_seqs=self._block_ns,
                new_kv_dest=torch.where(qvalid, dp * page + qpos % page,
                                        0).reshape(-1))
            dlg = logits_of(self._draft_module(
                qtok.reshape(1, -1),
                positions=torch.where(qvalid, qpos, 0).reshape(1, -1),
                kv_cache=self._draft_cache, ragged_meta=meta,
                logit_rows=rows * w + w - 1)).float()
            nxt = dlg.argmax(dim=-1)
            if sampled:
                flg = filter_logits_batched(dlg, temperature, top_k, top_p)
                probs.append(torch.softmax(flg, dim=-1))
                keys = role_keys(position_keys(self.seed, seeds, dpos),
                                 ROLE_DRAFT)
                drawn = (flg + gumbel_noise(keys, flg.shape[-1])).argmax(
                    dim=-1)
                nxt = torch.where(do_sample, drawn, nxt)
            toks.append(nxt)
            cur = nxt
        return (torch.stack(toks, dim=1),
                torch.stack(probs, dim=1) if sampled else None)

    @torch.inference_mode()
    def _spec_block(self, sampled: bool, hist, last_tok, pos, active,
                    remaining, page_table, eos_ids, do_sample, temperature,
                    top_k, top_p, seeds):
        """K speculative ticks (the reference's ``_spec_block_fn``),
        enqueued with no host read.  Each tick drafts k tokens a slot
        (n-gram lookup over ``hist``, or k draft-model steps), scores all
        k+1 positions with the target as one ragged chunk of k+1 rows a
        slot, and accepts or rolls back on the device
        (:func:`~deepspeed_tpu_torch.inference.sampling.
        speculative_verify`).  Rollback is position rollback: rows
        written for rejected positions lie between the new cursor and
        the old write frontier, a span the next tick writes again before
        any query attends to it.  ``hist``, the token history both
        drafters read, is updated in place; rows that are inactive or
        past ``max_seq_len`` write its trash column, and their K/V the
        trash page.  Returns ``(last_tok,
        pos, active, remaining, toks [K*(k+1), S], mask [K*(k+1), S],
        prop, accd)``: the carry, the tick-major tokens and mask, and the
        draft tokens proposed and accepted."""
        S, L = self.max_seqs, self.max_seq_len
        page, pp = self.page_size, self.pages_per_seq
        k = self.spec_k
        K1 = k + 1
        ngram = self.spec_mode == "ngram"
        table0 = page_table.clamp_min(0).long()
        rows = torch.arange(S, device=pos.device)
        j = torch.arange(K1, device=pos.device)[None, :]
        cu = self._block_cu * K1
        prop = torch.zeros((), dtype=torch.int64, device=pos.device)
        accd = torch.zeros_like(prop)
        toks, masks = [], []
        for _ in range(self.decode_block_size):
            # the cursor token joins the history before drafting
            hist[rows, torch.where(active, pos, L)] = last_tok
            if ngram:
                d_toks = self._ngram_propose(hist, pos, last_tok)
                q_probs = None
            else:
                d_toks, q_probs = self._draft_propose(
                    sampled, hist, last_tok, pos, active, page_table,
                    table0, do_sample, temperature, top_k, top_p, seeds)
            # verify: one ragged chunk of k+1 rows a slot.  kv_lens may
            # pass the page table's span near max_seq_len: those rows are
            # never emitted, and the kernel clamps its key range
            chunk = torch.cat([last_tok[:, None], d_toks], dim=1)
            cpos = pos[:, None] + j
            valid = active[:, None] & (cpos < L)
            dest_page = table0.gather(1, (cpos // page).clamp(max=pp - 1))
            dest = torch.where(valid, dest_page * page + cpos % page, 0)
            meta = RaggedMeta(
                kv_lens=torch.where(active, pos + K1, 1).int(),
                page_indices=page_table, cu_q_lens=cu,
                num_seqs=self._block_ns, new_kv_dest=dest.reshape(-1))
            logits = self._forward(chunk.reshape(1, -1),
                                   torch.where(valid, cpos, 0).reshape(1, -1),
                                   meta).reshape(S, K1, -1)
            keys = (position_keys(self.seed, seeds[:, None].expand(S, K1),
                                  cpos) if sampled else None)
            out_toks, acc = speculative_verify(logits, d_toks, q_probs, keys,
                                               do_sample, temperature,
                                               top_k, top_p)
            # the emission clamp: budget, max_seq_len, first eos
            emit = torch.minimum(acc + 1, remaining)
            emit = torch.minimum(emit, L - 1 - pos)
            eos_hit = out_toks == eos_ids[:, None]
            first_eos = eos_hit.long().argmax(dim=1)
            emit = torch.where(eos_hit.any(dim=1),
                               torch.minimum(emit, first_eos + 1), emit)
            emit = torch.where(active, emit.clamp(1, K1), 0)
            mask_out = active[:, None] & (j < emit[:, None])
            # advance, or roll back, the carry
            new_last = out_toks.gather(1, (emit - 1).clamp_min(0)[:, None])
            ended_eos = (eos_hit & (j < emit[:, None])).any(dim=1)
            hidx = torch.where(mask_out, pos[:, None] + 1 + j, L)
            hist[rows[:, None].expand(S, K1), hidx] = out_toks
            last_tok = torch.where(active, new_last[:, 0], last_tok)
            pos = torch.where(active, pos + emit, pos)
            remaining = remaining - emit
            prop = prop + torch.where(active, k, 0).sum()
            accd = accd + torch.where(active, emit - 1, 0).sum()
            active = (active & ~ended_eos & (remaining > 0) &
                      (pos + 1 < L))
            toks.append(out_toks)
            masks.append(mask_out)
        KK = self.decode_block_size * K1
        return (last_tok, pos, active, remaining,
                torch.stack(toks).transpose(1, 2).reshape(KK, S),
                torch.stack(masks).transpose(1, 2).reshape(KK, S),
                prop, accd)

    def _fold_spec(self, reqs: List[Request], produced: int, prop: int,
                   accd: int) -> None:
        """Count a harvest's speculative blocks and record the draft's KV
        coverage of every slot that goes on: the block wrote every row
        below one under the cursor."""
        st = self.host_stats
        st.spec_proposed += prop
        st.spec_accepted += accd
        st.spec_tokens += produced
        for r in reqs:
            if not r.done:
                self._draft_len[r.slot] = max(r.length - 2, 0)

    # -- the pipelined decode loop (A8a) ----------------------------------

    def _admittable(self) -> bool:
        """Would the unpipelined engine admit the queue head now?  From
        exact global state (allocator and slots), with ``_admit``'s own
        ``_admit_need``, so the pipelined loop reconciles at precisely
        the steps where ``pipeline=False`` admits."""
        if not self.waiting or not any(s is None for s in self.slots):
            return False
        req = self.waiting[0]
        fresh, entries = self._fresh_pages_needed(req, self._admit_need(req))
        return fresh <= self._avail_pages(entries)

    def _avail_pages(self, entries) -> int:
        """Pages an admission can take: the free list plus the prefix
        index's reclaimable pages, less those the admission's own match
        (``entries``) would attach."""
        avail = self.allocator.free_pages
        if self._pfx is not None:
            avail += self._pfx.reclaimable(exclude={e.key for e in entries})
        return avail

    def _block_ready(self, block):
        """The window's waiter: joining a block waits for its device work
        (its event), which bounds the run-ahead; it fetches nothing."""
        with self.host_stats.stage("device"):
            if block[2] is not None:
                block[2].synchronize()
        return block

    def _pipeline_start(self, reqs: List[Request],
                        spec: bool = False) -> None:
        """Enter the pipelined decode loop: the block's carry and the
        samplers' settings go to the device ONCE; later blocks chain the
        device-resident state.  With ``spec`` the speculative block runs
        instead of the plain one, and the projection becomes bounds on
        each slot's advance (1..k+1 a tick, data-dependent): ``plen`` and
        ``rem`` the slow bound (one token a tick, the floor),
        ``plen_hi`` and ``rem_lo`` the fast one (k+1 a tick).  Pages grow
        to the fast bound's write span, and a harvest is forced as soon
        as the fast bound says a finish is possible."""
        st = self.host_stats
        if spec:
            self._draft_catchup(reqs)
        with st.stage("plan"):
            inputs = (self._spec_inputs(reqs) if spec
                      else self._block_inputs(reqs))
            S = self.max_seqs
            # exact host projection of each slot's cache length and token
            # budget: for eos-free sequences the device's active and
            # remaining carry is a function of these, so the host plans
            # ahead without syncing; eos-bearing sequences force a
            # harvest every block (finish_possible)
            plen = np.zeros((S,), np.int64)
            rem = np.zeros((S,), np.int64)
            has_eos = np.zeros((S,), bool)
            for r in reqs:
                plen[r.slot] = r.length
                rem[r.slot] = inputs["remaining"][r.slot]
                has_eos[r.slot] = r.eos_token_id is not None
        dv: Dict[str, Any] = {
            "reqs": list(reqs),
            "sampled": bool(inputs["do_sample"].any()),
            "spec": spec,
            "plen": plen, "rem": rem, "has_eos": has_eos,
            # un-harvested blocks ride the bounded window: past
            # async_depth a submit first joins the oldest block (its
            # event, timed as device wait); joined blocks wait in
            # "ready" for the next harvest
            "window": BoundedAsyncStage(
                waiter=self._block_ready, depth=self.async_depth,
                timers=self._pipe_timers, name="serving_pipeline"),
            "ready": [],
            "block_seq": 0,
        }
        if spec:
            dv["plen_hi"] = plen.copy()
            dv["rem_lo"] = rem.copy()
        self._graphs.ensure(dv["sampled"], spec)     # before the loads
        for name, a in inputs.items():
            self._graphs.load(name, a)
        self._dev = dv

    def _dispatch_block(self, dv: Dict[str, Any]):
        """Enqueue one pipelined block; returns ``(toks, mask, event)``,
        and for a speculative block its ``[proposed, accepted]`` counts
        after them: its tokens, the event recorded after it (None on the
        CPU) and the counts.  One block (a replay when captured), the
        carry copied back into the static inputs, and the outputs copied
        into a slot of the harvest ring before the next replay
        overwrites the graph's."""
        spec = dv["spec"]
        out = self._graphs.run(dv["sampled"], spec)
        self._graphs.chain(out)
        # a block waits in its slot until a harvest: at most
        # harvest_interval of them, so the ring never laps one, at any
        # value the control plane's knobs can set
        ring = self._rings.get(spec)
        if ring is None:
            R = (max(self.harvest_interval, _HARVEST_HI)
                 + max(self.async_depth, _DEPTH_HI))
            rows, S = out[4].shape
            with torch.inference_mode():
                ring = self._rings[spec] = (
                    torch.empty((R, rows, S), dtype=torch.int64,
                                device=self.device),
                    torch.empty((R, rows, S), dtype=torch.bool,
                                device=self.device),
                    torch.empty((R, 2), dtype=torch.int64,
                                device=self.device))
        slot = dv["block_seq"] % ring[0].shape[0]
        with torch.inference_mode():
            block = [ring[0][slot].copy_(out[4]),
                     ring[1][slot].copy_(out[5]), None]
            if spec:
                block.append(ring[2][slot].copy_(torch.stack(out[6:8])))
        if self.device.type == "cuda":
            block[2] = torch.cuda.Event()
            block[2].record()
        return tuple(block)

    def _pipeline_step(self) -> int:
        """One pipelined iteration: plan and dispatch block k+1 while the
        device still runs block k; harvest only when forced."""
        dv = self._dev
        st = self.host_stats
        K = self.decode_block_size
        K1 = self.spec_k + 1
        spec = dv["spec"]
        # a queued request became admittable (put_request arrived, or a
        # reap freed capacity): reconcile so the normal path admits it
        # exactly when the unpipelined engine would
        if self._admittable():
            return self._pipeline_harvest(teardown=True)
        with st.stage("plan"):
            # grow pages to cover the next block: exact for the plain
            # block (the projection is exact for every sequence that
            # reaches here un-harvested); for a speculative one the fast
            # bound's widest write span
            slots_active = [r.slot for r in dv["reqs"]
                            if dv["rem"][r.slot] > 0 and
                            dv["plen"][r.slot] < self.max_seq_len]
            grow_ok = bool(slots_active)
            table_dirty = False
            for s in slots_active:
                self._last_sched[s] = self._sched_seq
                if spec:
                    want = self._spec_grow_want(int(dv["plen_hi"][s]),
                                                int(dv["rem"][s]))
                else:
                    want = int(min(dv["plen"][s] + min(K, dv["rem"][s]),
                                   self.max_seq_len))
                before = self.allocator.owned(s)
                if not self._ensure_pages(s, want):
                    grow_ok = False
                    break
                table_dirty |= self.allocator.owned(s) != before
        if not grow_ok:
            # out of pages (or nothing left to run): reconcile and hand
            # control back to the normal path (stall/evict semantics)
            return self._pipeline_harvest(teardown=True)
        if table_dirty:
            self._graphs.load("page_table", self.page_table)
        # the reference splits its rng here (:2232); sampling in the port
        # is position-keyed (sampling.position_keys), with no generator
        # state for a block to advance
        if trace.enabled:
            trace.event("decode_block", cat="request",
                        uids=[r.uid for r in dv["reqs"]],
                        ticks=self.decode_block_size, pipelined=True,
                        spec=bool(spec))
        with st.stage("verify" if spec else "dispatch"):
            st.dispatches += 1
            st.spec_dispatches += int(spec)
            block = self._dispatch_block(dv)
        dv["window"].submit(dv["block_seq"], block,
                            on_done=dv["ready"].append)
        dv["block_seq"] += 1
        st.ticks += K
        with st.stage("plan"):
            # advance the projection past this block and decide whether
            # the unpipelined engine could have reaped after it
            finish_possible = False
            for s in slots_active:
                if spec:
                    # bounds: a tick advances a slot by 1..k+1 tokens
                    slow = int(max(0, min(K, dv["rem_lo"][s])))
                    fast = int(min(K * K1, max(dv["rem"][s], 0)))
                    dv["plen"][s] = min(dv["plen"][s] + slow,
                                        self.max_seq_len)
                    dv["plen_hi"][s] = min(dv["plen_hi"][s] + fast,
                                           self.max_seq_len)
                    dv["rem"][s] -= slow
                    dv["rem_lo"][s] -= K * K1
                    ends = (dv["rem_lo"][s] <= 0 or
                            dv["plen_hi"][s] >= self.max_seq_len)
                else:
                    prod = int(min(K, dv["rem"][s],
                                   self.max_seq_len - dv["plen"][s]))
                    dv["rem"][s] -= prod
                    dv["plen"][s] += prod
                    ends = (dv["rem"][s] <= 0 or
                            dv["plen"][s] >= self.max_seq_len)
                finish_possible |= bool(dv["has_eos"][s] or ends)
            if self.tiering is not None and finish_possible:
                # a slot may free at the next harvest: start NVMe -> host
                # reads for the spilled sequences the FIFO queue would
                # admit first, under the block the device still runs
                self.tiering.prefetch(
                    [q.uid for q in itertools.islice(
                        self.waiting, self.prefetch_lookahead)
                     if q.spilled is not None])
        pending = dv["window"].in_flight + len(dv["ready"])
        if finish_possible or pending >= self.harvest_interval:
            return self._pipeline_harvest()
        return 0

    def _pipeline_harvest(self, teardown: bool = False) -> int:
        """Fold every pending block back into the host request state (ONE
        blocking fetch), reap finishes, and either keep the
        device-resident carry (nothing changed) or tear it down so that
        the normal path plans again."""
        dv = self._dev
        st = self.host_stats
        spec = dv["spec"]
        S = self.max_seqs
        st.harvests += 1
        # join every block the window still tracks (on_done appends them
        # to "ready" in submit order), then fetch the whole run at once
        dv["window"].drain()
        blocks = dv["ready"]
        with st.stage("harvest"):
            packed = torch.cat([b[0].reshape(-1) for b in blocks] +
                               [b[1].reshape(-1).long() for b in blocks] +
                               [self._graphs.static["last_tok"]] +
                               [b[3] for b in blocks if spec])
        packed = self._fetch(packed)
        with st.stage("harvest"):
            n = len(blocks)
            KS = (self.decode_block_size * (self.spec_k + 1 if spec else 1)
                  * S)
            rows = KS // S
            self._last_tokens = np.array(
                packed[2 * n * KS:2 * n * KS + S], np.int64)
            produced = 0
            for i in range(n):
                toks = packed[i * KS:(i + 1) * KS].reshape(rows, S)
                mask = packed[(n + i) * KS:(n + i + 1) * KS].reshape(
                    rows, S).astype(bool)
                produced += self._fold_block(dv["reqs"], toks, mask)
            for r in dv["reqs"]:
                self._maybe_finish(r)
            if spec:
                counts = packed[2 * n * KS + S:].reshape(n, 2).sum(axis=0)
                self._fold_spec(dv["reqs"], produced, int(counts[0]),
                                int(counts[1]))
            changed = any(r.done for r in dv["reqs"])
            self._reap()
            dv["ready"] = []
            if teardown or changed:
                self._dev = None
            else:
                # the device carry stays authoritative; re-anchor the
                # projection on the now-exact lengths (a speculative
                # run's bounds collapse to them)
                for r in dv["reqs"]:
                    dv["plen"][r.slot] = r.length
                    dv["rem"][r.slot] = r.max_new_tokens - len(r.generated)
                if spec:
                    np.copyto(dv["plen_hi"], dv["plen"])
                    np.copyto(dv["rem_lo"], dv["rem"])
        return produced

    # -- the scheduler tick ---------------------------------------------

    def step(self) -> int:
        """One engine iteration; returns the number of tokens produced
        (0 for a pipelined iteration whose harvest is still deferred: its
        tokens count at the harvest's step).  All-decoding batches take
        the K-tick speculative block when speculation is on and the pool
        backs its write span, else the K-tick decode block, pipelined
        across steps when ``pipeline``; any prefilling sequence falls
        back to the fused SplitFuse tick."""
        self._sched_seq += 1
        if self._controller is not None:
            self._control_steps += 1
            if self._control_steps >= self._control_cfg.interval:
                self._control_steps = 0
                with self.host_stats.stage("plan"):
                    self._controller.tick()
        if self._dev is not None:
            return self._pipeline_step()
        st = self.host_stats
        with st.stage("plan"):
            # park finished handoff prefills BEFORE admission: a handoff
            # request leaves its slot the step after its first token, so
            # it never reaches a decode block, speculation or the pipeline
            self._handoff_sweep()
            self._admit()
            lc_live = [r for r in self.slots
                       if r is not None and not r.done and r.lc]
            live = [r for r in self.slots
                    if r is not None and not r.done and not r.lc]
            # no decode block (nor pipeline, which could orphan them)
            # while a long-context sequence is live, nor while a handoff
            # sequence holds a slot (it is swept after its first token,
            # and must not decode here first)
            decoding_ready = (not lc_live and bool(live) and all(
                r.prefill_done >= r.ctx_len and not r.handoff
                for r in live))
            # speculation first: its block writes a k+1-wide span a tick,
            # so it needs more pages than a plain block; when the pool
            # cannot back it, fall back to the plain decode block (greedy
            # outputs are the same either way).  Decided from exact
            # state, so pipelined and unpipelined runs fall back at the
            # same steps
            spec_block = (decoding_ready and self.spec_mode != "off" and
                          all(self._ensure_pages(
                              r.slot, self._spec_grow_want(
                                  r.length,
                                  r.max_new_tokens - len(r.generated)))
                              for r in live))
            all_decoding = (
                not spec_block and
                decoding_ready and self.decode_block_size > 1 and
                all(self._ensure_pages(
                    r.slot,
                    r.length + min(self.decode_block_size,
                                   r.max_new_tokens - len(r.generated)))
                    for r in live))
        if spec_block or all_decoding:
            if self.pipeline:
                self._pipeline_start(live, spec=spec_block)
                return self._pipeline_step()
            return self._step_block(live, spec=spec_block)
        # long-context sequences tick through the chunked scan
        # (LongContextDriver), eagerly, before the fused tick of the others
        lc_produced = sum(self._lc.tick(r) for r in lc_live)
        with st.stage("plan"):
            plan = self._plan_tick()
        if plan is None:
            self._reap()
            # every live sequence is page-stalled: evict the youngest as
            # a continuation so the rest (and the queue) can progress
            if self._stalled and live:
                if len(live) == 1 and not self.waiting:
                    raise RuntimeError(
                        ("HBM KV tier" if self.tiering is not None
                         else "KV pool") +
                        " too small for the only live sequence "
                        f"(uid={live[0].uid}, needs "
                        f"{pages_for(live[0].length + 1, self.page_size)}"
                        f" pages of {self.allocator.num_pages - 1}) — "
                        "raise num_pages or lower max_new_tokens" +
                        (" (spill tiers hold parked sessions, not the "
                         "live working set)" if self.tiering is not None
                         else ""))
                if self.tiering is not None:
                    # park the coldest stalled sequence in the tiers
                    # (restore is a page upload); evict only when the
                    # tiers are full
                    victim = self._pick_victim(self._stalled)
                    if not self._spill(victim):
                        self._evict(victim)
                else:
                    self._evict(max(self._stalled, key=lambda r: r.uid))
            return lc_produced
        (token_ids, positions, kv_lens, page_indices, cu_q_lens, num_seqs,
         new_kv_dest, sample_rows, samplers) = plan
        (token_ids, positions, kv_lens, page_indices, cu_q_lens, num_seqs,
         new_kv_dest, sample_rows) = [self._upload(a) for a in (
             token_ids[None].astype(np.int64),
             positions[None].astype(np.int64), kv_lens, page_indices,
             cu_q_lens, num_seqs, new_kv_dest.astype(np.int64),
             sample_rows.astype(np.int64))]
        meta = RaggedMeta(kv_lens, page_indices, cu_q_lens, num_seqs,
                          new_kv_dest)
        with st.stage("dispatch"):
            st.dispatches += 1
            sel_logits = self._forward(token_ids, positions, meta,
                                       sample_rows)
        st.ticks += 1
        produced = self._sample(sel_logits, samplers)
        self._reap()
        # a handoff prefill that just sampled its first token parks now,
        # in the same step, so the router's next export pulls it
        self._handoff_sweep()
        return produced + lc_produced

    def _admit(self) -> None:
        for i in range(self.max_seqs):
            if not self.waiting:
                break
            if self.slots[i] is not None:
                continue
            req = self.waiting[0]
            if req.ctx is None:
                req.ctx = req.prompt
            need = self._admit_need(req)
            if self.allocator.pages_for(need) > self.num_pages - 1:
                # defense in depth behind put_request's submit-time check:
                # an unschedulable head would deadlock the FIFO queue.
                # The device bound stays hard with tiering: a working set
                # decodes only resident; the tiers hold parked sessions
                self.waiting.popleft()
                if self.tiering is not None:
                    self.tiering.drop(req.uid)
                    raise ValueError(
                        f"request uid={req.uid} needs "
                        f"{self.allocator.pages_for(need)} KV pages to "
                        f"admit ({need} tokens) but the HBM tier owns "
                        f"{self.num_pages - 1} usable pages — a working "
                        "set can only decode device-resident; raise "
                        "num_pages (spill tiers hold parked sessions, "
                        "not live ones)")
                raise ValueError(
                    f"request uid={req.uid} needs "
                    f"{self.allocator.pages_for(need)} KV pages to admit "
                    f"({need} tokens) but the engine owns "
                    f"{self.num_pages - 1} usable pages — it can never "
                    "be scheduled, even after full eviction")
            fresh, probe = self._fresh_pages_needed(req, need)
            if fresh > self._avail_pages(probe):
                break                      # FIFO: wait for pages to free
            self.waiting.popleft()
            req.slot = i
            if req.spilled is None:
                req.prefill_done = 0       # a spilled request keeps its rows
                req.pc_parent, req.pc_pages, req.pc_cached = ROOT_HASH, \
                    0, 0
            self.slots[i] = req
            self.page_table[i, :] = -1
            self._draft_len[i] = 0         # the draft catches up
            if not self._attach_and_allocate(req, need):
                # a tombstone revival failed mid-attach and the shorter
                # match needs more fresh pages than the pool holds: undo
                # and retry this head next step (rare: the probe assumed
                # the revivals would land)
                self._release_slot(i)
                req.slot = -1
                self.waiting.appendleft(req)
                break
            self.request_latency.on_admit(req.uid)
            if trace.enabled:
                trace.event("request_admit", cat="request", uid=req.uid,
                            slot=i, pages=self.allocator.owned(i),
                            cached_pages=(req.pc_pages
                                          if req.spilled is None else 0),
                            spilled=req.spilled is not None)
            if req.spilled is not None:
                self._restore(req)

    def _attach_and_allocate(self, req: Request, need: int) -> bool:
        """Build slot ``req.slot``'s page run for an admission covering
        ``need`` tokens: prefix-cache attaches (and tombstone revivals)
        first, spill-hold re-attaches for a restoring request, COW of the
        last page on a FULL prefix match, then fresh pages for the rest.
        False when failed revivals shrank the match below what the pool
        can cover (the caller undoes the admission)."""
        i = req.slot
        st = self.host_stats
        attached = 0
        full = False
        if req.spilled is not None:
            shared = [int(p) for p in req.spilled.get("shared_pages", ())]
            if shared:
                self.allocator.attach(i, shared)
                self.page_table[i, :len(shared)] = shared
                attached = len(shared)
        elif self._pfx is not None and not req.lc:
            with st.stage("prefix"):
                entries = self._pfx.match(req.ctx, touch=True)
                pages_att: List[int] = []
                parent = ROOT_HASH
                for e in entries:
                    if e.state == "spilled" and not self._pfx_revive(e):
                        break
                    pages_att.append(int(e.page))
                    parent = e.key
                attached = len(pages_att)
                if attached:
                    self.allocator.attach(i, pages_att)
                    self.page_table[i, :attached] = pages_att
                    full = attached * self.page_size == req.ctx_len
                    # the matched pages are prefilled: schedule only the
                    # suffix.  A FULL match re-prefills its last token
                    # (after the COW below), so that the first token's
                    # logits come from the same fused tick as without
                    # the cache
                    req.prefill_done = attached * self.page_size - (
                        1 if full else 0)
                    req.pc_parent = parent
                    req.pc_pages = attached
                    req.pc_cached = req.prefill_done
                    st.prefix_hits += 1
                    st.prefix_hit_pages += attached
                    st.prefix_hit_tokens += req.prefill_done
                else:
                    st.prefix_misses += 1
        grow_n = self.allocator.pages_for(need) - attached
        want_free = grow_n + (1 if full else 0)
        self._reclaim_for(want_free)
        if want_free > self.allocator.free_pages:
            return False
        if full:
            # the write frontier (position ctx_len - 1) lands in the last
            # matched page: make it private before the re-prefill
            old, new = self.allocator.cow(i, attached - 1)
            if new != old:
                self._cow_copy(old, new)
                self.page_table[i, attached - 1] = new
        if grow_n > 0:
            pages = self.allocator.grow(i, grow_n)
            self.page_table[i, attached:attached + grow_n] = pages
        return True

    def _lc_resident_pages(self) -> int:
        """Device pages a long-context sequence needs at steady state:
        sinks + the recent window + one group not yet parked + the
        growth frontier."""
        t = self._tier_cfg
        return (int(t.sink_pages) + int(t.window_pages)
                + int(t.chunk_pages) + 1)

    def _admit_need(self, req: Request) -> int:
        """Token coverage ``_admit`` reserves for ``req``: one formula
        shared with ``_admittable``, so the pipelined loop reconciles at
        exactly the steps where ``pipeline=False`` admits."""
        ctx_len = req.ctx_len
        rem = max(req.max_new_tokens - len(req.generated), 1)
        if req.lc:
            # partial residency: the resident window, not the context
            # (the parked middle lives in the tiers)
            return min(ctx_len + rem,
                       self._lc_resident_pages() * self.page_size)
        if self.kv_reserve == "worst_case":
            # worst case INCLUDING re-prefilled output for evicted
            # continuations (their ctx carries earlier tokens)
            return ctx_len + req.max_new_tokens - len(req.generated)
        if req.spilled is not None and req.prefill_done >= ctx_len:
            # a spilled decode-phase sequence: its full restored length
            return req.length + min(self.decode_block_size, rem)
        # on-demand: context + the first decode block; growth per block
        return ctx_len + min(self.decode_block_size, rem)

    def _fresh_pages_needed(self, req: Request, need: int):
        """Free pages an admission of ``req`` would take, after
        prefix-cache attaches (resident matched pages cost nothing; a
        FULL match costs one extra page for the COW re-prefill) and
        spill-hold re-attaches.  Returns ``(fresh, matched_entries)``.
        A probe: it leaves the index's LRU order as it is."""
        total = self.allocator.pages_for(need)
        if req.lc:
            # long context skips the prefix cache: parked columns would
            # punch holes in a shared prefix run
            return total, []
        if req.spilled is not None:
            return total - len(req.spilled.get("shared_pages", ())), []
        if self._pfx is None:
            return total, []
        ctx = req.ctx if req.ctx is not None else req.prompt
        entries = self._pfx.match(ctx, touch=False)
        resident = sum(1 for e in entries if e.state == "resident")
        full = bool(entries) and len(entries) * self.page_size == ctx.size
        return total - resident + (1 if full else 0), entries

    def _ensure_pages(self, slot: int, upto_tokens: int) -> bool:
        """Grow ``slot``'s page run to cover ``upto_tokens`` cache
        positions; False when the pool can't (the sequence sits this
        tick out, or gets spilled or evicted)."""
        upto_tokens = min(upto_tokens, self.max_seq_len)
        need = pages_for(upto_tokens, self.page_size)
        have = self.allocator.owned(slot)
        if need <= have:
            return True
        self._reclaim_for(need - have)
        if need - have > self.allocator.free_pages:
            return False
        pages = self.allocator.grow(slot, need - have)
        self.page_table[slot, have:have + len(pages)] = pages
        return True

    def _reclaim_for(self, n_pages: int) -> None:
        """Ask the prefix index to give back cold single-reference pages
        when the free list can't cover ``n_pages``.  A page a live slot
        uses holds the slot's reference on top of the index's, so the
        index never reclaims it."""
        if self._pfx is None:
            return
        short = n_pages - self.allocator.free_pages
        if short > 0:
            self._pfx.reclaim(short)

    def _handoff_sweep(self) -> None:
        """Park every handoff-marked sequence whose prefill AND first token
        are done: spill its KV to the tiers (the decode replica's restore
        is then bit-identical to never having left) or, when the pages
        cannot travel (tiering off, tiers full), fold it to a re-prefill
        continuation, the degraded leg.  Either way it leaves its slot and
        waits in ``_handoff_ready`` for :meth:`export_handoff`."""
        for r in list(self.slots):
            if (r is None or not r.handoff or r.done or r.lc
                    or r.prefill_done < r.ctx_len or not r.generated):
                continue
            if self._spill(r):
                self.waiting.remove(r)     # _spill queued it there
            else:
                # a planned handoff, not pool exhaustion: fold here rather
                # than through _evict (no eviction count, no log)
                self._release_slot(r.slot)
                self._reprefill(r)
                r.slot = -1
                self.handoff_folds += 1
            self._handoff_ready.append(r)
            if trace.enabled:
                trace.event("request_handoff_ready", cat="request",
                            uid=r.uid, spilled=r.spilled is not None)

    def _evict(self, r: Request) -> None:
        """Requeue ``r`` as a CONTINUATION: its pages return to the pool,
        and on re-admission it re-prefills prompt + its own generated
        tokens (greedy continuations are exact)."""
        self._release_slot(r.slot)
        self._reprefill(r)
        r.slot = -1
        self.waiting.append(r)             # back of the queue: the freed
        self.evictions += 1                # pages go to older work first
        if trace.enabled:
            trace.event("request_evict", cat="request", uid=r.uid,
                        ctx_tokens=int(r.ctx.size))
        logger.info(f"ragged engine: evicted uid={r.uid} "
                    f"({r.ctx.size} ctx tokens) — KV pool exhausted; "
                    "requeued as continuation")

    # -- tiered KV spill and restore (device <-> host RAM <-> NVMe) -------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()

    def _gather_pages(self, pages: List[int]) -> np.ndarray:
        """``pages``' bytes of every pool leaf in the tier store's packed
        layout, packed on the device and copied to a (pinned, on
        ``cuda``) host buffer in one transfer.  The copy is queued on the
        compute stream, after every block that wrote the pages, and
        complete on return."""
        t = self.tiering
        n = len(pages)
        idx = self._upload(np.asarray(pages, np.int64))
        with t.timers.stage("spill_alloc"):
            buf = t.empty(n)
        self._sync()                # the copy's time, not earlier work
        with t.timers.stage("d2h"), torch.inference_mode():
            parts = [v.index_select(0, idx) for v in self._page_views]
            if t.page_stride > t.used_bytes:
                parts.append(torch.zeros((n, t.page_stride - t.used_bytes),
                                         dtype=torch.uint8,
                                         device=self.device))
            torch.from_numpy(buf).view(n, t.page_stride).copy_(
                torch.cat(parts, dim=1), non_blocking=True)
            self._sync()
        return buf

    def _scatter_pages(self, pages: List[int], buf: np.ndarray) -> None:
        """Write a packed host buffer back into ``pages`` of every pool
        leaf, in place (``index_copy_``; the pool tensors that captured
        decode blocks replay over are never rebound).  Complete on
        return: ``buf`` may be freed, and the next dispatch reads the
        pages."""
        t = self.tiering
        n = len(pages)
        idx = self._upload(np.asarray(pages, np.int64))
        with t.timers.stage("h2d"), torch.inference_mode():
            src = torch.from_numpy(buf[:n * t.page_stride]).view(
                n, t.page_stride).to(self.device, non_blocking=True)
            for v, off, w in zip(self._page_views, t.offsets, t.widths):
                v.index_copy_(0, idx, src[:, off:off + w])
            self._sync()

    def _live_tokens(self, r: Request) -> int:
        """Cache rows that hold real KV for ``r`` now.  Decode phase: the
        last sampled token's row is written by the NEXT tick (at position
        length-1), so ``length - 1`` rows are live.  Prefill phase: the
        prefilled prefix."""
        if r.prefill_done >= r.ctx_len:
            return r.length - 1
        return r.prefill_done

    def _spill(self, r: Request) -> bool:
        """Park ``r`` in the tiers instead of destroying its KV: its live
        pages go to the tier store and it is requeued as a RESTORABLE
        continuation.  False when the tiers can't take it (the caller
        falls back to ``_evict``'s re-prefill).  A restore gives back the
        exact page bytes, ``prefill_done`` and the pending last token."""
        live = self._live_tokens(r)
        n_live = pages_for(live, self.page_size) if live > 0 else 0
        if n_live == 0 or self.tiering is None:
            return False
        # shared prefix pages (refcount > 1: the index or another
        # sequence holds them too) are the hottest and stay resident: a
        # spill-hold (+1 ref) on the maximal shared PREFIX of the live
        # run, and only the private suffix spills.  No owner writes a
        # shared page (COW comes first), so the rows stay valid
        j = 0
        while j < n_live and self.allocator.refcount(
                int(self.page_table[r.slot, j])) > 1:
            j += 1
        n_priv = n_live - j
        if n_priv > 0 and not self.tiering.can_spill(n_priv):
            return False
        shared = [int(p) for p in self.page_table[r.slot, :j]]
        with self.host_stats.stage("spill"):
            if n_priv > 0:
                buf = self._gather_pages(
                    [int(p) for p in self.page_table[r.slot, j:n_live]])
                try:
                    self.tiering.spill(r.uid, buf, n_priv)
                except RuntimeError:
                    return False           # tiers full: the caller evicts
            r.spilled = {"last_tok": int(self._last_tokens[r.slot]),
                         "n_pages": n_priv, "live_tokens": live,
                         "shared_pages": shared}
            for p in shared:
                self.allocator.incref(p)   # the spill-hold outlives free()
        # the draft's KV is not spilled: catch-up rebuilds it on restore
        self._release_slot(r.slot)
        r.slot = -1
        self.waiting.append(r)             # back of the queue, as evict
        self.spills += 1
        self.request_latency.on_spill(r.uid)
        if trace.enabled:
            trace.event("request_spill", cat="request", uid=r.uid,
                        pages=int(n_live), live_tokens=int(live))
        logger.info(f"ragged engine: spilled uid={r.uid} ({n_live} pages, "
                    f"{live} live tokens) to the KV tiers — restore is a "
                    "page upload, not a re-prefill")
        return True

    def _restore(self, req: Request) -> None:
        """Write ``req``'s spilled pages into its freshly allocated pages
        (``_admit`` assigned the slot).  On unrecoverable corruption
        (:class:`KVRestoreError`: the store quarantined the payload) the
        request re-prefills from the FRONT of the queue, loudly."""
        info = req.spilled
        n = info["n_pages"]                 # private pages in the tiers
        shared = info.get("shared_pages", [])
        jn = len(shared)                    # re-attached by _attach_...
        t0 = time.perf_counter()
        try:
            if n > 0:
                with self.host_stats.stage("restore"):
                    buf = self.tiering.restore(req.uid)
                    self._scatter_pages(
                        [int(p) for p in self.page_table[req.slot,
                                                         jn:jn + n]], buf)
            self._last_tokens[req.slot] = info["last_tok"]
            req.spilled = None
            # release the spill-holds: the slot's attach holds its refs
            for p in shared:
                self.allocator.decref(p)
            self.restores += 1
            self.request_latency.on_restore_stall(
                req.uid, time.perf_counter() - t0)
            if trace.enabled:
                trace.event("request_restore", cat="request", uid=req.uid,
                            pages=int(n), shared_pages=int(jn))
        except KVRestoreError as e:
            self._release_slot(req.slot)
            for p in shared:
                self.allocator.decref(p)
            self._reprefill(req)
            req.spilled = None
            req.slot = -1
            self.waiting.appendleft(req)   # front: it already waited
            self.request_latency.on_restore_stall(
                req.uid, time.perf_counter() - t0)
            self.request_latency.on_error(req.uid)
            if trace.enabled:
                trace.event("request_restore_failed", cat="request",
                            uid=req.uid, page=int(e.page))
            logger.error(
                f"ragged engine: restore of uid={req.uid} failed "
                f"verification (page {e.page}; payload quarantined) — "
                "re-prefilling the session from its own tokens")

    def _pfx_demote(self, e) -> bool:
        """Index LRU hook: move a single-reference prefix page's KV into
        the tiers under the entry's PREFIX-HASH key (not a uid: one
        restore serves every later waiter).  False when the tiers can't
        take it; the index then drops the entry."""
        if self.tiering is None or not self.tiering.can_spill(1):
            return False
        with self.host_stats.stage("spill"):
            buf = self._gather_pages([int(e.page)])
            try:
                self.tiering.spill(PrefixCacheIndex.tier_key(e.key), buf, 1)
            except RuntimeError:
                return False
        if trace.enabled:
            trace.event("prefix_demote", cat="request",
                        key=PrefixCacheIndex.tier_key(e.key))
        return True

    def _pfx_revive(self, e) -> bool:
        """Bring a demoted prefix page back into a fresh pool page so that
        an admission can attach it.  On failure the tombstone is dropped:
        the requester computes that page itself."""
        if self.tiering is None:
            self._pfx._drop(e)
            return False
        if self.allocator.free_pages < 1:
            return False
        page = self.allocator.take_page()
        try:
            with self.host_stats.stage("restore"):
                buf = self.tiering.restore(PrefixCacheIndex.tier_key(e.key))
                self._scatter_pages([page], buf)
        except KVRestoreError:
            self.allocator.decref(page)
            self._pfx._drop(e)             # payload quarantined: forget
            return False
        self._pfx.revive(e, page)
        if trace.enabled:
            trace.event("prefix_revive", cat="request",
                        key=PrefixCacheIndex.tier_key(e.key),
                        page=int(page))
        return True

    def _cow_copy(self, src: int, dst: int) -> None:
        """Copy one page's bytes across every pool leaf on the device, in
        place: the copy half of copy-on-write."""
        with self.host_stats.stage("prefix"), torch.inference_mode():
            for v in self._page_views:
                v[dst].copy_(v[src])
        self.host_stats.prefix_cow_copies += 1
        if trace.enabled:
            trace.event("prefix_cow", cat="request", src=int(src),
                        dst=int(dst))

    def _pick_victim(self, stalled: List[Request]) -> Request:
        """The coldest page-stalled sequence: least recently scheduled
        (tie: the youngest); it has waited longest for pages and will
        wait longest, so parking it frees the most useful device
        memory."""
        return min(stalled,
                   key=lambda r: (self._last_sched[r.slot], -r.uid))

    def _flat_dest(self, slot: int, pos: int) -> int:
        page = self.page_table[slot, pos // self.page_size]
        assert page > 0, "write into unallocated page"
        return int(page) * self.page_size + pos % self.page_size

    def _plan_tick(self):
        """Host-side SplitFuse plan: one decode token per ready sequence
        plus prompt chunks for prefilling sequences, all in ONE batch."""
        self._stalled = []
        decode_rs = []
        for r in self.slots:
            if r is None or r.done or r.lc or r.prefill_done < r.ctx_len:
                continue
            # the tick writes the last generated token at position
            # length-1, so pages must cover `length` tokens
            if self._ensure_pages(r.slot, r.length):
                decode_rs.append(r)
            else:
                self._stalled.append(r)    # out of pages: sit this tick out
        prefill_rs = sorted(
            (r for r in self.slots
             if r is not None and not r.lc
             and r.prefill_done < r.ctx_len),
            key=lambda r: r.uid)
        if not decode_rs and not prefill_rs:
            return None

        token_ids = np.zeros((self.T,), np.int32)
        positions = np.zeros((self.T,), np.int32)
        new_kv_dest = np.full((self.T,), 0, np.int32)   # trash page row 0
        kv_lens = np.zeros((self.max_seqs,), np.int32)
        # metadata rows are indexed by PACKED sequence number j, not slot
        page_indices = np.full((self.max_seqs, self.pages_per_seq), -1,
                               np.int32)
        cu_q_lens = np.zeros((self.max_seqs + 1,), np.int32)
        sample_rows = np.zeros((self.max_seqs,), np.int32)
        samplers: List[Tuple[Request, int, bool]] = []  # (req, seq_j, sample?)

        budget = self.T - len(decode_rs)
        takes: Dict[int, int] = {}
        for r in prefill_rs:
            take = min(budget, r.ctx_len - r.prefill_done)
            if take <= 0:
                continue                   # batch-budget-limited, not stalled
            if not self._ensure_pages(r.slot, r.prefill_done + take):
                # partial growth: cover what the pool allows this tick
                # (cold prefix-index pages count: _ensure_pages reclaims
                # them on demand)
                coverable = (self.allocator.owned(r.slot) +
                             self.allocator.free_pages +
                             (self._pfx.reclaimable()
                              if self._pfx is not None else 0)
                             ) * self.page_size
                take = min(take, coverable - r.prefill_done)
                if take <= 0:
                    self._stalled.append(r)     # page-limited
                    continue
                self._ensure_pages(r.slot, r.prefill_done + take)
            takes[r.uid] = take
            budget -= take

        # pack sequences in slot order (the kernel sees sequences via
        # cu_q_lens row j)
        stalled_uids = {r.uid for r in self._stalled}
        t = 0
        j = 0
        for r in [s for s in self.slots if s is not None]:
            if r.done or r.lc or r.uid in stalled_uids:
                continue
            self._last_sched[r.slot] = self._sched_seq
            if r.prefill_done >= r.ctx_len:                 # decode: 1 tok
                p = min(r.length - 1, self.max_seq_len - 1)
                token_ids[t] = self._last_tokens[r.slot]
                positions[t] = p
                new_kv_dest[t] = self._flat_dest(r.slot, p)
                page_indices[j] = self.page_table[r.slot]
                kv_lens[j] = p + 1
                cu_q_lens[j + 1] = cu_q_lens[j] + 1
                sample_rows[j] = t
                samplers.append((r, j, True))
                t += 1
                j += 1
            else:                                           # prefill chunk
                take = takes.get(r.uid, 0)
                if take <= 0:
                    continue
                lo = r.prefill_done
                token_ids[t:t + take] = r.ctx[lo:lo + take]
                pos = np.arange(lo, lo + take)
                positions[t:t + take] = pos
                pg = self.page_table[r.slot, pos // self.page_size]
                assert (pg > 0).all(), "write into unallocated page"
                new_kv_dest[t:t + take] = (pg * self.page_size +
                                           pos % self.page_size)
                r.prefill_done += take
                if self._pfx is not None:
                    # publish every freshly completed full page to the
                    # index, chained onto the request's registered prefix:
                    # keyed on prefill progress, not on dispatch timing,
                    # so both pipeline modes register the same pages
                    page = self.page_size
                    while (r.pc_pages + 1) * page <= r.prefill_done:
                        k = r.pc_pages
                        r.pc_parent = self._pfx.register(
                            r.pc_parent, r.ctx[k * page:(k + 1) * page],
                            int(self.page_table[r.slot, k]))
                        r.pc_pages += 1
                if trace.enabled:
                    trace.event("prefill_chunk", cat="request", uid=r.uid,
                                take=int(take),
                                prefill_done=int(r.prefill_done),
                                ctx_len=int(r.ctx_len))
                page_indices[j] = self.page_table[r.slot]
                kv_lens[j] = r.prefill_done
                cu_q_lens[j + 1] = cu_q_lens[j] + take
                finishes = r.prefill_done >= r.ctx_len
                if finishes:
                    self.request_latency.on_prefill_done(
                        r.uid, r.ctx_len - r.pc_cached, r.pc_cached)
                sample_rows[j] = t + take - 1
                samplers.append((r, j, finishes))
                t += take
                j += 1
        cu_q_lens[j + 1:] = cu_q_lens[j]
        if j == 0:
            return None
        return (token_ids, positions, kv_lens, page_indices, cu_q_lens,
                np.asarray([j], np.int32), new_kv_dest, sample_rows,
                samplers)

    def _sample(self, sel_logits: torch.Tensor, samplers) -> int:
        """Sample every finishing row of a fused tick in one batched,
        position-keyed call on the device, then one host copy."""
        pairs = [(r, j) for r, j, wants in samplers if wants]
        if not pairs:
            return 0
        rows = self._upload(np.asarray([j for _, j in pairs], np.int64))
        reqs = [r for r, _ in pairs]
        cfg = [self._upload(np.asarray(v, dt)) for v, dt in (
            ([r.do_sample for r in reqs], bool),
            ([r.temperature for r in reqs], np.float32),
            ([r.top_k for r in reqs], np.int64),
            ([r.top_p for r in reqs], np.float32))]
        keys = None
        if any(r.do_sample for r in reqs):
            # (uid, position)-keyed: the draw for token n of request u is
            # the same whatever else is co-batched, and the same as the
            # decode block's draw at that position
            keys = position_keys(
                self.seed,
                self._upload(np.asarray([r.uid for r in reqs], np.int64)),
                self._upload(np.asarray([r.length - 1 for r in reqs],
                                        np.int64)))
        with torch.inference_mode():
            dev_toks = sample_logits_batched(sel_logits[rows], keys, *cfg)
        toks = self._fetch(dev_toks)
        produced = 0
        with self.host_stats.stage("harvest"):
            for r, tok in zip(reqs, toks):
                r.generated.append(int(tok))
                self._last_tokens[r.slot] = int(tok)
                produced += 1
                self.request_latency.on_tokens(r.uid, len(r.generated))
                self._maybe_finish(r)
        return produced

    def _maybe_finish(self, req: Request) -> None:
        if (len(req.generated) >= req.max_new_tokens or
                (req.eos_token_id is not None and req.generated and
                 req.generated[-1] == req.eos_token_id) or
                req.length >= self.max_seq_len):
            req.done = True

    def _reap(self) -> None:
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                # a long-context session's parked groups go with it
                self._drop_lc_parked(r)
                if (self._pfx is not None and not r.lc
                        and self._pfx_cfg.include_generated):
                    # opt-in: publish full pages of generated tokens
                    # before the references drop.  Decode pages come from
                    # the decode block, not the fused prefill, so equal
                    # bits against a cache-off run are not promised for
                    # hits on them (the config knob says so)
                    seq = np.concatenate(
                        [r.ctx, np.asarray(r.generated, np.int32)[
                            r.ctx_len - r.prompt.size:]])
                    written = r.length - 1   # the last token is unwritten
                    page = self.page_size
                    while (r.pc_pages + 1) * page <= written:
                        k = r.pc_pages
                        r.pc_parent = self._pfx.register(
                            r.pc_parent, seq[k * page:(k + 1) * page],
                            int(self.page_table[i, k]))
                        r.pc_pages += 1
                self.finished.append(r)
                self._release_slot(i)
                rec = self.request_latency.on_finish(r.uid)
                if trace.enabled:
                    trace.event("request_reap", cat="request", uid=r.uid,
                                tokens=len(r.generated))
                if rec is not None:
                    self._observe_finished(r.uid, rec)

    def _observe_finished(self, uid: int, rec: Dict[str, Any]) -> None:
        """Feed a finished request's latency record to the SLO set and,
        with tail sampling armed, promote its timeline when it breached,
        errored or won the 1-in-N draw."""
        breaches = (self.slo.record_request(rec)
                    if self.slo is not None else [])
        if (trace.sampling and trace.enabled
                and self._tail_sampler is not None):
            keep, why = self._tail_sampler.should_promote(
                breached=bool(breaches), errored=rec["errors"] > 0)
            if keep:
                if breaches:
                    why = f"{why}:{','.join(breaches)}"
                trace.promote(uid, rec["submit_t"], rec["finish_t"],
                              reason=why)

    # -- convenience ------------------------------------------------------

    def generate_all(self, prompts: List[np.ndarray], **kw
                     ) -> Dict[int, np.ndarray]:
        """Submit everything, run until drained (batch convenience API —
        the serving loop calls ``step`` itself)."""
        uids = set(self.put_request(p, **kw) for p in prompts)
        outs: Dict[int, np.ndarray] = {}
        while self.has_work():
            self.step()
            for uid, toks in self.get_outputs():
                if uid in uids:
                    outs[uid] = toks
                else:
                    # foreign request (submitted outside this call): keep
                    # it claimable by the caller's own get_outputs()
                    self._unclaimed[uid] = toks
        return outs
