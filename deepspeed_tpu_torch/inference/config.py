"""Inference config.

Copy of ``deepspeed_tpu/inference/config.py``, which mirrors the reference
``DeepSpeedInferenceConfig`` (``deepspeed/inference/config.py``) with the
same JSON key names, so one JSON config parses to the same values in both
packages.  The ``v2`` subtrees are parsed and validated here already; the
engine that consumes them arrives with the ragged v2 port.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Union

from pydantic import Field, model_validator

from deepspeed_tpu_torch.config.config_utils import ConfigModel
from deepspeed_tpu_torch.telemetry.slo import parse_objective
from deepspeed_tpu_torch.utils.logging import logger

# resilience/sdc.py CHECKSUM_ALGOS of the JAX package
CHECKSUM_ALGOS = ("sum64", "adler32", "crc32")


class InferenceTPConfig(ConfigModel):
    """``tensor_parallel`` subtree (reference ``DeepSpeedTPConfig``)."""

    enabled: bool = True
    tp_size: int = 1


class QuantConfig(ConfigModel):
    """Weight quantization for serving (reference ``QuantizationConfig``):
    int8 group-wise via ops/quantization.py; weights are stored quantized
    and dequantized on the fly in the matmul's prologue."""

    enabled: bool = False
    qtype: str = "int8"          # "int8" | "fp8" | "fp6"
    group_size: int = 128


class SpeculationConfig(ConfigModel):
    """``v2.speculation`` subtree: speculative decoding on the ragged
    engine's decode-block path.

    ``mode``: ``off`` | ``ngram`` (prompt-lookup drafting from the
    sequence's own emitted+prompt tokens — no second model) | ``draft``
    (a small same-vocab family member proposes; the engine needs the
    draft module+params passed programmatically, ``draft_model`` here
    names a model-zoo preset for CLIs/benches to construct).
    ``k``: drafted tokens per speculative tick — the target scores all
    ``k+1`` positions in ONE ragged dispatch, so one weight pass
    amortizes over up to ``k+1`` emitted tokens.
    ``ngram``: the lookup n-gram length for ``mode=ngram``."""

    mode: str = "off"
    k: int = 4
    ngram: int = 3
    draft_model: Optional[str] = None

    @model_validator(mode="after")
    def _check(self):
        if self.mode not in ("off", "ngram", "draft"):
            raise ValueError(
                f"speculation.mode must be off|ngram|draft, got "
                f"{self.mode!r}")
        if self.k < 1:
            raise ValueError("speculation.k must be >= 1")
        if self.ngram < 1:
            raise ValueError("speculation.ngram must be >= 1")
        return self


class KVTieringConfig(ConfigModel):
    """``v2.kv_tiering`` subtree: host-RAM + NVMe spill tiers for the
    paged-KV pool.

    When the pool can't grow a scheduled sequence, the engine spills
    the coldest non-scheduled sequence's pages to host RAM
    (device_get into page-aligned pinned buffers) instead of evicting
    it — restore is a page upload, not a re-prefill.  Host RAM
    overflows into NVMe through the hardened bucketed AIO path
    (qd-128, optional O_DIRECT, fallocate), every spilled page is
    digested (``resilience/sdc.py``) at spill and verified on restore,
    and NVMe->host prefetch for predicted next-scheduled sequences
    runs under the decode block.

    ``host_pages`` / ``nvme_pages``: per-tier budgets in KV pages
    (0 disables that tier).  ``nvme_dir``: spill directory (required
    when ``nvme_pages > 0``).  ``use_odirect``: O_DIRECT spill files
    (off by default — dev containers often spill to tmpfs, where
    O_DIRECT is unsupported).  ``prefetch``: overlap NVMe->host
    restores with decode blocks.  ``verify``: digest-check every
    restored page (re-read heals transient flips; persistent
    corruption quarantines the page and the session re-prefills
    loudly).  Tiering requires ``kv_reserve="on_demand"`` — spill
    tiers ARE the on-demand model's overflow story."""

    enabled: bool = False
    host_pages: int = 256
    nvme_pages: int = 0
    nvme_dir: Optional[str] = None
    use_odirect: bool = False
    prefetch: bool = True
    verify: bool = True
    checksum: str = "sum64"
    max_reread: int = 2
    # -- degraded mode: nvme_fail_threshold hard NVMe failures since
    # the last clean probe (EIO at write submit / cold read, or a
    # quarantine of an NVMe-backed payload) trip the tier offline —
    # spills fall back host-only, parked NVMe payloads fold to
    # re-prefill.  While offline, every probe_every blocked spills run
    # a write/read/verify revival probe; a clean probe re-arms the tier
    nvme_fail_threshold: int = 3
    probe_every: int = 8
    # -- partial residency (long context): a live sequence's page list
    # may split between HBM-resident pages and parked pages.  The first
    # ``sink_pages`` (attention sinks) and the most recent
    # ``window_pages`` stay resident; full middle groups of
    # ``chunk_pages`` demote through the host/NVMe tiers and stream
    # back through a fixed staging buffer during the chunked attention
    # scan.  ``prefetch_lookahead`` bounds how many waiting spilled
    # sessions the pipeline's restore-prefetch scans ahead (the old
    # hardcoded islice(waiting, 8)).  ``long_context`` arms the
    # partial-residency admission path (a request whose full KV exceeds
    # HBM is admitted as long as its resident window fits HBM and its
    # total fits the combined tiers).
    long_context: bool = False
    sink_pages: int = 1
    window_pages: int = 8
    chunk_pages: int = 4
    prefetch_lookahead: int = 8

    @model_validator(mode="after")
    def _check(self):
        if self.host_pages < 0 or self.nvme_pages < 0:
            raise ValueError("kv_tiering tier budgets must be >= 0")
        if self.enabled and self.host_pages == 0 and self.nvme_pages == 0:
            raise ValueError(
                "kv_tiering.enabled needs a nonzero host_pages or "
                "nvme_pages budget")
        if self.nvme_pages > 0 and not self.nvme_dir:
            raise ValueError(
                "kv_tiering.nvme_pages > 0 requires kv_tiering.nvme_dir")
        if self.max_reread < 0:
            raise ValueError("kv_tiering.max_reread must be >= 0")
        if self.nvme_fail_threshold < 1:
            raise ValueError(
                "kv_tiering.nvme_fail_threshold must be >= 1")
        if self.probe_every < 1:
            raise ValueError("kv_tiering.probe_every must be >= 1")
        if self.sink_pages < 1:
            raise ValueError("kv_tiering.sink_pages must be >= 1")
        if self.window_pages < 1:
            raise ValueError("kv_tiering.window_pages must be >= 1")
        if self.chunk_pages < 1:
            raise ValueError("kv_tiering.chunk_pages must be >= 1")
        if self.prefetch_lookahead < 1:
            raise ValueError("kv_tiering.prefetch_lookahead must be >= 1")
        if self.long_context and not self.enabled:
            raise ValueError(
                "kv_tiering.long_context requires kv_tiering.enabled — "
                "partial residency parks middle pages in the spill tiers")
        if self.checksum not in CHECKSUM_ALGOS:
            raise ValueError(
                f"kv_tiering.checksum must be one of {CHECKSUM_ALGOS}, "
                f"got {self.checksum!r}")
        return self


class PrefixCacheConfig(ConfigModel):
    """``v2.prefix_cache`` subtree: cross-request KV sharing over the
    paged pool.

    Token-id chunks are chain-hashed at page granularity; a new
    request's prefill attaches read-only to every fully-matched page
    already resident (refcounted, copy-on-write on first divergent
    write) and computes only the non-cached suffix.  Stored token ids
    are verified before attach, so a hash collision is a miss, never a
    wrong share.

    ``max_index_entries``: LRU bound on index entries (each holds one
    page reference while resident).  ``min_match_pages``: shortest
    prefix worth attaching (shorter matches prefill normally).
    ``include_generated``: also register pages completed during decode
    at request teardown — more reuse for multi-turn traffic, but those
    pages were written by the decode-block program, whose KV bits are
    not guaranteed identical to the fused prefill program's, so
    bit-parity vs cache-off is only contracted while this is off."""

    enabled: bool = False
    max_index_entries: int = 1024
    min_match_pages: int = 1
    include_generated: bool = False

    @model_validator(mode="after")
    def _check(self):
        if self.max_index_entries < 1:
            raise ValueError("prefix_cache.max_index_entries must be >= 1")
        if self.min_match_pages < 1:
            raise ValueError("prefix_cache.min_match_pages must be >= 1")
        return self


class ControlConfig(ConfigModel):
    """``v2.control`` subtree: the closed-loop autotuner.

    ``enabled`` arms the online controller on the engine's host loop
    (``DSTPU_CONTROL=0`` force-disarms regardless).  ``interval`` is
    engine steps per controller tick.  ``settle`` ticks pass between a
    hill-climb probe and its judgment; a relative objective change
    inside ``±hysteresis`` is noise (quiet revert), below it is a
    regression (revert + oscillation-guard bookkeeping: more than
    ``guard_reverts`` regressions on one knob within ``guard_window``
    ticks freezes that knob for ``freeze`` ticks).  ``cooldown`` ticks
    block re-probing a just-reverted knob.  ``objective`` names the
    signal to maximize (prefix ``-`` to minimize).  ``profile`` points
    at a per-host profile file or directory that seeds knob values at
    construction (fingerprint-checked; a foreign host's profile is
    ignored)."""

    enabled: bool = False
    interval: int = 8
    settle: int = 2
    hysteresis: float = 0.05
    cooldown: int = 4
    guard_window: int = 16
    guard_reverts: int = 2
    freeze: int = 32
    smooth: float = 1.0
    objective: str = "throughput"
    profile: Optional[str] = None

    @model_validator(mode="after")
    def _check(self):
        for name in ("interval", "settle", "guard_window",
                     "guard_reverts", "freeze"):
            if getattr(self, name) < 1:
                raise ValueError(f"control.{name} must be >= 1")
        if self.cooldown < 0:
            raise ValueError("control.cooldown must be >= 0")
        if self.hysteresis < 0:
            raise ValueError("control.hysteresis must be >= 0")
        if not 0.0 < self.smooth <= 1.0:
            raise ValueError("control.smooth must be in (0, 1]")
        if not self.objective.lstrip("-"):
            raise ValueError("control.objective must name a signal")
        return self


class InferenceV2Config(ConfigModel):
    """``v2`` subtree: the serving host-path pipeline knobs.

    ``pipeline`` (default ON) runs the ragged engine's decode steady
    state as a software pipeline — metadata pinned on device, host
    planning overlapped with device work, tokens harvested every
    ``harvest_interval`` decode blocks with at most ``async_depth``
    blocks in flight.  ``pipeline=False`` preserves the unpipelined
    host loop exactly (one blocking harvest + fresh metadata upload per
    dispatch) and is the bit-identical parity reference.  The v1 engine
    consumes the same subtree for its deferred-harvest
    ``generate_async`` path."""

    pipeline: bool = True
    async_depth: int = 2
    harvest_interval: int = 4
    # KV pool storage format: "none" keeps full-width pages; "int8" /
    # "fp8" (alias "fp8_e4m3") persist 1-byte pages with per-(row, head)
    # fp32 scales, read dequant-free by the quantized attention variants
    # (ops/ragged_paged_quant.py on TPU, the gathered-pages XLA
    # reference elsewhere) — the pool is never materialized full-width.
    kv_cache_dtype: str = "none"
    speculation: SpeculationConfig = Field(
        default_factory=SpeculationConfig)
    kv_tiering: KVTieringConfig = Field(default_factory=KVTieringConfig)
    prefix_cache: PrefixCacheConfig = Field(
        default_factory=PrefixCacheConfig)
    control: ControlConfig = Field(default_factory=ControlConfig)
    # SLO objectives ("ttft_ms_p99 <= 150"-style strings) fed at reap
    # time; serving_stages()["slo"] reports the rolling budget burn.
    # Empty = no objectives.
    slo: List[str] = Field(default_factory=list)
    # Tail-based trace sampling 1-in-N (0 = off unless the env var
    # DSTPU_TRACE_SAMPLE arms it); breaching/erroring requests always
    # promote when sampling is armed.
    trace_sample: int = 0

    @model_validator(mode="after")
    def _positive(self):
        if self.async_depth < 1:
            raise ValueError("async_depth must be >= 1")
        if self.harvest_interval < 1:
            raise ValueError("harvest_interval must be >= 1")
        if self.kv_cache_dtype not in ("none", "int8", "fp8", "fp8_e4m3"):
            raise ValueError(
                "kv_cache_dtype must be none|int8|fp8|fp8_e4m3, got "
                f"{self.kv_cache_dtype!r}")
        if self.trace_sample < 0:
            raise ValueError("trace_sample must be >= 0")
        for spec in self.slo:
            parse_objective(spec)      # raises ValueError on a bad spec
        return self


class DeepSpeedInferenceConfig(ConfigModel):
    """Top-level inference config (``deepspeed.init_inference`` arg)."""

    dtype: str = "bfloat16"                 # bfloat16 | float16 | float32
    tensor_parallel: InferenceTPConfig = Field(
        default_factory=InferenceTPConfig, alias="tp")
    max_out_tokens: int = 1024              # KV-cache length bound
    min_out_tokens: int = 1
    replace_with_kernel_inject: bool = False
    enable_cuda_graph: bool = False
    max_batch_size: int = 0                 # 0 = unbounded (shape-compiled)
    quant: QuantConfig = Field(default_factory=QuantConfig)
    v2: InferenceV2Config = Field(default_factory=InferenceV2Config)
    # reference knobs accepted for config compat, consumed elsewhere
    replace_method: str = "auto"
    checkpoint: Optional[str] = None

    @model_validator(mode="after")
    def _warn_gpu_only(self):
        if self.replace_with_kernel_inject:
            logger.warning(
                "replace_with_kernel_inject=True is a no-op: the port's "
                "models already call its hand-written kernels")
        if self.enable_cuda_graph:
            logger.warning(
                "enable_cuda_graph is not implemented yet: the decode "
                "loop runs eagerly")
        return self


def load_inference_config(
        config: Union[None, Dict[str, Any], DeepSpeedInferenceConfig],
        **kwargs) -> DeepSpeedInferenceConfig:
    if isinstance(config, DeepSpeedInferenceConfig):
        return config
    merged = dict(config or {})
    merged.update(kwargs)
    return DeepSpeedInferenceConfig(**merged)
