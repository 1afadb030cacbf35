"""The single-JSON training config tree.

Copy of ``deepspeed_tpu/config/config.py`` (the port imports nothing of
the JAX package), itself a re-design of ``deepspeed/runtime/config.py:707``
(``DeepSpeedConfig``) and its per-feature pydantic subtrees.  Field names are
kept JSON-compatible with the reference (``train_batch_size``,
``zero_optimization.stage``, ``bf16.enabled``, ...) so existing DeepSpeed
configs parse unchanged; GPU-only knobs are accepted and ignored with a
warning.  The batch triple reconciliation
(``train_batch_size = micro_batch * gradient_accumulation_steps * dp_world``)
mirrors ``_configure_train_batch_size`` in the reference.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Union

from pydantic import Field, model_validator

from deepspeed_tpu_torch.config.config_utils import ConfigModel
from deepspeed_tpu_torch.utils.logging import logger

# ---------------------------------------------------------------------------
# Precision
# ---------------------------------------------------------------------------


class FP16Config(ConfigModel):
    """``fp16`` subtree (reference ``runtime/fp16/loss_scaler.py`` knobs)."""

    enabled: bool = False
    auto_cast: bool = False
    loss_scale: float = 0.0  # 0 => dynamic
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    consecutive_hysteresis: bool = False
    min_loss_scale: float = 1.0


class BF16Config(ConfigModel):
    """``bf16`` subtree. On TPU this is the default precision."""

    enabled: bool = False
    # Keep an fp32 master copy of params in the optimizer (reference
    # BF16_Optimizer semantics). Disable for pure-bf16 experiments.
    master_weights: bool = True


# ---------------------------------------------------------------------------
# ZeRO
# ---------------------------------------------------------------------------


class OffloadDeviceEnum:
    none = "none"
    cpu = "cpu"  # == TPU host memory (pinned_host)
    nvme = "nvme"


class OffloadParamConfig(ConfigModel):
    device: str = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 5
    buffer_size: int = 100_000_000
    max_in_cpu: int = 1_000_000_000
    pin_memory: bool = False


class OffloadOptimizerConfig(ConfigModel):
    """``offload_optimizer`` subtree.  For ``device=nvme`` the pipeline
    knobs shape the swapped moment stream (reference
    ``pipelined_optimizer_swapper``): ``buffer_count`` page-aligned host
    bucket buffers with up to ``buffer_count - 1`` reads in flight ahead
    of the compute; ``pipeline_read``/``pipeline_write`` toggle the
    read-ahead and the deferred write-back stages (both off = the
    strictly serial stream, bit-identical state — the parity-test
    reference).  Defaults ON (documented divergence from the reference's
    opt-in: the serial stream is latency-bound, measured 0.039 GB/s vs
    1.9 GB/s bulk on the same engine)."""
    device: str = OffloadDeviceEnum.none
    nvme_path: Optional[str] = None
    buffer_count: int = 3
    pin_memory: bool = False
    pipeline_read: bool = True
    pipeline_write: bool = True
    fast_init: bool = False
    ratio: float = 1.0


class ZeroConfig(ConfigModel):
    """``zero_optimization`` subtree (reference ``runtime/zero/config.py``).

    On TPU the stages map to sharding layouts on the train state rather than
    hook-driven partitioning:

    - stage 0: replicated params/grads/opt state (plain DP; grads ``psum``).
    - stage 1: optimizer state sharded over the data axis.
    - stage 2: stage 1 + gradients reduce-scattered (``psum_scatter``).
    - stage 3: params also sharded; XLA/GSPMD inserts per-layer all-gathers
      (FSDP). ``stage3_max_live_parameters``-style control is expressed with
      scan-over-layers + remat policies instead of a prefetch tracer.
    """

    stage: int = 0
    contiguous_gradients: bool = True
    reduce_scatter: bool = True
    reduce_bucket_size: int = 500_000_000
    allgather_partitions: bool = True
    allgather_bucket_size: int = 500_000_000
    overlap_comm: Optional[bool] = None
    load_from_fp32_weights: bool = True
    round_robin_gradients: bool = False
    offload_param: Optional[OffloadParamConfig] = None
    offload_optimizer: Optional[OffloadOptimizerConfig] = None
    sub_group_size: int = 1_000_000_000
    stage3_max_live_parameters: int = 1_000_000_000
    stage3_max_reuse_distance: int = 1_000_000_000
    stage3_prefetch_bucket_size: int = 50_000_000
    stage3_param_persistence_threshold: int = 100_000
    stage3_gather_16bit_weights_on_model_save: bool = False
    ignore_unused_parameters: bool = True
    # ZeRO++ knobs
    zero_hpz_partition_size: int = 1
    zero_quantized_weights: bool = False
    zero_quantized_nontrainable_weights: bool = False
    zero_quantized_gradients: bool = False
    # MiCS
    mics_shard_size: int = -1
    mics_hierarchical_params_gather: bool = False

    @model_validator(mode="after")
    def _validate_stage(self):
        if self.stage not in (0, 1, 2, 3):
            raise ValueError(f"zero_optimization.stage must be 0-3, got {self.stage}")
        return self


# ---------------------------------------------------------------------------
# Optimizer / scheduler
# ---------------------------------------------------------------------------


class OptimizerConfig(ConfigModel):
    type: str = "AdamW"
    params: Dict[str, Any] = Field(default_factory=dict)


class SchedulerConfig(ConfigModel):
    type: Optional[str] = None
    params: Dict[str, Any] = Field(default_factory=dict)


# ---------------------------------------------------------------------------
# Parallel topology
# ---------------------------------------------------------------------------


class TensorParallelConfig(ConfigModel):
    """``tensor_parallel`` subtree (reference ``runtime/tensor_parallel/config.py``)."""

    autotp_size: int = 1
    tp_size: int = 1
    tp_grain_size: int = 1

    @model_validator(mode="after")
    def _merge(self):
        if self.autotp_size > 1 and self.tp_size == 1:
            self.tp_size = self.autotp_size
        return self


class PipelineParallelConfig(ConfigModel):
    stages: int = 1
    partition_method: str = "parameters"
    num_microbatches: Optional[int] = None
    activation_checkpoint_interval: int = 0


class SequenceParallelConfig(ConfigModel):
    size: int = 1
    attention_impl: str = "ulysses"  # ulysses | ring


class ExpertParallelConfig(ConfigModel):
    size: int = 1


# ---------------------------------------------------------------------------
# Aux subsystems
# ---------------------------------------------------------------------------


class ActivationCheckpointingConfig(ConfigModel):
    """Maps to ``jax.checkpoint`` policies rather than torch re-forward."""

    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    # TPU-specific: which jax.checkpoint policy to use inside scanned layers.
    policy: str = "nothing_saveable"  # nothing_saveable | dots_saveable | everything_saveable


class FlopsProfilerConfig(ConfigModel):
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


class CommsLoggerConfig(ConfigModel):
    enabled: bool = False
    verbose: bool = False
    prof_all: bool = True
    debug: bool = False
    prof_ops: List[str] = Field(default_factory=list)


class TensorBoardConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJobName"


class WandbConfig(ConfigModel):
    enabled: bool = False
    group: Optional[str] = None
    team: Optional[str] = None
    project: str = "deepspeed_tpu"


class CSVConfig(ConfigModel):
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJobName"


class CometConfig(ConfigModel):
    """``comet`` subtree (reference ``deepspeed/monitor/config.py``
    CometConfig / ``monitor/comet.py:23``): metrics stream to a Comet
    experiment, throttled to every ``samples_log_interval`` samples."""
    enabled: bool = False
    samples_log_interval: int = 100
    project: Optional[str] = None
    workspace: Optional[str] = None
    api_key: Optional[str] = None
    experiment_name: Optional[str] = None
    experiment_key: Optional[str] = None
    mode: Optional[str] = None
    online: Optional[bool] = None


class MonitorConfig(ConfigModel):
    tensorboard: TensorBoardConfig = Field(default_factory=TensorBoardConfig)
    wandb: WandbConfig = Field(default_factory=WandbConfig)
    csv_monitor: CSVConfig = Field(default_factory=CSVConfig)
    comet: CometConfig = Field(default_factory=CometConfig)


class CheckpointConfig(ConfigModel):
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: Dict[str, Any] = Field(default_factory=dict)
    async_save: bool = False


class AioConfig(ConfigModel):
    """``aio`` subtree (reference ``deepspeed/runtime/swap_tensor/
    aio_config.py``): tuning knobs for the native async-IO engine.
    ``python -m deepspeed_tpu.io.bench --sweep`` grids queue_depth x
    block_size x thread_count for read AND write and reports the
    best-write config to paste here (``--tune`` optimizes the combined
    direction).  queue_depth is the per-worker io_uring ring depth (the
    reference's libaio queue_depth; default 128 from the write-parity
    sweep — depth is what hides write submission latency); use_odirect
    bypasses the page cache whenever pointer+offset alignment allows
    (unaligned lengths split into a direct main + buffered tail; enable
    it per mount after a --sweep, the engine falls back cleanly where
    the fs refuses).  single_submit/overlap_events are libaio-era knobs
    accepted for config compatibility."""
    block_size: int = 1 << 20
    queue_depth: int = 128
    thread_count: int = 8
    use_odirect: bool = False
    single_submit: bool = False
    overlap_events: bool = True


class DataTypesConfig(ConfigModel):
    grad_accum_dtype: Optional[str] = None


class CompressionConfig(ConfigModel):
    weight_quantization: Dict[str, Any] = Field(default_factory=dict)
    activation_quantization: Dict[str, Any] = Field(default_factory=dict)
    sparse_pruning: Dict[str, Any] = Field(default_factory=dict)
    row_pruning: Dict[str, Any] = Field(default_factory=dict)
    head_pruning: Dict[str, Any] = Field(default_factory=dict)
    channel_pruning: Dict[str, Any] = Field(default_factory=dict)
    layer_reduction: Dict[str, Any] = Field(default_factory=dict)


class SdcConfig(ConfigModel):
    """``resilience.sdc`` subtree (runtime/swap_tensor.py +
    resilience/sdc.py): silent-data-corruption defense for the NVMe
    offload hot path.  Every bucket/shard the moment stream writes is
    digested (on a side thread, overlapped with the in-flight IO) and
    re-verified on swap-in before the bytes reach the optimizer update;
    a mismatch re-reads with backoff, then quarantines the swap file
    and raises ``SwapCorruptionError`` through the engine's
    emergency-checkpoint path."""

    # verify every swap-in against the write-side digest (off = the
    # pre-defense behavior, byte-identical stream, no digests computed)
    verify_on_read: bool = True
    # digest algorithm: sum64 (numpy-vectorized wraparound word sum,
    # ~4 GB/s/core — default; detects any single flipped bit) |
    # adler32 | crc32 (zlib; slower, stronger burst detection)
    checksum: str = "sum64"
    # blocking re-reads before a mismatching bucket/shard is declared
    # persistently corrupt and quarantined (transient host-buffer/DMA
    # corruption heals here)
    max_reread_retries: int = 2

    @model_validator(mode="after")
    def _validate(self):
        allowed = ("sum64", "adler32", "crc32")
        if self.checksum not in allowed:
            raise ValueError(
                f"resilience.sdc.checksum must be one of {allowed}, "
                f"got {self.checksum!r}")
        if self.max_reread_retries < 0:
            raise ValueError(
                "resilience.sdc.max_reread_retries must be >= 0")
        return self


class CommResilienceConfig(ConfigModel):
    """``resilience.comm`` subtree (deepspeed_tpu/resilience/distributed.py
    + comm/watchdog.py): distributed-health knobs — all off by default,
    and the instrumented comm paths are exact no-ops when off."""

    # eager collectives fail fast with CollectiveTimeout after this many
    # seconds instead of hanging on a dropped/wedged peer (0 = no
    # watchdog).  The engine routes the timeout through the preemption
    # path: emergency checkpoint attempt, then a clean nonzero abort.
    collective_timeout_s: float = 0.0
    # every N steps, cross-check replica-identical scalars (loss, grad
    # norm) across processes; divergence raises GradientAnomalyError
    # (0 = off; enabling costs one small allgather per check)
    desync_interval: int = 0
    # absolute tolerance for the desync comparison (fetched replicas of
    # the same global scalar should be bit-identical; leave 0 unless a
    # transport legitimately perturbs them)
    desync_tolerance: float = 0.0
    # at steps_per_print, aggregate cross-rank collective timings and
    # write the straggler report to the monitor (costs one small
    # allgather per report)
    straggler_report: bool = False

    @model_validator(mode="after")
    def _validate(self):
        if self.collective_timeout_s < 0:
            raise ValueError(
                "resilience.comm.collective_timeout_s must be >= 0")
        if self.desync_interval < 0:
            raise ValueError("resilience.comm.desync_interval must be >= 0")
        if self.desync_tolerance < 0:
            raise ValueError("resilience.comm.desync_tolerance must be >= 0")
        return self


class ResilienceConfig(ConfigModel):
    """``resilience`` subtree (deepspeed_tpu/resilience/): fault-tolerance
    knobs for checkpoint hardening, restart supervision, and training
    guards."""

    # elastic-agent restart budget + backoff between hard-failure restarts
    max_restarts: int = 10
    backoff_base_s: float = 1.0
    backoff_cap_s: float = 60.0
    # checkpoint GC: keep the newest k committed tags (0 = keep all).
    # GC never deletes the only structurally-verified tag.
    keep_last_k: int = 0
    # abort after this many CONSECUTIVE overflow-skipped steps (0 = off;
    # enabling costs one scalar device sync per step)
    max_consecutive_skips: int = 0
    # N > 0: fold the fused inf/nan gradient sweep into bf16/fp32 steps
    # too (fp16 loss-scaling always has it) — non-finite steps are
    # SKIPPED and N consecutive ones raise GradientAnomalyError instead
    # of silently training on NaNs.  Costs one scalar sync per step.
    check_grad_finite: int = 0
    # verify manifest byte-lengths + crc32 checksums at load; corrupt tags
    # quarantine to <tag>.corrupt and load falls back to the newest
    # verified tag
    verify_on_load: bool = True
    # silent-data-corruption defense for the NVMe moment stream
    sdc: SdcConfig = Field(default_factory=SdcConfig)
    # distributed-health knobs (collective watchdog, desync detection,
    # straggler telemetry)
    comm: CommResilienceConfig = Field(default_factory=CommResilienceConfig)

    @model_validator(mode="after")
    def _validate(self):
        if self.max_restarts < 0:
            raise ValueError("resilience.max_restarts must be >= 0")
        if self.keep_last_k < 0:
            raise ValueError("resilience.keep_last_k must be >= 0")
        if self.check_grad_finite < 0:
            raise ValueError("resilience.check_grad_finite must be >= 0")
        return self


class ElasticityConfig(ConfigModel):
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: List[int] = Field(default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    version: float = 0.2
    ignore_non_elastic_batch_info: bool = False
    prefer_larger_batch: bool = True
    model_parallel_size: int = 1
    num_gpus_per_node: int = 1


class CurriculumParams(ConfigModel):
    enabled: bool = False
    curriculum_type: str = "seqlen"
    min_difficulty: int = 8
    max_difficulty: int = 1024
    schedule_type: str = "fixed_linear"
    schedule_config: Dict[str, Any] = Field(default_factory=dict)


class DataEfficiencyConfig(ConfigModel):
    enabled: bool = False
    seed: int = 1234
    data_routing: Dict[str, Any] = Field(default_factory=dict)
    data_sampling: Dict[str, Any] = Field(default_factory=dict)


# ---------------------------------------------------------------------------
# Top-level config
# ---------------------------------------------------------------------------

ADAM_OPTIMIZERS = ["adam", "adamw", "fusedadam"]


class DeepSpeedConfig(ConfigModel):
    """Top-level typed config (reference ``runtime/config.py:707``).

    Parameters
    ----------
    config: dict | str path to JSON
    world_size: data-parallel world size used for batch reconciliation
      (``dp_world_size`` in the reference engine).
    """

    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None

    steps_per_print: int = 10
    gradient_clipping: float = 0.0
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    communication_data_type: Optional[str] = None
    seed: int = 1234
    disable_allgather: bool = False
    dump_state: bool = False
    wall_clock_breakdown: bool = False
    memory_breakdown: bool = False
    dataloader_drop_last: bool = False
    sparse_gradients: bool = False

    fp16: FP16Config = Field(default_factory=FP16Config)
    bf16: BF16Config = Field(default_factory=BF16Config)
    zero_optimization: ZeroConfig = Field(default_factory=ZeroConfig)
    optimizer: Optional[OptimizerConfig] = None
    scheduler: Optional[SchedulerConfig] = None

    tensor_parallel: TensorParallelConfig = Field(default_factory=TensorParallelConfig)
    pipeline: PipelineParallelConfig = Field(default_factory=PipelineParallelConfig)
    sequence_parallel: SequenceParallelConfig = Field(default_factory=SequenceParallelConfig)
    expert_parallel: ExpertParallelConfig = Field(default_factory=ExpertParallelConfig)

    activation_checkpointing: ActivationCheckpointingConfig = Field(
        default_factory=ActivationCheckpointingConfig)
    flops_profiler: FlopsProfilerConfig = Field(default_factory=FlopsProfilerConfig)
    comms_logger: CommsLoggerConfig = Field(default_factory=CommsLoggerConfig)
    monitor_config: MonitorConfig = Field(default_factory=MonitorConfig)
    tensorboard: Optional[TensorBoardConfig] = None  # legacy top-level spelling
    wandb: Optional[WandbConfig] = None
    csv_monitor: Optional[CSVConfig] = None
    checkpoint: CheckpointConfig = Field(default_factory=CheckpointConfig)
    aio: AioConfig = Field(default_factory=AioConfig)
    data_types: DataTypesConfig = Field(default_factory=DataTypesConfig)
    compression_training: CompressionConfig = Field(default_factory=CompressionConfig)
    elasticity: ElasticityConfig = Field(default_factory=ElasticityConfig)
    resilience: ResilienceConfig = Field(default_factory=ResilienceConfig)
    curriculum_learning: CurriculumParams = Field(default_factory=CurriculumParams)
    data_efficiency: DataEfficiencyConfig = Field(default_factory=DataEfficiencyConfig)

    load_universal_checkpoint: bool = False
    zero_allow_untested_optimizer: bool = True
    zero_force_ds_cpu_optimizer: bool = False
    graph_harvesting: bool = False  # GPU-only (cuda graphs); accepted & ignored

    # -- non-pydantic attrs populated by ``parse`` ------------------------------

    def __init__(self, **data: Any):
        super().__init__(**data)
        # legacy top-level monitor keys fold into monitor_config
        if self.tensorboard is not None:
            self.monitor_config.tensorboard = self.tensorboard
        if self.wandb is not None:
            self.monitor_config.wandb = self.wandb
        if self.csv_monitor is not None:
            self.monitor_config.csv_monitor = self.csv_monitor

    # ------------------------------------------------------------------

    @property
    def zero_enabled(self) -> bool:
        return self.zero_optimization.stage > 0

    @property
    def precision_dtype(self) -> str:
        if self.fp16.enabled:
            return "float16"
        if self.bf16.enabled:
            return "bfloat16"
        return "float32"

    def reconcile_batch_size(self, dp_world_size: int) -> None:
        """Solve ``train = micro * gas * dp`` (reference
        ``_configure_train_batch_size``). Any two of the three determine the
        third; one alone assumes the others default; none defaults micro=1,
        gas=1.
        """
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps

        if train is not None and micro is not None and gas is not None:
            pass
        elif train is not None and micro is not None:
            gas = train // (micro * dp_world_size)
        elif train is not None and gas is not None:
            micro = train // (gas * dp_world_size)
        elif micro is not None and gas is not None:
            train = micro * gas * dp_world_size
        elif train is not None:
            gas = 1
            micro = train // dp_world_size
        elif micro is not None:
            gas = 1
            train = micro * dp_world_size
        else:
            micro, gas = 1, 1
            train = dp_world_size

        self.train_batch_size = train
        self.train_micro_batch_size_per_gpu = micro
        self.gradient_accumulation_steps = gas
        self._batch_assertion(dp_world_size)

    def _batch_assertion(self, dp_world_size: int) -> None:
        train = self.train_batch_size
        micro = self.train_micro_batch_size_per_gpu
        gas = self.gradient_accumulation_steps
        assert train > 0, f"train_batch_size: {train} must be > 0"
        assert micro > 0, f"train_micro_batch_size_per_gpu: {micro} must be > 0"
        assert gas > 0, f"gradient_accumulation_steps: {gas} must be > 0"
        assert train == micro * gas * dp_world_size, (
            f"Check batch related parameters: train_batch_size={train} has to equal "
            f"micro_batch_per_gpu({micro}) * gradient_acc_steps({gas}) * "
            f"dp_world_size({dp_world_size})")

    def print_config(self, name: str = "DeepSpeedConfig") -> None:
        logger.info(f"{name}:")
        logger.info(json.dumps(self.model_dump(), indent=2, default=str, sort_keys=True))


def load_config(config: Union[str, Dict[str, Any], DeepSpeedConfig, None],
                dp_world_size: Optional[int] = None) -> DeepSpeedConfig:
    """Parse a config dict / JSON path into a ``DeepSpeedConfig``."""
    if config is None:
        config = {}
    if isinstance(config, DeepSpeedConfig):
        cfg = config
    elif isinstance(config, str):
        if not os.path.exists(config):
            raise FileNotFoundError(f"DeepSpeed config path does not exist: {config}")
        with open(config) as f:
            cfg = DeepSpeedConfig(**json.load(f))
    elif isinstance(config, dict):
        cfg = DeepSpeedConfig(**config)
    else:
        raise TypeError(f"Unsupported config type: {type(config)}")
    if cfg.elasticity.enabled and dp_world_size is not None:
        _apply_elasticity(cfg, dp_world_size)
    if dp_world_size is not None:
        cfg.reconcile_batch_size(dp_world_size)
    warn_unimplemented(cfg)
    return cfg


def _apply_elasticity(cfg: DeepSpeedConfig, dp_world_size: int) -> None:
    """Elastic batch solving (``deepspeed_tpu/elasticity``) is not ported:
    ROADMAP A11."""
    raise NotImplementedError(
        "elasticity.enabled is not ported yet: ROADMAP A11 (elasticity/)")


# Reference knobs accepted for config compatibility whose BEHAVIOR is owned
# by XLA/GSPMD on TPU — tuning them cannot have an effect by design (unlike
# unimplemented features, which warn loudly below).  Grouped by what owns
# them now; surfaced once at info level when a user explicitly sets one.
_XLA_OWNED_KNOBS = {
    "bucketing/overlap (XLA schedules and fuses collectives)": (
        "allgather_bucket_size", "reduce_bucket_size", "overlap_comm",
        "allgather_partitions", "contiguous_gradients",
        "round_robin_gradients", "stage3_prefetch_bucket_size",
        "stage3_max_reuse_distance", "sub_group_size"),
    "host-memory management (the offload tiers page-lock and size "
    "their own staging)": (
        "pin_memory", "buffer_size", "max_in_cpu", "fast_init"),
    "cuda-graph/stream controls": ("graph_harvesting",),
    "sparse embedding-gradient allreduce (XLA AD emits dense grads; "
    "sparse scatter-grads don't map to static-shape SPMD)": (
        "sparse_gradients",),
}


def _inert_knob_notes(cfg: DeepSpeedConfig) -> list:
    set_fields = set(cfg.zero_optimization.model_fields_set) | \
        set(cfg.model_fields_set)
    # host-memory knobs live on the offload sub-models
    for sub in (cfg.zero_optimization.offload_param,
                cfg.zero_optimization.offload_optimizer):
        if sub is not None:
            set_fields |= set(sub.model_fields_set)
    notes = []
    for reason, knobs in _XLA_OWNED_KNOBS.items():
        hit = sorted(set(knobs) & set_fields)
        if hit:
            notes.append(f"{', '.join(hit)} — {reason}")
    return notes


def warn_unimplemented(cfg: DeepSpeedConfig) -> None:
    """Accepted-but-not-yet-implemented knobs fail LOUDLY instead of
    silently doing nothing (reference configs keep loading; the user keeps
    an accurate mental model).  Entries leave this list as the features
    land."""
    notes = []
    if any(getattr(cfg.compression_training, f) for f in
           ("weight_quantization", "activation_quantization",
            "sparse_pruning", "row_pruning", "head_pruning",
            "channel_pruning", "layer_reduction")):
        notes.append("compression_training.* (use deepspeed_tpu."
                     "compression.init_compression explicitly)")
    offl_p = cfg.zero_optimization.offload_param
    if offl_p is not None and offl_p.device == "nvme":
        notes.append("offload_param.device=nvme (device=cpu, page-locked "
                     "host RAM at stage 3, IS supported)")
    # offload_optimizer.device cpu and nvme are implemented
    # (runtime/swap_tensor.py); eligibility beyond the config (an
    # Adam-family optimizer, nvme_path, offload_param beside a tier) is
    # checked by the engine.
    if (cfg.zero_optimization.zero_quantized_weights or
            cfg.zero_optimization.zero_quantized_gradients or
            cfg.zero_optimization.zero_quantized_nontrainable_weights):
        logger.warning(
            "config: zero_quantized_weights/gradients have no automatic "
            "engine wiring on TPU (GSPMD owns the train-step collectives); "
            "the qwZ/qgZ wire primitives are available as "
            "deepspeed_tpu.comm.quantized_all_gather / "
            "quantized_reduce_scatter inside shard_map code")
    if cfg.data_efficiency.enabled:
        logger.warning(
            "config: data_efficiency has no automatic engine wiring on "
            "TPU; use deepspeed_tpu.data_pipeline explicitly "
            "(DeepSpeedDataSampler for curriculum data_sampling, "
            "RandomLayerTokenDrop + RandomLTDScheduler for data_routing)")
    for note in notes:
        logger.warning(f"config: {note} is NOT implemented on TPU yet; "
                       "the setting has no effect")
    inert = _inert_knob_notes(cfg)
    if inert:
        logger.info("config: accepted knobs with no TPU-side effect "
                    "(the compiler owns this behavior): " +
                    "; ".join(inert))
