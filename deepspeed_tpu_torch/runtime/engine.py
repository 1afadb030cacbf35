"""The training engine: ZeRO stages 0-3 over data-parallel ranks.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``initialize`` and
``DeepSpeedEngine``, the reference's ``deepspeed.initialize`` and
``runtime/engine.py:184``).  Where the JAX engine compiles one
``train_step(state, batch, lr)``, this one runs the same step eagerly:

1. for each of the ``gas`` micro-batches: forward on the compute-dtype
   working copy of the weights, backward of ``loss * loss_scale``, and the
   micro-batch's gradient added into an fp32 accumulator;
2. the gradient scale ``1/(loss_scale * gas * ranks)``, the global norm,
   the clipping factor and (fp16) the overflow flag, all on the device;
3. one optimizer launch that updates the fp32 master weights, the moments
   and the working copy (``ops/fused_adam.py``), skipping everything on
   overflow; then the loss-scale update.

Memory layout: the fp32 master weights, the fp32 gradient accumulator and
the moments are flat buffers; the model's parameters are views of a flat
working copy in the compute dtype (bf16 or fp16; the master itself in
fp32).  At stage 0 every rank holds all of it and the gradient is
all-reduced; at stages 1-3 ``runtime/zero.py`` partitions it over the
``data`` x ``data_sub`` ranks, and the optimizer is one launch over each
rank's shard.  ``train_batch`` takes the global batch; each rank trains
on its rows, and the returned loss is the global mean on every rank.

The ranks are those of the process group initialised before
``initialize`` (``deepspeed_tpu_torch.comm.init_distributed``, or a
``torchrun`` launch): NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU.
Without one the engine runs as one process.

The forward runs on compute-dtype copies of every floating parameter, the
RMSNorm weights included (``prec.cast_tree`` in the JAX step), not under
``torch.autocast``.  Nothing in a step reads a device value on the host
(only the throughput timer synchronises around it, as the JAX one does,
and the optional resilience checks); ``train_batch`` returns the loss as
a device tensor.

ZeRO-Offload and ZeRO-Infinity (``zero_optimization.offload_optimizer``
with ``device`` "cpu" or "nvme", and ``offload_param.device=cpu`` at stage
3): the fp32 master and the moments of this rank's shard live in a tier
(``runtime/swap_tensor.py``: page-locked host RAM, or moments on NVMe),
the working copy and the fp32 gradient on the card; the step streams the
shard through the card bucket by bucket, the optimizer's own update once
a bucket (one kernel #4 launch when it is fused), and gives the resident
step's bits.  The master is updated in place a bucket at a time, so an
emergency checkpoint is never taken mid-step: a preemption signal is
answered once the step is done, and a step that fails mid-stream saves
only a postmortem copy that ``latest`` never names.  With
``offload_param`` the working-copy shard lives in host RAM too and each
unit is copied in before its gather.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: 1-bit optimizers, curriculum learning and TP/PP/SP/EP
(A11), the imperative ``forward``/``backward``/``step`` triple (A4),
pure-bf16 training without master weights (A4), async checkpoint save
(A5).
"""
from __future__ import annotations

import dataclasses
import functools
import math
import weakref
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch import comm
from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.config.config import DeepSpeedConfig, load_config
from deepspeed_tpu_torch.ops.fused_adam import step_scalars
from deepspeed_tpu_torch.parallel.topology import MeshTopology
from deepspeed_tpu_torch.resilience.distributed import DesyncDetector
from deepspeed_tpu_torch.resilience.guards import (SkippedStepGuard,
                                                   SwapCorruptionError)
from deepspeed_tpu_torch.runtime import precision as prec
from deepspeed_tpu_torch.runtime import swap_tensor
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      get_schedule_fn)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.train_state import TrainState
from deepspeed_tpu_torch.runtime.zero import (EXTENT, UnitGatherHooks,
                                              ZeroBuffers,
                                              ZeroPartitionPlan,
                                              gather_units)
from deepspeed_tpu_torch.utils.logging import log_dist, logger
from deepspeed_tpu_torch.utils.timer import (STEP_GLOBAL_TIMER,
                                             SynchronizedWallClockTimer,
                                             ThroughputTimer)

LossFn = Callable[[Dict[str, torch.Tensor], Any, torch.Generator],
                  torch.Tensor]


def initialize(args=None,
               model: Any = None,
               optimizer: Optional[str] = None,
               model_parameters: Any = None,
               training_data: Any = None,
               lr_scheduler: Any = None,
               topology: Optional[MeshTopology] = None,
               config: Any = None,
               config_params: Any = None,
               device: DeviceLike = None,
               generator: Optional[torch.Generator] = None):
    """Create a training engine (reference ``deepspeed.initialize``,
    ``deepspeed/__init__.py:69``; same return arity).

    ``model`` is either
    - an ``nn.Module`` whose ``forward(batch)`` returns the scalar loss,
      with weights from ``model_parameters`` (a ``state_dict``), or, for a
      module built on the meta device with no ``model_parameters``, drawn
      on the device by its ``init_module_weights(module, generator)``,
      called on each module in order, one module's weights at a time;
      or
    - a loss function ``loss_fn(params, batch, generator) -> scalar`` with
      the params (a dict of tensors) in ``model_parameters`` (stages 0-2).

    The data-parallel ranks are those of the initialised process group
    (``comm.init_distributed``), laid out by ``topology`` (by default
    ``comm.get_topology()``); without a process group, one process.
    ``device``: ``cuda`` by default (``cuda:LOCAL_RANK`` under a process
    group; raises without a GPU); the CPU only when asked for.
    ``generator`` seeds weight init and is carried in the train state; by
    default one on the device seeded with ``config.seed``.  Returns
    ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    """
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    if topology is None:
        topology = comm.get_topology()
    else:
        comm.set_topology(topology)
    ds_config = load_config(config if config is not None else config_params,
                            dp_world_size=topology.data_parallel_size)
    # hpZ (ZeRO++): lay the data axis out as data x data_sub so the
    # stage-3 working copy can be partitioned over data_sub
    hpz = ds_config.zero_optimization.zero_hpz_partition_size
    if (hpz > 1 and ds_config.zero_optimization.stage >= 3 and
            topology.hpz_partition_size != hpz):
        topology = comm.initialize_mesh(dp=topology.data_parallel_size,
                                        hpz=hpz)
        log_dist(f"hpZ: split data axis -> {topology.describe()}",
                 ranks=[0])
    engine = DeepSpeedEngine(model=model, model_parameters=model_parameters,
                             config=ds_config, topology=topology,
                             optimizer_name=optimizer,
                             lr_scheduler=lr_scheduler,
                             training_data=training_data, device=device,
                             generator=generator)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def _unported(config: DeepSpeedConfig) -> Dict[str, str]:
    """Config settings of paths not ported yet -> their ROADMAP item."""
    out = {}
    if config.curriculum_learning.enabled:
        out["curriculum_learning.enabled"] = "A11"
    for name, size in (("tensor_parallel.tp_size",
                        config.tensor_parallel.tp_size),
                       ("pipeline.stages", config.pipeline.stages),
                       ("sequence_parallel.size",
                        config.sequence_parallel.size),
                       ("expert_parallel.size", config.expert_parallel.size)):
        if size > 1:
            out[f"{name}={size}"] = "A11"
    if config.bf16.enabled and not config.bf16.master_weights and \
            not config.fp16.enabled:
        out["bf16.master_weights=false"] = "A4"
    return out


SWAP_STAGES = ("swap_in_wait", "bucket_update", "swap_out_wait",
               "swap_verify")


def _offload_settings(config: DeepSpeedConfig, optimizer_name: str,
                      optimizer) -> Tuple[Optional[str], bool]:
    """``(tier, offload_param)`` of a config, as the JAX engine picks them
    (``runtime/engine.py:266-440``): ``offload_optimizer.device`` "cpu"
    or "nvme" (an Adam-family optimizer; "nvme" needs ``nvme_path``), and
    ``offload_param.device=cpu`` at stage 3 (below it ignored with a
    warning, as there)."""
    z = config.zero_optimization
    off_o, off_p = z.offload_optimizer, z.offload_param
    tier = off_o.device if off_o is not None and \
        off_o.device in ("cpu", "nvme") else None
    if tier is not None and not hasattr(optimizer, "bias_corrections"):
        raise ValueError(
            f"offload_optimizer.device={tier} streams two Adam moments a "
            f"parameter: it needs an Adam-family optimizer, not "
            f"{optimizer_name!r}")
    if tier == "nvme" and not off_o.nvme_path:
        raise ValueError("offload_optimizer.device=nvme requires "
                         "offload_optimizer.nvme_path")
    param = off_p is not None and off_p.device == "cpu"
    if param and z.stage < 3:
        logger.warning(f"offload_param.device=cpu requires zero stage 3 "
                       f"(params are not partitioned at stage {z.stage}); "
                       "IGNORED")
        param = False
    if param and tier is None:
        raise ValueError(
            "offload_param.device=cpu streams the working copy through the "
            "optimizer's tier: set offload_optimizer.device too")
    if param and z.zero_hpz_partition_size > 1:
        raise NotImplementedError(
            "offload_param with zero_hpz_partition_size > 1 is not ported "
            "yet: ROADMAP A11")
    return tier, param


def _sumsq(g: torch.Tensor) -> torch.Tensor:
    """``g . g``.  cuBLAS's dot takes at most 2**31 - 1 elements, so a
    longer shard sums the dots of its 2**30-element pieces."""
    if g.numel() < 2**31:
        return torch.dot(g, g)
    return torch.stack([torch.dot(c, c) for c in g.split(1 << 30)]).sum()


def _own_params(module: nn.Module, device) -> None:
    """Give ``module``'s own parameters fresh fp32 storage on ``device``."""
    for attr, p in list(module._parameters.items()):
        if p is not None:
            setattr(module, attr, nn.Parameter(torch.empty(
                p.shape, dtype=torch.float32, device=device)))


def _remove_hooks(handles) -> None:
    for handle in handles:
        handle.remove()


_REMAT_POLICIES = {"nothing_saveable": ("full", True),
                   "dots_saveable": ("dots_saveable", True),
                   "everything_saveable": ("none", False)}


def _apply_activation_checkpointing_config(model: nn.Module,
                                           config: DeepSpeedConfig) -> None:
    """Honour an explicit ``activation_checkpointing`` policy (or
    ``partition_activations``) as the JAX engine does: the model's
    ``remat`` and ``remat_policy`` follow it.  Every submodule holding the
    model's config dataclass gets the replaced one."""
    if "activation_checkpointing" not in config.model_fields_set:
        return
    acfg = config.activation_checkpointing
    if ("policy" not in acfg.model_fields_set and
            not acfg.partition_activations):
        return
    mc = getattr(model, "config", None)
    if not (dataclasses.is_dataclass(mc) and
            all(hasattr(mc, n) for n in ("remat", "remat_policy"))):
        logger.warning("activation_checkpointing set but the model carries "
                       "no remat-capable dataclass config; knob has no "
                       "effect")
        return
    if acfg.policy not in _REMAT_POLICIES:
        raise ValueError(
            f"activation_checkpointing.policy={acfg.policy!r}: expected one "
            f"of {sorted(_REMAT_POLICIES)}")
    remat_policy, remat = _REMAT_POLICIES[acfg.policy]
    if (mc.remat, mc.remat_policy) == (remat, remat_policy):
        return
    new = dataclasses.replace(mc, remat=remat, remat_policy=remat_policy)
    for mod in model.modules():
        if getattr(mod, "config", None) is mc:
            mod.config = new
    log_dist(f"activation_checkpointing: policy={acfg.policy} -> "
             f"remat={remat} remat_policy={remat_policy}", ranks=[0])


class OptimizerHandle:
    """The ``optimizer`` element of the ``initialize`` tuple: a view of
    the engine's optimizer (its state lives in the engine)."""

    def __init__(self, engine: "DeepSpeedEngine"):
        self._engine = engine

    @property
    def param_groups(self):
        return [{"lr": self._engine.get_lr()[0]}]

    def state_dict(self):
        """The optimizer state this rank holds: flat moments over its
        shard (all of them at stage 0) and the step count."""
        return dict(self._engine.state.opt_state)

    def __repr__(self):  # pragma: no cover
        return f"OptimizerHandle({self._engine.optimizer_name})"


class DeepSpeedEngine:
    """Owns the config, the flat train state and the step."""

    def __init__(self, model, model_parameters, config: DeepSpeedConfig,
                 topology: Optional[MeshTopology] = None,
                 optimizer_name: Optional[str] = None, lr_scheduler=None,
                 training_data=None, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        unported = _unported(config)
        if unported:
            raise NotImplementedError(
                "not ported yet: " + ", ".join(
                    f"{k} (ROADMAP {v})" for k, v in unported.items()))
        self.config = config
        self.device = resolve_device(device)
        self.topology = topology if topology is not None else \
            comm.get_topology()
        extent = self.topology.group(EXTENT)
        self.dp_world_size, self.dp_rank = extent.size, extent.rank
        backend = comm.get_backend_name()
        if backend is not None and \
                (backend == "nccl") != (self.device.type == "cuda"):
            raise ValueError(f"the {backend} process group cannot carry "
                             f"{self.device.type} tensors: NCCL is for cuda, "
                             "gloo for the CPU")
        zcfg = config.zero_optimization
        self.zero_stage = zcfg.stage
        self.global_steps = 0
        self.global_samples = 0
        self.micro_steps = 0
        self.compute_dtype = prec.compute_dtype_from_config(config)
        self.dynamic_loss_scale = (config.fp16.enabled and
                                   config.fp16.loss_scale == 0)
        if generator is None:
            generator = torch.Generator(device=self.device).manual_seed(
                config.seed)

        # -- optimizer and schedule (the names raise before any memory) --
        opt_cfg = config.optimizer
        self.optimizer_name = (optimizer_name or
                               (opt_cfg.type if opt_cfg else "adamw"))
        if not isinstance(self.optimizer_name, str):
            raise TypeError("optimizer must be a config name; the port "
                            "builds its own (runtime/optimizers.py)")
        self.opt, base_lr = build_optimizer(
            self.optimizer_name, dict(opt_cfg.params) if opt_cfg else {})
        if lr_scheduler is None:
            sched = config.scheduler
            lr_scheduler = LRScheduler(get_schedule_fn(
                sched.type if sched else None,
                dict(sched.params) if sched else {}, base_lr=base_lr))
        self.lr_scheduler = lr_scheduler

        # -- model -> named leaves over flat buffers ----------------------
        self.module: Optional[nn.Module] = None
        if isinstance(model, nn.Module):
            _apply_activation_checkpointing_config(model, config)
            self.module = model
            named = list(model.named_parameters())
            self.loss_fn = None
        elif callable(model):
            if model_parameters is None:
                raise ValueError("the loss-fn path needs model_parameters")
            if self.zero_stage >= 3:
                raise ValueError("ZeRO stage 3 gathers each unit in its "
                                 "module's hooks: pass an nn.Module")
            named = list(model_parameters.items())
            self.loss_fn: Optional[LossFn] = model
        else:
            raise TypeError(f"Unsupported model type {type(model)}")
        for name, p in named:
            if not p.is_floating_point():
                raise TypeError(f"parameter {name} is {p.dtype}: the engine "
                                "trains floating parameters only")
        self._names = [n for n, _ in named]
        self._shapes = [tuple(p.shape) for _, p in named]
        sizes = [math.prod(s) for s in self._shapes]
        self._offsets = np.concatenate([[0], np.cumsum(sizes)]).tolist()
        n_total = int(self._offsets[-1])
        self.num_parameters = n_total

        # each leaf's starting values, whole, in leaf order: the given
        # state dict, the module's own tensors, or (a module on the meta
        # device) drawn one module at a time by its init_module_weights
        if self.module is None:
            sources = [p for _, p in named]
        elif model_parameters is not None:
            sources = self._given_weights(model_parameters)
        elif any(p.is_meta for _, p in named):
            if not hasattr(model, "init_module_weights"):
                raise ValueError(
                    "a module built on the meta device needs "
                    "model_parameters or an init_module_weights(module, "
                    "generator)")
            sources = self._drawn_weights(generator)
        else:
            for name, p in named:
                if p.numel() and not p.untyped_storage().nbytes():
                    raise ValueError(
                        f"parameter {name} has no storage: its module was "
                        "trained at ZeRO stage 3 by another engine; pass "
                        "that engine's module_state_dict() as "
                        "model_parameters")
            sources = [p.detach() for _, p in named]

        self.plan: Optional[ZeroPartitionPlan] = None
        self.zero: Optional[ZeroBuffers] = None
        self.offload_tier, self.offload_param = _offload_settings(
            config, self.optimizer_name, self.opt)
        self.swapper = None
        self._pinned: list = []             # the host working shard's
        self._moment_loader = None          # a load's MomentFiles
        self._offloaded: Optional[list] = None   # offload_states' buffers
        if self.zero_stage == 0:
            if self.offload_tier is None:
                flat_p = torch.empty(n_total, dtype=torch.float32,
                                     device=self.device)
                with torch.no_grad():
                    for view, src in zip(self._views(flat_p).values(),
                                         sources):
                        view.copy_(src)
                if self.dp_world_size > 1:
                    # every rank starts from rank 0's weights
                    comm.broadcast(flat_p, src=0, group=EXTENT,
                                   log_name="init_broadcast")
                # working copy in the compute dtype (the master itself in
                # fp32)
                self._flat_w = (flat_p if self.compute_dtype == torch.float32
                                else flat_p.to(self.compute_dtype))
            else:
                self.swapper = self._make_swapper(n_total, [
                    (self._offsets[idx[0]], self._offsets[idx[-1] + 1])
                    for _, idx in gather_units(self._names)])
                flat_p = self.swapper.p
                # the master in host RAM, the working copy on the card,
                # each filled a leaf at a time
                self._flat_w = torch.zeros(n_total, dtype=self.compute_dtype,
                                           device=self.device)
                with torch.no_grad():
                    for vp, vw, src in zip(
                            self._views(flat_p).values(),
                            self._views(self._flat_w).values(), sources):
                        if self.dp_world_size > 1:
                            src = src.to(device=self.device,
                                         dtype=torch.float32, copy=True)
                            comm.broadcast(src, src=0, group=EXTENT,
                                           log_name="init_broadcast")
                        vp.copy_(src)
                        vw.copy_(src.to(torch.float32))
            params = flat_p
            self._flat_gw = torch.zeros(n_total, dtype=self.compute_dtype,
                                        device=self.device)
            self._flat_g = torch.zeros(n_total, dtype=torch.float32,
                                       device=self.device)
            self._grad = self._flat_g
            leaves = list(self._views(self._flat_w).values())
            grads = list(self._views(self._flat_gw).values())
        else:
            self.plan = ZeroPartitionPlan(
                self._names, self._shapes, self.zero_stage,
                world=self.dp_world_size, rank=self.dp_rank,
                hpz=zcfg.zero_hpz_partition_size,
                persistence_threshold=zcfg.stage3_param_persistence_threshold)
            log_dist(self.plan.describe(), ranks=[0])
            master = working = None
            if self.offload_tier is not None:
                self.swapper = self._make_swapper(
                    self.plan.n_shard,
                    [(u.shard_offset, u.shard_offset + u.chunk)
                     for u in self.plan.units])
                master = self.swapper.p
            if self.offload_param:
                working = (master if self.compute_dtype == torch.float32
                           else swap_tensor.host_buffer(
                               self.plan.n_shard, self.compute_dtype,
                               self.device, owners=self._pinned))
            with torch.no_grad():
                self.zero = ZeroBuffers(self.plan, sources,
                                        self.compute_dtype, self.device,
                                        master=master, working=working)
            params = self.zero.p
            self._grad = self.zero.g
            leaves = [v.view(s) for v, s in zip(self.zero.working_views(),
                                                self._shapes)]
            grads = ([v.view(s) for v, s in zip(self.zero.grad_views(),
                                                self._shapes)]
                     if self.zero_stage == 1 else None)
        self._leaves = dict(zip(self._names, leaves))
        if self.module is not None:
            self._bind(self._leaves)
            self._leaves = dict(self.module.named_parameters())
        else:
            for t in self._leaves.values():
                t.requires_grad_(True)
        if grads is not None:
            for leaf, g in zip(self._leaves.values(), grads):
                leaf.grad = g          # autograd accumulates here in place
        if self.zero is not None:
            self.zero.leaves = list(self._leaves.values())
            if self.zero_stage >= 2:
                # each unit's gradient is reduced once its backward is
                # done.  The hook holds the buffers weakly: a strong
                # reference would close a cycle through the tensor's
                # hooks that the garbage collector cannot see, and keep a
                # deleted engine's memory
                on_grad = weakref.WeakMethod(self.zero.on_grad)
                for i, leaf in enumerate(self.zero.leaves):
                    leaf.register_post_accumulate_grad_hook(
                        lambda _, i=i: on_grad()(i))
            if self.zero_stage >= 3:
                hooks = UnitGatherHooks(self.zero, self.module, self._names)
                weakref.finalize(self, _remove_hooks, hooks.handles)
        del sources

        self._sc = step_scalars(self.device)
        self._last_gscale: Optional[torch.Tensor] = None
        if self.swapper is None:
            opt_state = self.opt.init(params)
        else:
            # the moments live in the tier; the count on the card
            opt_state = {"count": torch.zeros((), dtype=torch.int32,
                                              device=self.device)}
            if self.swapper.moments_on_host:
                opt_state.update(m=self.swapper.m, v=self.swapper.v)
            weakref.finalize(self, self.swapper.close)
        self.state = TrainState(
            step=0, params=params, opt_state=opt_state,
            scale=prec.init_loss_scale(config.fp16, self.device),
            generator=generator,
            skipped_steps=torch.zeros((), dtype=torch.int32,
                                      device=self.device))

        # -- data ---------------------------------------------------------
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = RepeatingLoader(DeepSpeedDataLoader(
                training_data, batch_size=config.train_batch_size,
                seed=config.seed, drop_last=config.dataloader_drop_last,
                world_size=self.dp_world_size, rank=self.dp_rank,
                micro_batch_size=config.train_micro_batch_size_per_gpu))
        self._data_iter = None
        self._last_metrics = None

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size,
            steps_per_output=config.steps_per_print)
        comm.configure(config.comms_logger)

        # -- resilience guards (resilience/guards.py, distributed.py) -----
        self._skip_guard = None
        bounds = [b for b in (config.resilience.max_consecutive_skips,
                              config.resilience.check_grad_finite) if b > 0]
        if bounds:
            self._skip_guard = SkippedStepGuard(min(bounds))
        rc = config.resilience.comm
        if rc.collective_timeout_s > 0:
            comm.watchdog.configure(rc.collective_timeout_s)
            log_dist(f"collective watchdog armed: "
                     f"{rc.collective_timeout_s:.1f}s deadline", ranks=[0])
        self._desync = None
        if rc.desync_interval > 0:
            self._desync = DesyncDetector(rc.desync_interval,
                                          rc.desync_tolerance)
        self._preemption_save_dir: Optional[str] = None
        self._preemption_prev_handlers = None
        self._in_step = False
        self._pending_signal = None        # (signum, frame) held for it
        self.preempted = False
        self.swap_corrupted = False

        self.optimizer = OptimizerHandle(self)
        log_dist(
            f"DeepSpeedEngine: zero_stage={self.zero_stage} "
            f"ranks={self.dp_world_size} device={self.device} "
            f"dtype={self.compute_dtype} optimizer={self.optimizer_name} "
            f"fused={self.opt.fused} params={n_total} "
            f"offload={self.offload_tier or 'none'}"
            f"{'+param' if self.offload_param else ''} "
            f"micro={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} "
            f"train_batch={config.train_batch_size}", ranks=[0])

    # ------------------------------------------------------------------

    def _make_swapper(self, numel: int, units):
        """The offload tier over this rank's flat shard of ``numel``
        elements cut into ``units``."""
        cfg = self.config
        off = cfg.zero_optimization.offload_optimizer
        kw = dict(device=self.device, optimizer=self.opt,
                  buffer_count=off.buffer_count,
                  pipeline_read=off.pipeline_read,
                  pipeline_write=off.pipeline_write)
        if self.offload_tier == "cpu":
            sw = swap_tensor.HostMomentSwapper(numel, units, **kw)
        else:
            aio, sdc = cfg.aio, cfg.resilience.sdc
            sw = swap_tensor.NvmeOptimizerSwapper(
                off.nvme_path, numel, units,
                aio_block_size=aio.block_size,
                aio_thread_count=aio.thread_count,
                aio_queue_depth=aio.queue_depth,
                aio_use_odirect=aio.use_odirect,
                sdc_verify=sdc.verify_on_read, sdc_checksum=sdc.checksum,
                sdc_max_reread=sdc.max_reread_retries, **kw)
        log_dist(f"ZeRO-Offload: tier {self.offload_tier}, "
                 f"{len(sw.buckets)} buckets of at most "
                 f"{swap_tensor.bucket_cap()} elements, "
                 f"{sw.host_bytes / 2**30:.2f} GiB of host memory "
                 f"{'page-locked ' if sw.device.type == 'cuda' else ''}"
                 f"in {sw.pin_seconds:.1f} s", ranks=[0])
        return sw

    def _views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: flat[a:b].view(s) for n, s, a, b in zip(
            self._names, self._shapes, self._offsets[:-1],
            self._offsets[1:])}

    def _given_weights(self, state: Dict[str, Any]) -> List[torch.Tensor]:
        """The module's leaves from ``model_parameters``, which must hold
        exactly its parameters, each of its shape."""
        names = set(self._names)
        missing = [n for n in self._names if n not in state]
        unexpected = [k for k in state if k not in names]
        if missing or unexpected:
            raise ValueError(f"model_parameters must hold exactly the "
                           f"module's parameters: missing {missing}, "
                           f"unexpected {unexpected}")
        for name, shape in zip(self._names, self._shapes):
            if tuple(state[name].shape) != shape:
                raise ValueError(f"model_parameters[{name!r}] has shape "
                                 f"{tuple(state[name].shape)}, the module "
                                 f"{shape}")
        return [state[n] for n in self._names]

    def _drawn_weights(self, generator: torch.Generator
                       ) -> Iterator[torch.Tensor]:
        """Each leaf in order, drawn by ``init_module_weights(module,
        generator)`` one module at a time: the draws of ``init_weights``
        over the whole model, in the same order.  A module's parameters
        live in fp32 on the device only until its leaves are taken, then
        go back to the meta device."""
        current = None
        for name in self._names:
            mod_name, _, attr = name.rpartition(".")
            mod = self.module.get_submodule(mod_name)
            if mod is not current:
                if current is not None:
                    _own_params(current, "meta")
                _own_params(mod, self.device)
                self.module.init_module_weights(mod, generator)
                current = mod
            yield getattr(mod, attr).detach()
        if current is not None:
            _own_params(current, "meta")

    def _bind(self, views: Dict[str, torch.Tensor]) -> None:
        """Make the module's parameters ``nn.Parameter``s over ``views``."""
        for name, view in views.items():
            mod_name, _, attr = name.rpartition(".")
            mod = self.module.get_submodule(mod_name)
            setattr(mod, attr, nn.Parameter(view))

    def refresh_working_copy(self) -> None:
        """The working copy from the master weights (after a load)."""
        w = self._working_shard()
        if w is not None:
            if self.swapper is not None:
                self.swapper.fill_working(w)
            else:
                w.copy_(self.state.params)
        if self.zero is not None:
            self.zero.refresh()

    def checkpoint_loaded(self, optimizer: bool = True) -> None:
        """After a load has filled :meth:`checkpoint_pieces`: the NVMe
        tier's last bucket of moments goes to its file, and the working
        copy is made from the master."""
        if optimizer and self._moment_loader is not None:
            self._moment_loader.flush()
        self._moment_loader = None
        self.refresh_working_copy()

    def _settle_tier(self) -> None:
        """Wait for the tier's copies back before the host reads it."""
        if self.swapper is not None:
            self.swapper.synchronize()

    def _working_shard(self) -> Optional[torch.Tensor]:
        """What the optimizer writes the compute-dtype copy into, or None
        when the master is the working copy (fp32)."""
        w = self._flat_w if self.zero is None else self.zero.w_shard
        return None if w is self.state.params else w

    # -- whole leaves from the partitions -------------------------------

    def _unit_leaves(self, flat: torch.Tensor,
                     unit) -> Dict[int, torch.Tensor]:
        """The leaves of ``unit`` in a flat buffer laid out like the master
        shard, whole, on the card: one gather of the unit (every rank
        calls it)."""
        whole = torch.empty(unit.padded, dtype=flat.dtype, device=self.device)
        self.zero.gather_unit(
            self.zero.shard_slice(flat, unit).to(self.device), whole,
            "state_gather")
        return {i: whole[at:at + self.plan.numels[i]].view(self._shapes[i])
                for i, at in zip(unit.leaves, unit.leaf_offsets)}

    def _leaf_full(self, flat: torch.Tensor, i: int) -> torch.Tensor:
        """Leaf ``i`` of a buffer laid out like the master, whole (a
        collective at stages 1-3)."""
        self._settle_tier()
        if self.zero is None:
            return flat[self._offsets[i]:self._offsets[i + 1]].view(
                self._shapes[i])
        unit = self.plan.units[self.plan.unit_of[i]]
        return self._unit_leaves(flat, unit)[i]

    def _full(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        """Every leaf of a buffer laid out like the master, whole, by name
        (a collective at stages 1-3)."""
        self._settle_tier()
        if self.zero is None:
            return self._views(flat)
        out = {}
        for unit in self.plan.units:
            out.update(self._unit_leaves(flat, unit))
        return {n: out[i] for i, n in enumerate(self._names)}

    def checkpoint_pieces(self, for_load: bool = False
                          ) -> List[Tuple[str, Tuple[int, ...], int, int,
                                          Any]]:
        """The state this rank saves (or, ``for_load``, fills on a load):
        ``(path, leaf shape, lo, hi, flat tensor)`` for elements ``[lo,
        hi)`` of each leaf, keyed like the JAX engine's tree
        (``module/<param>``, ``optimizer/<moment>/<param>``,
        ``optimizer/count``).  At stages 1-3 each rank has the pieces of
        its shard; at stage 0 rank 0 saves whole leaves and every rank
        loads them.  An offload tier's master and moments are host
        tensors, except the NVMe tier's moments: their pieces are cut at
        the buckets' bounds and hold, in place of the tensor, a function
        that reads them (a save) or takes them (a load) one bucket at a
        time (``swap_tensor.MomentFiles``)."""
        st = self.state
        self._settle_tier()
        if self.zero is not None:
            ranges = list(self.plan.leaf_pieces())
        elif for_load or self.dp_rank == 0:
            ranges = [(i, 0, b - a, a) for i, (a, b) in enumerate(
                zip(self._offsets[:-1], self._offsets[1:]))]
        else:
            ranges = []
        bufs = [("module", st.params)] + [
            (f"optimizer/{k}", v) for k, v in st.opt_state.items()
            if k != "count"]
        out = [(f"{prefix}/{self._names[i]}", self._shapes[i], lo, hi,
                flat[pos:pos + hi - lo])
               for prefix, flat in bufs for i, lo, hi, pos in ranges]
        if self.swapper is not None and not self.swapper.moments_on_host:
            out += self._moment_file_pieces(ranges, for_load)
        if for_load or self.dp_rank == 0:
            out.append(("optimizer/count", (), 0, 1,
                        st.opt_state["count"].view(1)))
        return out

    def _moment_file_pieces(self, ranges, for_load: bool) -> list:
        """The NVMe tier's moment pieces: the leaf ``ranges`` cut at the
        buckets' bounds, bucket by bucket (its ``m`` pieces, then its
        ``v`` pieces), so that one bucket's ``[m; v]`` is all the host
        holds for them."""
        io = swap_tensor.MomentFiles(self.swapper)
        if for_load:
            self._moment_loader = io
        out = []
        for k, (a, b) in enumerate(self.swapper.buckets):
            for half, name in enumerate(("m", "v")):
                for i, lo, hi, pos in ranges:
                    s, e = max(a, pos), min(b, pos + hi - lo)
                    if s >= e:
                        continue
                    at = half * (b - a) + s - a
                    fn = (functools.partial(io.fill, k, at) if for_load
                          else functools.partial(io.read, k, at,
                                                 at + e - s))
                    out.append((f"optimizer/{name}/{self._names[i]}",
                                self._shapes[i], lo + s - pos, lo + e - pos,
                                fn))
        return out

    def buffer_numels(self) -> Dict[str, int]:
        """Elements of this rank's buffers on the card: fp32 master, each
        moment, fp32 gradient, and the working copy held now (an offload
        tier's master and moments count under ``offloaded``, the working
        shard in host RAM under ``offloaded_working``)."""
        if self.zero is None:
            out = {"master": self.state.params.numel(),
                   "grad_fp32": self._flat_g.numel(),
                   "grad": self._flat_gw.numel(),
                   "working": (0 if self._flat_w is self.state.params
                               else self._flat_w.numel()),
                   "working_shard": 0}
        else:
            out = self.zero.numels()
        out["moments"] = sum(v.numel() for k, v in
                             self.state.opt_state.items() if k != "count")
        if self.swapper is not None:
            out["offloaded"] = out["master"] + out["moments"] + (
                0 if self.swapper.moments_on_host else 2 * self.swapper.numel)
            out["master"] = out["moments"] = 0
        if self.offload_param:
            out["offloaded_working"] = out.pop("working_shard")
            out["working_shard"] = 0
        return out

    @property
    def gas(self) -> int:
        return self.config.gradient_accumulation_steps

    def get_lr(self) -> List[float]:
        return self.lr_scheduler.get_lr()

    @property
    def loss_scale(self) -> float:
        return float(self.state.scale.loss_scale)

    @property
    def skipped_steps(self) -> int:
        return int(self.state.skipped_steps)

    # ------------------------------------------------------------------
    # Batch plumbing
    # ------------------------------------------------------------------

    def _to_device(self, x):
        if isinstance(x, dict):
            return {k: self._to_device(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(self._to_device(v) for v in x)
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device, non_blocking=True)

    def _to_gas_batch(self, batch, local: bool = False) -> List[Any]:
        """``[train_batch, ...]`` -> this rank's ``gas`` micro-batches on
        the device: micro-batch ``i`` is rows ``[i*n, (i+1)*n)`` of the
        global batch (``n = train_batch / gas``), and rank ``r`` of ``W``
        takes rows ``[r*n/W, (r+1)*n/W)`` of it, as the JAX engine shards
        them.  A ``local`` batch (from the engine's own loader) holds this
        rank's rows already."""
        gas = self.gas
        world = 1 if local else self.dp_world_size

        def split(x, i):
            if isinstance(x, dict):
                return {k: split(v, i) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(split(v, i) for v in x)
            if x.shape[0] % (gas * world):
                raise ValueError(
                    f"batch dim {x.shape[0]} not divisible by "
                    f"gradient_accumulation_steps {gas} x ranks {world}")
            n = x.shape[0] // gas
            m = n // world
            start = i * n + (0 if local else self.dp_rank * m)
            return x[start:start + m]

        batch = self._to_device(batch)
        return [split(batch, i) for i in range(gas)]

    def _next_batch(self, data_iter) -> Tuple[Any, bool]:
        """The next batch and whether it holds this rank's rows only."""
        if data_iter is not None:
            return next(data_iter), False
        if self._data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs a data_iter, a batch, "
                                 "or training_data passed to initialize()")
            self._data_iter = iter(self.training_dataloader)
        return next(self._data_iter), True

    def _loss(self, batch) -> torch.Tensor:
        if self.module is not None:
            return self.module(batch)
        return self.loss_fn(self._leaves, batch, self.state.generator)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _backward(self, micro: List[Any], scale: torch.Tensor
                  ) -> torch.Tensor:
        """Forward and backward of every micro-batch; the gradients end
        summed in fp32 (``self._grad``: reduced over the ranks at stages
        1-3, this rank's own at stage 0).  Returns the sum of the scaled
        losses."""
        zb = self.zero
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, mb in enumerate(micro):
            if self.zero_stage <= 1:
                gw = self._flat_gw if zb is None else zb.flat_gw
                gw.zero_()
            loss = self._loss(mb)
            scaled = (loss * scale.to(loss.dtype)).float()
            if zb is None:
                scaled.backward()
            else:
                zb.micro, zb.in_backward = i, True
                try:
                    scaled.backward()
                finally:
                    zb.in_backward = False
                if self.zero_stage >= 2:
                    zb.finish_backward()
            loss_sum += scaled.detach()
            if self.zero_stage <= 1:
                acc = self._flat_g if zb is None else zb.flat_g
                if i == 0:
                    acc.copy_(gw)
                else:
                    acc.add_(gw)
        if self.zero_stage == 1:
            zb.reduce_full_grad()
        return loss_sum

    def _train_step(self, micro: List[Any], lr: float) -> Dict[str, Any]:
        cfg = self.config
        st = self.state
        scale = st.scale.loss_scale
        gas = self.gas
        world = self.dp_world_size
        loss_sum = self._backward(micro, scale)
        if self.swapper is not None and hasattr(self.swapper,
                                                "start_prefetch"):
            # the NVMe tier's first reads run under the backward enqueued
            self.swapper.start_prefetch()

        # overflow scanning exists for fp16 loss scaling (or the
        # resilience knob); bf16/fp32 steps never skip, as in the JAX step
        check_overflow = (cfg.fp16.enabled or
                          cfg.resilience.check_grad_finite > 0)
        g = self._grad
        gscale = torch.ones((), dtype=torch.float32, device=self.device)
        if self.zero is None:
            if world > 1:
                comm.all_reduce(g, group=EXTENT, log_name="grad_all_reduce")
                comm.all_reduce(loss_sum, group=EXTENT,
                                log_name="step_stats")
            if check_overflow or gas * world > 1:
                gscale = 1.0 / (scale * gas * world)
            grad_norm = torch.linalg.vector_norm(g) * gscale
            if check_overflow:
                overflow = ~torch.isfinite(g).all()
        else:
            # the partitions' squared norms and non-finite counts, and the
            # losses, summed over the ranks in one call
            stats = torch.stack([
                loss_sum, _sumsq(g),
                (~torch.isfinite(g)).sum().float() if check_overflow
                else torch.zeros((), device=self.device)])
            comm.all_reduce(stats, group=EXTENT, log_name="step_stats")
            loss_sum = stats[0]
            gscale = 1.0 / (scale * gas * world)
            grad_norm = torch.sqrt(stats[1]) * gscale
            if check_overflow:
                overflow = stats[2] > 0
        if not check_overflow:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        self._last_gscale = gscale
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
            gscale = gscale * prec.clip_factor(grad_norm,
                                               cfg.gradient_clipping)
        sc = self._sc
        sc[0].fill_(lr)
        sc[3:5] = torch.stack([gscale, overflow.float()])
        if self.swapper is None:
            self.opt.step(st.params, g, st.opt_state, sc,
                          self._working_shard())
        else:
            # the bucket stream runs on a skipped step too: the kernel
            # leaves every bucket as it was, nothing is read on the host
            self.opt.bias_corrections(st.opt_state, sc)
            self.swapper.step(g, self._working_shard(), sc)
            self.opt.advance(st.opt_state, sc)
            if cfg.wall_clock_breakdown:
                stats = self.swapper.stage_stats
                for name in SWAP_STAGES:
                    if f"{name}_s" in stats:
                        self.timers(name).record(stats[f"{name}_s"])
        if self.zero is not None:
            self.zero.refresh()

        fp16 = cfg.fp16
        st.scale = prec.update_loss_scale(
            st.scale, overflow, self.dynamic_loss_scale,
            loss_scale_window=fp16.loss_scale_window,
            min_loss_scale=fp16.min_loss_scale,
            consecutive_hysteresis=fp16.consecutive_hysteresis,
            init_hysteresis=fp16.hysteresis)
        st.step += 1
        st.skipped_steps += overflow.to(torch.int32)
        return {"loss": loss_sum / (scale * gas * world),
                "grad_norm": grad_norm, "overflow": overflow,
                "loss_scale": st.scale.loss_scale}

    # ------------------------------------------------------------------
    # Public API (reference parity)
    # ------------------------------------------------------------------

    def train_batch(self, data_iter: Optional[Iterator] = None,
                    batch: Any = None) -> torch.Tensor:
        """One full training step over ``gas`` micro-batches of ``batch``
        (the global ``[train_batch, ...]``; this rank trains on its rows)
        or of the next batch from ``data_iter`` or the engine's dataloader.
        Returns the mean loss over every rank's rows as a device tensor,
        equal on every rank."""
        local = False
        if batch is None:
            batch, local = self._next_batch(data_iter)
        breakdown = self.config.wall_clock_breakdown
        if breakdown:
            self.timers("batch_prep").start()
        micro = self._to_gas_batch(batch, local=local)
        if breakdown:
            self.timers("batch_prep").stop()
        lr = float(self.get_lr()[0])
        if self._offloaded is not None:
            self.reload_states()
        self.tput_timer.start()
        if breakdown:
            self.timers(STEP_GLOBAL_TIMER).start()
        self._in_step = True
        try:
            metrics = self._train_step(micro, lr)
        except BaseException as e:
            self._in_step = False
            if breakdown:
                self.timers(STEP_GLOBAL_TIMER).discard()
            if isinstance(e, SwapCorruptionError):
                self._handle_swap_corruption(e)
            # the state may be torn: a held preemption takes no checkpoint
            self._answer_pending_signal(checkpoint=False)
            raise
        if breakdown:
            self.timers(STEP_GLOBAL_TIMER).stop()
        self._last_metrics = metrics
        self.global_steps += 1
        self.micro_steps += self.gas
        self.global_samples += self.config.train_batch_size
        self.lr_scheduler.step()
        self.tput_timer.stop(global_step=True)
        # the step and its counters are whole: a held preemption saves now
        self._in_step = False
        self._answer_pending_signal(checkpoint=True)
        if self._skip_guard is not None:
            # one scalar read a step, only with the guard configured
            self._skip_guard.update(bool(metrics["overflow"]),
                                    self.global_steps)
        if (self._desync is not None and
                self._desync.should_check(self.global_steps)):
            self._desync.check({"loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"])},
                               self.global_steps)
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(
                f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
                f"lr={self.get_lr()[0]:.3e} "
                f"grad_norm={float(metrics['grad_norm']):.3f} "
                f"loss_scale={float(metrics['loss_scale']):.0f}", ranks=[0])
            if breakdown:
                self.timers.log(["batch_prep", STEP_GLOBAL_TIMER] +
                                list(SWAP_STAGES),
                                normalizer=self.config.steps_per_print)
        return metrics["loss"]

    @torch.no_grad()
    def eval_batch(self, data_iter: Optional[Iterator] = None,
                   batch: Any = None) -> torch.Tensor:
        """The loss of one batch on the working copy, without a step (each
        rank on the batch it is given)."""
        if batch is None:
            batch, _ = self._next_batch(data_iter)
        return self._loss(self._to_device(batch))

    def forward(self, *args, **kwargs):
        raise NotImplementedError(
            "the imperative forward/backward/step triple is not ported yet "
            "(ROADMAP A4): use train_batch")

    backward = step = forward

    def save_checkpoint(self, save_dir: str, tag: Optional[str] = None,
                        client_state: Optional[Dict] = None,
                        save_latest: bool = True,
                        async_save: Optional[bool] = None) -> str:
        from deepspeed_tpu_torch.checkpoint.engine import \
            save_checkpoint as _save

        return _save(self, save_dir, tag=tag, client_state=client_state,
                     save_latest=save_latest, async_save=async_save)

    def load_checkpoint(self, load_dir: str, tag: Optional[str] = None,
                        load_optimizer_states: bool = True,
                        load_lr_scheduler_states: bool = True
                        ) -> Tuple[Optional[str], Optional[Dict]]:
        from deepspeed_tpu_torch.checkpoint.engine import \
            load_checkpoint as _load

        return _load(self, load_dir, tag=tag,
                     load_optimizer_states=load_optimizer_states,
                     load_lr_scheduler_states=load_lr_scheduler_states)

    # -- offloading state between phases, and the fault paths ----------

    def offload_states(self, include: Optional[Tuple[str, ...]] = None
                       ) -> None:
        """Move the optimizer state (``include`` "optimizer", the
        default) and the fp32 master ("params") of a resident engine to
        page-locked host memory, freeing the card between training phases
        (reference ``engine.offload_states``); :meth:`reload_states` or
        the next :meth:`train_batch` moves them back.  A no-op for an
        engine whose state is in an offload tier already, and on the CPU
        (no host memory apart from the device)."""
        if self.swapper is not None or self.device.type != "cuda":
            logger.warning("offload_states: the state is in host memory "
                           "already; no-op")
            return
        if self._offloaded is not None:
            return
        include = tuple(include or ("optimizer",))
        st, owners = self.state, []

        def to_host(t):
            h = swap_tensor.host_buffer(t.numel(), t.dtype, self.device,
                                        zero=False, owners=owners)
            h.copy_(t.reshape(-1))
            return h.view(t.shape)

        if "optimizer" in include:
            for k, v in list(st.opt_state.items()):
                if k != "count":
                    st.opt_state[k] = to_host(v)
        if "params" in include and self._working_shard() is None:
            logger.warning("offload_states: the fp32 master is the working "
                           "copy; params stay on the card")
        elif "params" in include:
            st.params = to_host(st.params)
            if self.zero is not None:
                self.zero.p = st.params
        self._offloaded = owners
        torch.cuda.empty_cache()
        log_dist(f"offload_states: {include} moved to page-locked host "
                 "memory", ranks=[0])

    def reload_states(self) -> None:
        """Inverse of :meth:`offload_states`."""
        if self._offloaded is None:
            return
        st = self.state
        for k, v in list(st.opt_state.items()):
            if k != "count" and v.device.type == "cpu":
                st.opt_state[k] = v.to(self.device)
        if st.params.device.type == "cpu":
            st.params = st.params.to(self.device)
            if self.zero is not None:
                self.zero.p = st.params
        self._offloaded = None
        log_dist("reload_states: state back in device memory", ranks=[0])

    def emergency_checkpoint(self, save_dir: str, torn: bool = False
                             ) -> str:
        """The last-gasp synchronous checkpoint a preemption or a fault
        takes, tagged ``emergency_step<N>``.  ``torn``: the state is not
        a whole step (a failure in the middle of the offload tiers'
        stream): a postmortem copy, tagged ``emergency_step<N>.torn``,
        that ``latest`` never names and a load refuses."""
        from deepspeed_tpu_torch.checkpoint.engine import TORN_SUFFIX

        tag = f"emergency_step{self.global_steps}"
        return self.save_checkpoint(
            save_dir, tag=tag + TORN_SUFFIX if torn else tag,
            save_latest=not torn, async_save=False)

    def _handle_swap_corruption(self, e: SwapCorruptionError) -> None:
        """Persistent silent data corruption in the NVMe tier: the file
        is quarantined and the swapped moments invalidated already.  The
        master was stepped in place up to the corrupt bucket and the
        moments are gone, so the state is no whole step: the emergency
        checkpoint saves it only as a postmortem copy (an attempt: a
        failure is logged and does not mask ``e``), ``latest`` keeps the
        last whole checkpoint, and the caller re-raises so that the job
        restarts from it."""
        self.swap_corrupted = True
        logger.error(f"silent data corruption in the NVMe swap path: {e}")
        save_dir = self._preemption_save_dir
        if save_dir:
            from deepspeed_tpu_torch.telemetry import flight

            flight.dump_on_fault("swap_corruption", e, dir=save_dir)
            try:
                path = self.emergency_checkpoint(save_dir, torn=True)
                logger.error(f"postmortem copy of the torn state at {path}; "
                             "aborting for a restart from 'latest'")
            except BaseException as ce:     # noqa: BLE001 (e re-raised)
                logger.error(f"emergency checkpoint failed under swap "
                             f"corruption ({ce!r}); aborting without it")

    def install_preemption_handler(self, save_dir: str, signals=None,
                                   exit_after: bool = True) -> None:
        """On SIGTERM (a preemption notice) take the emergency checkpoint
        into ``save_dir``, then re-deliver the signal to the previous
        handler (``exit_after=False`` returns to the interrupted code).
        A signal that arrives inside :meth:`train_batch` is held until
        the step is done (the offload tiers update the master in place,
        bucket by bucket, so a save mid-step would hold a torn state);
        if the step fails instead, no checkpoint is taken and the signal
        is re-delivered.  ``save_dir`` also receives the swap-corruption
        path's postmortem copy."""
        import signal as _signal

        signals = tuple(signals or (_signal.SIGTERM,))
        prev = {}

        def handler(signum, frame):
            self.preempted = True
            if self._in_step:
                logger.error(f"signal {signum}: preemption notice inside a "
                             "step; the emergency checkpoint follows it")
                self._pending_signal = (signum, frame)
                return
            self._preempt(signum, frame, checkpoint=True)

        for sig in signals:
            prev[sig] = _signal.signal(sig, handler)
        self._preemption_prev_handlers = prev
        self._preemption_save_dir = save_dir
        self._preemption_exit_after = exit_after

    def _answer_pending_signal(self, checkpoint: bool) -> None:
        if self._pending_signal is not None:
            signum, frame = self._pending_signal
            self._pending_signal = None
            self._preempt(signum, frame, checkpoint)

    def _preempt(self, signum, frame, checkpoint: bool) -> None:
        """Take the emergency checkpoint (unless the state is torn), then
        hand the signal to the handler installed before ours."""
        import signal as _signal

        if checkpoint:
            logger.error(f"signal {signum}: preemption notice, taking the "
                         "emergency checkpoint")
            path = self.emergency_checkpoint(self._preemption_save_dir)
            logger.error(f"emergency checkpoint committed at {path}")
        else:
            logger.error(f"signal {signum}: the step failed under the "
                         "preemption notice; no emergency checkpoint "
                         "('latest' names the last whole one)")
        if not self._preemption_exit_after:
            return
        old = (self._preemption_prev_handlers or {}).get(signum,
                                                         _signal.SIG_DFL)
        if callable(old):
            old(signum, frame)
        else:
            _signal.signal(signum, old)
            _signal.raise_signal(signum)

    def uninstall_preemption_handler(self) -> None:
        import signal as _signal

        if self._preemption_prev_handlers:
            for sig, old in self._preemption_prev_handlers.items():
                _signal.signal(sig, old)
            self._preemption_prev_handlers = None

    def get_global_grad_norm(self) -> Optional[float]:
        """Global (pre-clip) gradient norm of the most recent step."""
        if self._last_metrics is None:
            return None
        return float(self._last_metrics["grad_norm"])

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The fp32 master weights by parameter name, whole, on the device
        (views of the master at stage 0; at stages 1-3 gathered from the
        shards, a collective every rank calls; an offload tier's master
        is in host RAM, and its leaves come back on the card at stages
        1-3, in host RAM at stage 0)."""
        return self._full(self.state.params)

    def train(self, mode: bool = True):
        return self

    def eval(self):
        return self
