"""The training engine, ZeRO stage 0 on one device.

Counterpart of ``deepspeed_tpu/runtime/engine.py`` (``initialize`` and
``DeepSpeedEngine``, the reference's ``deepspeed.initialize`` and
``runtime/engine.py:184``).  Where the JAX engine compiles one
``train_step(state, batch, lr)``, this one runs the same step eagerly:

1. for each of the ``gas`` micro-batches: forward on the compute-dtype
   working copy of the weights, backward of ``loss * loss_scale``, and the
   micro-batch's gradient added into an fp32 accumulator;
2. the gradient scale ``1/(loss_scale * gas)``, the global norm, the
   clipping factor and (fp16) the overflow flag, all on the device;
3. one optimizer launch that updates the fp32 master weights, the moments
   and the working copy (``ops/fused_adam.py``), skipping everything on
   overflow; then the loss-scale update.

Memory layout: the fp32 master weights, the fp32 gradient accumulator and
the moments are flat buffers; the model's parameters are views of a flat
working copy in the compute dtype (bf16 or fp16; the master itself in
fp32), and their ``.grad`` are views of a flat compute-dtype gradient
buffer that autograd accumulates into in place.  So the optimizer is one
launch per step, and ZeRO (ROADMAP A6) can partition the flat buffers.

The forward runs on compute-dtype copies of every floating parameter, the
RMSNorm weights included (``prec.cast_tree`` in the JAX step), not under
``torch.autocast``.  Nothing in a step reads a device value on the host
(only the throughput timer synchronises around it, as the JAX one does);
``train_batch`` returns the loss as a device tensor.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: ZeRO stages 1-3 and hpZ (A6), offload and NVMe, 1-bit
optimizers, curriculum learning and TP/PP/SP/EP (A11), the imperative
``forward``/``backward``/``step`` triple (A4), pure-bf16 training without
master weights (A4), async checkpoint save (A5).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.config.config import DeepSpeedConfig, load_config
from deepspeed_tpu_torch.ops.fused_adam import step_scalars
from deepspeed_tpu_torch.runtime import precision as prec
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.lr_schedules import (LRScheduler,
                                                      get_schedule_fn)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
from deepspeed_tpu_torch.runtime.train_state import TrainState
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
      by its ``init_weights(generator)`` on the device; or
    - a loss function ``loss_fn(params, batch, generator) -> scalar`` with
      the params (a dict of tensors) in ``model_parameters``.

    ``device``: ``cuda`` by default (raises without a GPU); the CPU only
    when asked for.  ``generator`` seeds weight init and is carried in the
    train state; by default one on the device seeded with ``config.seed``.
    Returns ``(engine, optimizer, training_dataloader, lr_scheduler)``.
    """
    if model is None:
        raise ValueError("deepspeed_tpu_torch.initialize: model is required")
    ds_config = load_config(config if config is not None else config_params,
                            dp_world_size=1)
    engine = DeepSpeedEngine(model=model, model_parameters=model_parameters,
                             config=ds_config, optimizer_name=optimizer,
                             lr_scheduler=lr_scheduler,
                             training_data=training_data, device=device,
                             generator=generator)
    return (engine, engine.optimizer, engine.training_dataloader,
            engine.lr_scheduler)


def _unported(config: DeepSpeedConfig) -> Dict[str, str]:
    """Config settings of paths not ported yet -> their ROADMAP item."""
    z = config.zero_optimization
    out = {}
    if z.stage > 0:
        out[f"zero_optimization.stage={z.stage}"] = "A6"
    if z.zero_hpz_partition_size > 1:
        out["zero_optimization.zero_hpz_partition_size"] = "A6"
    for name, off in (("offload_optimizer", z.offload_optimizer),
                      ("offload_param", z.offload_param)):
        if off is not None and off.device != "none":
            out[f"zero_optimization.{name}.device={off.device}"] = "A11"
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
        return self._engine.checkpoint_tree()["optimizer"]

    def __repr__(self):  # pragma: no cover
        return f"OptimizerHandle({self._engine.optimizer_name})"


class DeepSpeedEngine:
    """Owns the config, the flat train state and the step."""

    def __init__(self, model, model_parameters, config: DeepSpeedConfig,
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

        flat_p = torch.empty(n_total, dtype=torch.float32, device=self.device)
        master = self._views(flat_p)
        if self.module is not None:
            on_meta = any(p.is_meta for _, p in named)
            with torch.no_grad():
                if not on_meta:
                    for (_, p), view in zip(named, master.values()):
                        view.copy_(p)
                self._bind(master)             # the module's leaves -> master
                if model_parameters is not None:
                    self.module.load_state_dict(model_parameters, strict=True)
                elif on_meta:
                    if not hasattr(model, "init_weights"):
                        raise ValueError(
                            "a module built on the meta device needs "
                            "model_parameters or an init_weights(generator)")
                    model.init_weights(generator)
        else:
            with torch.no_grad():
                for (_, p), view in zip(named, master.values()):
                    view.copy_(p)

        # working copy in the compute dtype (the master itself in fp32)
        self._flat_w = (flat_p if self.compute_dtype == torch.float32 else
                        flat_p.to(self.compute_dtype))
        self._flat_gw = torch.zeros(n_total, dtype=self.compute_dtype,
                                    device=self.device)
        self._flat_g = torch.zeros(n_total, dtype=torch.float32,
                                   device=self.device)
        self._leaves = self._views(self._flat_w)
        if self.module is not None:
            self._bind(self._leaves)
            self._leaves = dict(self.module.named_parameters())
        else:
            for t in self._leaves.values():
                t.requires_grad_(True)
        for leaf, g in zip(self._leaves.values(),
                           self._views(self._flat_gw).values()):
            leaf.grad = g              # autograd accumulates here in place

        self._sc = step_scalars(self.device)
        self.state = TrainState(
            step=0, params=flat_p, opt_state=self.opt.init(flat_p),
            scale=prec.init_loss_scale(config.fp16, self.device),
            generator=generator,
            skipped_steps=torch.zeros((), dtype=torch.int32,
                                      device=self.device))

        # -- data ---------------------------------------------------------
        self.training_dataloader = None
        if training_data is not None:
            self.training_dataloader = RepeatingLoader(DeepSpeedDataLoader(
                training_data, batch_size=config.train_batch_size,
                seed=config.seed, drop_last=config.dataloader_drop_last))
        self._data_iter = None
        self._last_metrics = None

        self.timers = SynchronizedWallClockTimer()
        self.tput_timer = ThroughputTimer(
            batch_size=config.train_batch_size,
            steps_per_output=config.steps_per_print)
        self.optimizer = OptimizerHandle(self)
        log_dist(
            f"DeepSpeedEngine: zero_stage=0 device={self.device} "
            f"dtype={self.compute_dtype} optimizer={self.optimizer_name} "
            f"fused={self.opt.fused} params={n_total} "
            f"micro={config.train_micro_batch_size_per_gpu} "
            f"gas={config.gradient_accumulation_steps} "
            f"train_batch={config.train_batch_size}", ranks=[0])

    # ------------------------------------------------------------------

    def _views(self, flat: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {n: flat[a:b].view(s) for n, s, a, b in zip(
            self._names, self._shapes, self._offsets[:-1],
            self._offsets[1:])}

    def _bind(self, views: Dict[str, torch.Tensor]) -> None:
        """Make the module's parameters ``nn.Parameter``s over ``views``."""
        for name, view in views.items():
            mod_name, _, attr = name.rpartition(".")
            mod = self.module.get_submodule(mod_name)
            setattr(mod, attr, nn.Parameter(view))

    def refresh_working_copy(self) -> None:
        """The working copy from the master weights (after a load)."""
        if self._flat_w is not self.state.params:
            self._flat_w.copy_(self.state.params)

    def checkpoint_tree(self) -> Dict[str, Any]:
        """Views of the state the checkpoint carries, keyed like the JAX
        engine's: ``module/<param>``, ``optimizer/<moment>/<param>`` and
        ``optimizer/count``."""
        opt = {k: (self._views(v) if k != "count" else v)
               for k, v in self.state.opt_state.items()}
        return {"module": self._views(self.state.params), "optimizer": opt}

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

    def _to_gas_batch(self, batch) -> List[Any]:
        """``[train_batch, ...]`` -> ``gas`` micro-batches on the device."""
        gas = self.gas

        def split(x, i):
            if isinstance(x, dict):
                return {k: split(v, i) for k, v in x.items()}
            if isinstance(x, (list, tuple)):
                return type(x)(split(v, i) for v in x)
            if x.shape[0] % gas:
                raise ValueError(f"batch dim {x.shape[0]} not divisible by "
                                 f"gradient_accumulation_steps {gas}")
            n = x.shape[0] // gas
            return x[i * n:(i + 1) * n]

        batch = self._to_device(batch)
        return [split(batch, i) for i in range(gas)]

    def _next_batch(self, data_iter):
        if data_iter is not None:
            return next(data_iter)
        if self._data_iter is None:
            if self.training_dataloader is None:
                raise ValueError("train_batch needs a data_iter, a batch, "
                                 "or training_data passed to initialize()")
            self._data_iter = iter(self.training_dataloader)
        return next(self._data_iter)

    def _loss(self, batch) -> torch.Tensor:
        if self.module is not None:
            return self.module(batch)
        return self.loss_fn(self._leaves, batch, self.state.generator)

    # ------------------------------------------------------------------
    # The step
    # ------------------------------------------------------------------

    def _train_step(self, micro: List[Any], lr: float) -> Dict[str, Any]:
        cfg = self.config
        st = self.state
        scale = st.scale.loss_scale
        gas = self.gas
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for i, mb in enumerate(micro):
            self._flat_gw.zero_()
            loss = self._loss(mb)
            scaled = (loss * scale.to(loss.dtype)).float()
            scaled.backward()
            loss_sum += scaled.detach()
            if i == 0:
                self._flat_g.copy_(self._flat_gw)
            else:
                self._flat_g.add_(self._flat_gw)

        # overflow scanning exists for fp16 loss scaling (or the
        # resilience knob); bf16/fp32 steps never skip, as in the JAX step
        check_overflow = (cfg.fp16.enabled or
                          cfg.resilience.check_grad_finite > 0)
        g = self._flat_g
        gscale = torch.ones((), dtype=torch.float32, device=self.device)
        if check_overflow or gas > 1:
            gscale = 1.0 / (scale * gas)
        grad_norm = torch.linalg.vector_norm(g) * gscale
        if cfg.gradient_clipping and cfg.gradient_clipping > 0:
            gscale = gscale * prec.clip_factor(grad_norm,
                                               cfg.gradient_clipping)
        if check_overflow:
            overflow = ~torch.isfinite(g).all()
        else:
            overflow = torch.zeros((), dtype=torch.bool, device=self.device)
        sc = self._sc
        sc[0].fill_(lr)
        sc[3:5] = torch.stack([gscale, overflow.float()])
        w = None if self._flat_w is st.params else self._flat_w
        self.opt.step(st.params, g, st.opt_state, sc, w)

        fp16 = cfg.fp16
        st.scale = prec.update_loss_scale(
            st.scale, overflow, self.dynamic_loss_scale,
            loss_scale_window=fp16.loss_scale_window,
            min_loss_scale=fp16.min_loss_scale,
            consecutive_hysteresis=fp16.consecutive_hysteresis,
            init_hysteresis=fp16.hysteresis)
        st.step += 1
        st.skipped_steps += overflow.to(torch.int32)
        return {"loss": loss_sum / (scale * gas), "grad_norm": grad_norm,
                "overflow": overflow, "loss_scale": st.scale.loss_scale}

    # ------------------------------------------------------------------
    # Public API (reference parity)
    # ------------------------------------------------------------------

    def train_batch(self, data_iter: Optional[Iterator] = None,
                    batch: Any = None) -> torch.Tensor:
        """One full training step over ``gas`` micro-batches of ``batch``
        (``[train_batch, ...]``) or of the next batch from ``data_iter`` or
        the engine's dataloader.  Returns the mean loss as a device
        tensor."""
        if batch is None:
            batch = self._next_batch(data_iter)
        breakdown = self.config.wall_clock_breakdown
        if breakdown:
            self.timers("batch_prep").start()
        micro = self._to_gas_batch(batch)
        if breakdown:
            self.timers("batch_prep").stop()
        lr = float(self.get_lr()[0])
        self.tput_timer.start()
        if breakdown:
            self.timers(STEP_GLOBAL_TIMER).start()
        metrics = self._train_step(micro, lr)
        if breakdown:
            self.timers(STEP_GLOBAL_TIMER).stop()
        self._last_metrics = metrics
        self.global_steps += 1
        self.micro_steps += self.gas
        self.global_samples += self.config.train_batch_size
        self.lr_scheduler.step()
        self.tput_timer.stop(global_step=True)
        if self.global_steps % self.config.steps_per_print == 0:
            log_dist(
                f"step={self.global_steps} loss={float(metrics['loss']):.4f} "
                f"lr={self.get_lr()[0]:.3e} "
                f"grad_norm={float(metrics['grad_norm']):.3f} "
                f"loss_scale={float(metrics['loss_scale']):.0f}", ranks=[0])
            if breakdown:
                self.timers.log(["batch_prep", STEP_GLOBAL_TIMER],
                                normalizer=self.config.steps_per_print)
        return metrics["loss"]

    @torch.no_grad()
    def eval_batch(self, data_iter: Optional[Iterator] = None,
                   batch: Any = None) -> torch.Tensor:
        """The loss of one batch on the working copy, without a step."""
        if batch is None:
            batch = self._next_batch(data_iter)
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

    def get_global_grad_norm(self) -> Optional[float]:
        """Global (pre-clip) gradient norm of the most recent step."""
        if self._last_metrics is None:
            return None
        return float(self._last_metrics["grad_norm"])

    def module_state_dict(self) -> Dict[str, torch.Tensor]:
        """The fp32 master weights by parameter name (views of the flat
        master buffer, on the device)."""
        return self._views(self.state.params)

    def train(self, mode: bool = True):
        return self

    def eval(self):
        return self
