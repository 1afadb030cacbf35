"""Autotuner: discover the best ZeRO stage + micro-batch configuration.

Counterpart of ``deepspeed_tpu/autotuning/autotuner.py`` (the reference
autotuner, ``autotuning/autotuner.py:42 Autotuner``: memory-model stage
pruning ``:278``, micro-batch search ``:851``, experiment records
``:708``, ``write_optimal_config:1075``).

- **Model info is free**: parameter counts come from a module built on
  the ``meta`` device (:meth:`ModelInfo.from_model`), so no weights are
  allocated.
- **The memory model is the reference's** (``instantiation_memory``,
  ``memory_fits``), unchanged, so stage pruning agrees with the JAX
  package.  The port's stage-0 engine keeps 20 bytes a parameter in bf16
  (fp32 master, two moments, fp32 gradient, bf16 copy and bf16 gradient)
  where the model counts 16; each record keeps the model's estimate
  beside the peak the card measured.

The tuning loop mirrors the reference strategy: rank ZeRO stages by the
Adam memory model, prune stages whose instantiation memory cannot fit,
then for each surviving stage search micro-batch sizes (doubling sweep),
measure each candidate with the injected ``runner`` (:func:`engine_runner`:
build a real engine and time ``train_batch``), and keep records.  A point
that runs out of device memory is a failed experiment, as in the
reference; nothing is retried on the CPU.  ``tune()`` returns the best
config; ``write_optimal_config`` saves it.
"""
from __future__ import annotations

import copy
import gc
import json
import os
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.autotuning.scheduler import record_experiment_metrics
from deepspeed_tpu_torch.utils.logging import logger

ADAM_BYTES_PER_PARAM_FP32 = 8        # two fp32 moments
MASTER_BYTES_PER_PARAM = 4


@dataclass
class ModelInfo:
    num_params: int
    hidden_size: int = 0
    num_layers: int = 0

    @staticmethod
    def from_model(model, example_batch=None, rng=None) -> "ModelInfo":
        """Count ``model``'s parameters (an ``nn.Module``: build it under
        ``torch.device("meta")`` to allocate nothing).  Shared (tied)
        parameters count once.  ``example_batch`` and ``rng`` are the JAX
        signature's and unused: a module's shapes do not depend on a
        batch."""
        return ModelInfo(num_params=sum(p.numel()
                                        for p in model.parameters()))


def _world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if (dist.is_available()
                                     and dist.is_initialized()) else 1


class Autotuner:
    """``Autotuner(model_info, base_config, runner).tune()`` -> best
    (ds_config, metric).  ``runner(ds_config) -> samples_per_sec`` (or
    any higher-is-better metric); raise/return None for OOM/failure.
    ``num_chips`` defaults to the process group's world size (1 without
    one); ``hbm_bytes`` to the device's total memory (``device``: ``cuda``
    by default, the CPU only when asked for, whose memory is the host's).
    """

    def __init__(self, model_info: ModelInfo, base_config: Dict[str, Any],
                 runner: Optional[Callable[[Dict], Optional[float]]] = None,
                 num_chips: Optional[int] = None,
                 hbm_bytes: Optional[float] = None,
                 metric: str = "throughput",
                 device: DeviceLike = None):
        self.model_info = model_info
        self.base_config = copy.deepcopy(base_config)
        at = dict(self.base_config.pop("autotuning", {}))
        self.tuner_config = at
        self.metric_name = at.get("metric", metric)
        self.fast = bool(at.get("fast", True))
        self.max_mbs_cap = int(at.get("max_train_micro_batch_size_per_gpu",
                                      1024))
        self.start_mbs = int(at.get("min_train_micro_batch_size_per_gpu",
                                    1))
        self.stages = at.get("zero_stages", [0, 1, 2, 3])
        self.runner = runner or self._default_runner
        self.num_chips = num_chips or _world_size()
        self._device = device
        self.hbm_bytes = hbm_bytes or self._detect_hbm()
        self.records: List[Dict[str, Any]] = []
        self.best: Optional[Tuple[Dict, float]] = None

    # -- hardware/memory model -----------------------------------------

    def _detect_hbm(self) -> float:
        dev = resolve_device(self._device)
        if dev.type == "cuda":
            return float(torch.cuda.get_device_properties(dev).total_memory)
        return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))

    def instantiation_memory(self, zero_stage: int,
                             fp16: Optional[bool] = None) -> float:
        """Reference ``get_instantiation_memory_required_per_gpu:278``:
        Adam memory model per device (params + grads + optimizer states,
        divided by the shards each stage introduces)."""
        n = self.model_info.num_params
        low_prec = fp16 if fp16 is not None else self._low_precision()
        params = n * (2 if low_prec else 4)
        grads = n * (2 if low_prec else 4)
        # master copy + both moments when training in low precision
        optimizer = n * ((MASTER_BYTES_PER_PARAM +
                          ADAM_BYTES_PER_PARAM_FP32) if low_prec
                         else ADAM_BYTES_PER_PARAM_FP32)
        shards = max(self.num_chips, 1)
        if zero_stage >= 1:
            optimizer /= shards
        if zero_stage >= 2:
            grads /= shards
        if zero_stage >= 3:
            params /= shards
        return params + grads + optimizer

    def _low_precision(self) -> bool:
        return bool(self.base_config.get("fp16", {}).get("enabled") or
                    self.base_config.get("bf16", {}).get("enabled"))

    def memory_fits(self, zero_stage: int, margin: float = 0.85) -> bool:
        return self.instantiation_memory(zero_stage) < \
            self.hbm_bytes * margin

    # -- experiment generation + search --------------------------------

    def _candidate_stages(self) -> List[int]:
        user = self.base_config.get("zero_optimization", {}).get("stage")
        stages = [user] if user is not None else list(self.stages)
        fits = [s for s in stages if self.memory_fits(s)]
        dropped = sorted(set(stages) - set(fits))
        if dropped:
            logger.info(f"autotuning: pruned zero stages {dropped} "
                        "(instantiation memory exceeds device memory)")
        # prefer lighter-comm stages first (reference tuning order)
        return sorted(fits)

    def _config_for(self, stage: int, mbs: int) -> Dict[str, Any]:
        cfg = copy.deepcopy(self.base_config)
        cfg.setdefault("zero_optimization", {})["stage"] = stage
        cfg["train_micro_batch_size_per_gpu"] = mbs
        cfg.pop("train_batch_size", None)
        cfg.setdefault("gradient_accumulation_steps", 1)
        return cfg

    def _measure(self, stage: int, mbs: int) -> Optional[float]:
        cfg = self._config_for(stage, mbs)
        cuda = torch.cuda.is_available()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        try:
            val = self.runner(cfg)
        except Exception as e:
            logger.info(f"autotuning: stage={stage} mbs={mbs} failed: {e}")
            val = None
        rec = {"zero_stage": stage, "micro_batch_size": mbs,
               self.metric_name: val,
               "tuning_seconds": time.perf_counter() - t0,
               # the memory model's bytes beside the peak the device saw
               "estimate_bytes": self.instantiation_memory(stage),
               "peak_bytes": (torch.cuda.max_memory_allocated()
                              if cuda else None)}
        record_experiment_metrics(val, rec["tuning_seconds"])
        self.records.append(rec)
        if val is not None and (self.best is None or val > self.best[1]):
            self.best = (cfg, val)
        return val

    def tune(self) -> Tuple[Optional[Dict[str, Any]], Optional[float]]:
        """Doubling micro-batch sweep per surviving stage; a stage stops
        when a size fails or the metric plateaus (reference
        ``tune_space`` early-stop semantics)."""
        for stage in self._candidate_stages():
            mbs = self.start_mbs
            prev = None
            while mbs <= self.max_mbs_cap:
                val = self._measure(stage, mbs)
                if val is None:
                    break
                if prev is not None and val < prev * 1.02:
                    break                      # throughput plateau
                prev = val
                mbs *= 2
            if self.fast and self.best is not None:
                # fast mode: first fitting stage's sweep is enough unless
                # a later stage is needed to fit at all
                break
        if self.best is None:
            logger.warning("autotuning: no configuration succeeded")
            return None, None
        return self.best

    # -- reporting (reference print_tuning_results / write_optimal) -----

    def print_tuning_results(self) -> None:
        logger.info("autotuning records:")
        for r in self.records:
            logger.info(f"  stage={r['zero_stage']} "
                        f"mbs={r['micro_batch_size']} "
                        f"{self.metric_name}={r[self.metric_name]}")
        if self.best is not None:
            logger.info(f"best: {json.dumps(self.best[0])} -> "
                        f"{self.best[1]:.2f} {self.metric_name}")

    def write_optimal_config(self, path: str) -> None:
        if self.best is None:
            raise RuntimeError("no optimal config: call tune() first")
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.best[0], f, indent=2)

    # -- default runner: real engine, timed steps -----------------------

    def _default_runner(self, ds_config: Dict[str, Any]
                        ) -> Optional[float]:
        raise NotImplementedError(
            "pass runner= (ds_config -> samples/sec); the engine-backed "
            "default needs model/batch context — use "
            "engine_runner(model, batch_fn)")


def engine_runner(model, batch_fn: Callable[[int], Any], steps: int = 3,
                  topology=None, device: DeviceLike = None):
    """Build the default measurement runner: a real engine for each
    candidate config (``initialize`` -> ``train_batch``), timed over
    ``steps`` steps after a warm-up one (samples/sec), each window closed
    by ``torch.cuda.synchronize()`` on the card.  ``model``: a loss
    module, deep-copied for every point (build it under
    ``torch.device("meta")`` to have each point draw its weights on the
    device from seed 0).
    ``batch_fn(global_batch_size)`` supplies a batch of that size.  Each
    point drops its engine and returns the allocator's cached blocks
    before the next, also when it fails (an out-of-memory point leaves
    nothing behind for the next one)."""
    dev = resolve_device(device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def run(ds_config: Dict[str, Any]) -> float:
        import deepspeed_tpu_torch

        engine = batch = module = None
        try:
            module = copy.deepcopy(model)
            engine, *_ = deepspeed_tpu_torch.initialize(
                model=module, config=ds_config, topology=topology,
                device=dev,
                generator=torch.Generator(device=dev).manual_seed(0))
            batch = batch_fn(engine.config.train_batch_size)
            engine.train_batch(batch=batch)        # warm-up: kernel builds
            sync()
            t0 = time.perf_counter()
            for _ in range(steps):
                engine.train_batch(batch=batch)
            sync()
            dt = (time.perf_counter() - t0) / steps
            return engine.config.train_batch_size / dt
        finally:
            engine = batch = module = None
            gc.collect()
            if dev.type == "cuda":
                torch.cuda.empty_cache()

    return run
