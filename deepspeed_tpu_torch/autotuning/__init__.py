"""Autotuning: the training autotuner and the experiment substrate.

Counterpart of ``deepspeed_tpu/autotuning/``: :class:`Autotuner` (ZeRO
stage and micro-batch search over real ``train_batch`` runs), and the
scheduler and tuners that the control plane's offline serving sweep
(:func:`~deepspeed_tpu_torch.control.profile.autotune_serving`) runs on.
"""
from deepspeed_tpu_torch.autotuning.autotuner import Autotuner, ModelInfo
from deepspeed_tpu_torch.autotuning.scheduler import (ExperimentScheduler,
                                                      GridSearchTuner,
                                                      ModelBasedTuner,
                                                      RandomTuner,
                                                      expand_space,
                                                      make_subprocess_runner,
                                                      tune_space)

__all__ = ["Autotuner", "ModelInfo", "ExperimentScheduler",
           "GridSearchTuner", "RandomTuner", "ModelBasedTuner",
           "expand_space", "make_subprocess_runner", "tune_space"]
