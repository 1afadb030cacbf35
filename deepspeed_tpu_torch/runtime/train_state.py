"""Train state.

Counterpart of ``deepspeed_tpu/runtime/train_state.py``.  The JAX package
threads one immutable pytree through the jitted step; here the same fields
are a plain dataclass of tensors that the engine updates in place.
``params`` is the flat fp32 master buffer (the model's leaves are views of
the working copy, see ``runtime/engine.py``), ``opt_state`` the
optimizer's flat moments and step count, and ``generator`` the state of
the ``torch.Generator`` that takes the place of the JAX PRNG key.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from deepspeed_tpu_torch.runtime.precision import LossScaleState


@dataclasses.dataclass
class TrainState:
    step: int                            # global step counter
    params: torch.Tensor                 # flat master params
    opt_state: Dict[str, torch.Tensor]
    scale: LossScaleState
    generator: torch.Generator           # stands in for the PRNG key
    skipped_steps: torch.Tensor          # i32 overflow-skipped step count
