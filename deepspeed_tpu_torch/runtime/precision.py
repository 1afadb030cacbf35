"""Mixed precision: dynamic loss scaling, overflow, norms, clipping, dtypes.

Counterpart of ``deepspeed_tpu/runtime/precision.py`` (the reference's
``runtime/fp16/loss_scaler.py`` ``DynamicLossScaler`` and the master-weight
schemes of ``FP16_Optimizer`` / ``BF16_Optimizer``).  The loss scale and
its hysteresis counters are device tensors, updated with ``torch.where``
so that a step never reads them on the host, as the JAX version updates
them inside the jitted step.  Trees are mappings or sequences of tensors.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Tuple

import torch


@dataclasses.dataclass
class LossScaleState:
    """Carried in the train state; all fields are 0-d device tensors."""

    loss_scale: torch.Tensor      # f32
    good_steps: torch.Tensor      # i32 consecutive non-overflow steps
    hysteresis: torch.Tensor      # i32 remaining tolerated overflows


def init_loss_scale(cfg, device: torch.device = torch.device("cpu")
                    ) -> LossScaleState:
    """Build from an ``FP16Config`` (static scale when ``loss_scale`` > 0)."""
    if cfg.enabled and cfg.loss_scale == 0:
        scale = float(2.0 ** cfg.initial_scale_power)
    elif cfg.enabled:
        scale = float(cfg.loss_scale)
    else:
        scale = 1.0
    return LossScaleState(
        loss_scale=torch.tensor(scale, dtype=torch.float32, device=device),
        good_steps=torch.tensor(0, dtype=torch.int32, device=device),
        hysteresis=torch.tensor(cfg.hysteresis if cfg.enabled else 1,
                                dtype=torch.int32, device=device))


def update_loss_scale(state: LossScaleState, overflow: torch.Tensor,
                      dynamic: bool, loss_scale_window: int = 1000,
                      min_loss_scale: float = 1.0,
                      consecutive_hysteresis: bool = False,
                      init_hysteresis: int = 2) -> LossScaleState:
    """One scale update (reference ``DynamicLossScaler.update_scale``).

    Overflow: consume hysteresis; once exhausted halve the scale (bounded by
    ``min_loss_scale``).  ``loss_scale_window`` good steps: double the scale
    and optionally refill hysteresis.
    """
    if not dynamic:
        return state
    scale, good, hyst = state.loss_scale, state.good_steps, state.hysteresis
    init_h = torch.full_like(hyst, init_hysteresis)

    hyst_after_overflow = torch.clamp(hyst - 1, min=0)
    reduce_now = hyst_after_overflow == 0
    scale_on_overflow = torch.where(
        reduce_now, torch.clamp(scale / 2.0, min=min_loss_scale), scale)
    hyst_on_overflow = torch.where(reduce_now, init_h, hyst_after_overflow)

    good_next = good + 1
    window_hit = good_next >= loss_scale_window
    scale_on_good = torch.where(window_hit, scale * 2.0, scale)
    good_on_good = torch.where(window_hit, torch.zeros_like(good), good_next)
    hyst_on_good = init_h if consecutive_hysteresis else hyst

    return LossScaleState(
        loss_scale=torch.where(overflow, scale_on_overflow, scale_on_good),
        good_steps=torch.where(overflow, torch.zeros_like(good),
                               good_on_good),
        hysteresis=torch.where(overflow, hyst_on_overflow, hyst_on_good))


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensors of a mapping, sequence or single tensor, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in tree_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [t for v in tree for t in tree_leaves(v)]
    return []


def has_inf_or_nan(tree: Any) -> torch.Tensor:
    """Global overflow check (reference ``stage3.py:2188 _has_inf_or_nan``):
    a 0-d bool tensor, read on the device."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(False)
    flags = [~torch.isfinite(g).all() for g in leaves]
    return torch.stack(flags).any()


def global_norm(tree: Any) -> torch.Tensor:
    """Global L2 norm across every leaf, in fp32."""
    leaves = tree_leaves(tree)
    if not leaves:
        return torch.tensor(0.0)
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in leaves))


def clip_factor(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """``min(1, max_norm / (norm + 1e-6))``, the factor the JAX engine
    scales gradients by."""
    return torch.clamp(max_norm / (norm + 1e-6), max=1.0)


def clip_by_global_norm(tree: Any, max_norm: float,
                        norm: torch.Tensor = None) -> Tuple[List, torch.Tensor]:
    """Scaled copies of the gradients so that their global norm is at most
    ``max_norm`` (reference engine clipping), and the norm before."""
    if norm is None:
        norm = global_norm(tree)
    factor = clip_factor(norm, max_norm)
    return [g * factor.to(g.dtype) for g in tree_leaves(tree)], norm


DTYPE_MAP = {
    "float32": torch.float32,
    "float16": torch.float16,
    "bfloat16": torch.bfloat16,
    "fp32": torch.float32,
    "fp16": torch.float16,
    "bf16": torch.bfloat16,
}


def compute_dtype_from_config(cfg) -> torch.dtype:
    return DTYPE_MAP[cfg.precision_dtype]


def cast_tree(tree: Any, dtype: torch.dtype) -> Any:
    """Floating tensors of ``tree`` cast to ``dtype``; others as they are."""
    if isinstance(tree, torch.Tensor):
        return tree.to(dtype) if tree.is_floating_point() else tree
    if isinstance(tree, dict):
        return {k: cast_tree(v, dtype) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(cast_tree(v, dtype) for v in tree)
    return tree

