"""Tensor-fragment debug APIs: read and patch partitioned training state.

Counterpart of ``deepspeed_tpu/utils/tensor_fragment.py`` (the reference
DeepSpeed's ``utils/tensor_fragment.py``: ``:132
safe_get_full_fp32_param``, ``:164 safe_get_full_optimizer_state``,
``:199 safe_get_full_grad`` and the local variants ``:243-299``).  The
port's state is flat and, at ZeRO stages 1-3, partitioned
(``runtime/zero.py``), so:

- **full** getters gather the leaf's unit from every rank's shard and
  return the whole leaf (a collective: every rank calls them, for the same
  leaf);
- **local** getters return the elements of the leaf this rank's shard
  holds, flat (empty where it holds none), with no communication;
- **set** variants write a whole value: each rank keeps its piece of it,
  in the master (or the moment) and in the working copy.

Parameters are addressed by the port's names (``engine.module``'s
parameter names, or the loss function's keys).  Moment names follow the
reference: ``exp_avg`` / ``mu`` / ``momentum`` are the first moment
(``m``; SGD's momentum ``trace``), ``exp_avg_sq`` / ``nu`` / ``variance``
the second (``v``).  Getters return fp32 tensors on the engine's device.
"""
from __future__ import annotations

from typing import Optional

import torch

_OPTIM_KEY_ALIASES = {
    "exp_avg": "m", "mu": "m", "momentum": "m", "m": "m",
    "exp_avg_sq": "v", "nu": "v", "variance": "v", "v": "v",
    "trace": "trace",
}


def _leaf(engine, name: str) -> int:
    try:
        return engine._names.index(name)
    except ValueError:
        raise KeyError(f"no parameter {name!r}; known: "
                       f"{engine._names[:20]}") from None


def _moment(engine, key: str) -> Optional[torch.Tensor]:
    if key not in _OPTIM_KEY_ALIASES:
        raise KeyError(f"unknown optimizer state key {key!r}; known: "
                       f"{sorted(_OPTIM_KEY_ALIASES)}")
    state = engine.state.opt_state
    name = _OPTIM_KEY_ALIASES[key]
    if name == "m" and "m" not in state and "trace" in state:
        name = "trace"
    return state.get(name)


def _local(engine, flat: torch.Tensor, i: int) -> torch.Tensor:
    if engine.zero is None:
        return flat[engine._offsets[i]:engine._offsets[i + 1]]
    pieces = [flat[pos:pos + hi - lo] for j, lo, hi, pos in
              engine.plan.leaf_pieces() if j == i]
    return torch.cat(pieces) if pieces else flat[:0]


def _set(engine, flat: torch.Tensor, i: int, value) -> None:
    """Write the whole ``value`` of leaf ``i`` into a master-shaped
    buffer: this rank's pieces of it."""
    value = torch.as_tensor(value, dtype=torch.float32).to(flat.device)
    if tuple(value.shape) != engine._shapes[i]:
        raise ValueError(f"value shape {tuple(value.shape)} != parameter "
                         f"shape {engine._shapes[i]}")
    value = value.reshape(-1)
    if engine.zero is None:
        flat[engine._offsets[i]:engine._offsets[i + 1]].copy_(value)
        return
    for j, lo, hi, pos in engine.plan.leaf_pieces():
        if j == i:
            flat[pos:pos + hi - lo].copy_(value[lo:hi])


# ---------------------------------------------------------------------------
# full accessors
# ---------------------------------------------------------------------------

def safe_get_full_fp32_param(engine, name: str) -> torch.Tensor:
    """The whole fp32 master value of one parameter (reference ``:132``)."""
    i = _leaf(engine, name)
    return engine._leaf_full(engine.state.params, i).clone()


def safe_set_full_fp32_param(engine, name: str, value) -> None:
    """Overwrite one parameter everywhere (reference ``:148``): its master
    pieces, then the working copy (every rank calls it, with the same
    value)."""
    _set(engine, engine.state.params, _leaf(engine, name), value)
    engine.refresh_working_copy()


def safe_get_full_optimizer_state(engine, name: str, optim_state_key: str
                                  ) -> Optional[torch.Tensor]:
    """The whole optimizer moment of one parameter (reference ``:164``),
    or None when the optimizer keeps no such moment."""
    flat = _moment(engine, optim_state_key)
    if flat is None:
        return None
    return engine._leaf_full(flat, _leaf(engine, name)).clone()


def safe_set_full_optimizer_state(engine, name: str, value,
                                  optim_state_key: str) -> None:
    """Overwrite one optimizer moment everywhere (reference ``:181``)."""
    flat = _moment(engine, optim_state_key)
    if flat is None:
        raise KeyError(f"the optimizer keeps no {optim_state_key!r}")
    _set(engine, flat, _leaf(engine, name), value)


def safe_get_full_grad(engine, name: str) -> Optional[torch.Tensor]:
    """The whole gradient of one parameter that the last step used
    (averaged over the ranks and micro-batches, unscaled, before
    clipping; reference ``:199``), or None before the first step."""
    if engine._last_gscale is None:
        return None
    grad = engine._leaf_full(engine._grad, _leaf(engine, name))
    return grad * engine._last_gscale


# ---------------------------------------------------------------------------
# local accessors
# ---------------------------------------------------------------------------

def safe_get_local_fp32_param(engine, name: str) -> torch.Tensor:
    """The elements of a parameter's master this rank holds, flat
    (reference ``:269``)."""
    return _local(engine, engine.state.params, _leaf(engine, name)).clone()


def safe_get_local_optimizer_state(engine, name: str, optim_state_key: str
                                   ) -> Optional[torch.Tensor]:
    flat = _moment(engine, optim_state_key)
    if flat is None:
        return None
    return _local(engine, flat, _leaf(engine, name)).clone()


def safe_get_local_grad(engine, name: str) -> Optional[torch.Tensor]:
    if engine._last_gscale is None:
        return None
    return _local(engine, engine._grad, _leaf(engine, name)) * \
        engine._last_gscale
