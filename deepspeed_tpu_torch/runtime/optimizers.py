"""Optimizer factory.

Counterpart of ``deepspeed_tpu/runtime/optimizers.py`` (the reference's
``_configure_basic_optimizer``, ``runtime/engine.py:1402``): the same
config names resolve to an update over the engine's flat fp32 buffers.
As in the JAX package, the learning rate is not part of the update
direction: it arrives each step in the scalar tensor of
:func:`deepspeed_tpu_torch.ops.fused_adam.step_scalars`, beside the
bias corrections, the gradient scale and the overflow flag, and the
update applies ``p - lr * u`` itself (the JAX engine does so right after
the transform).

- ``fused=true`` Adam-family and Lion configs launch the hand-written
  kernels of ``ops/fused_adam.py`` (one launch per step);
- otherwise the update is plain torch math, the counterpart of the optax
  chain XLA fuses: Adam with decoupled decay whatever ``adam_w_mode`` says
  (the JAX package's documented divergence, ``optimizers.py:92-97``,
  reproduced), Lion, and SGD with momentum and Nesterov.

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: Lamb, Adagrad and the muP optimizers (A3), the 1-bit family
(A11).
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from deepspeed_tpu_torch.ops import fused_adam as fa

_UNPORTED = {
    "lamb": "A3", "adagrad": "A3", "muadam": "A3", "muadamw": "A3",
    "musgd": "A3", "onebitadam": "A11", "onebitlamb": "A11",
    "zerooneadam": "A11",
}


def is_fused_optimizer(name: Optional[str], params: Dict[str, Any]) -> bool:
    """True when this (name, params) resolves to the fused kernels: only
    with ``params.fused=true``, as in the JAX package."""
    name = (name or "adamw").lower()
    return bool(dict(params or {}).get("fused", False)) and name in (
        "adam", "adamw", "fusedadam", "lion", "fusedlion")


class FlatOptimizer:
    """An optimizer over one flat fp32 parameter buffer.

    :meth:`init` makes the state (flat fp32 moments and an int32 step
    count, on the parameters' device); :meth:`step` updates the master
    weights ``p``, the state and the working copy ``w`` in place from the
    gradient ``g`` and the step scalars ``sc`` (``[lr, bc1, bc2, gscale,
    skip]``; it fills ``bc1`` and ``bc2`` from the count).  A nonzero
    ``skip`` leaves everything untouched, the count included, as the JAX
    engine reverts the whole optimizer state on an fp16 overflow."""

    moments: tuple = ()

    def __init__(self, name: str, fused: bool):
        self.name = name
        self.fused = fused

    def init(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        state = {k: torch.zeros_like(p) for k in self.moments}
        state["count"] = torch.zeros((), dtype=torch.int32, device=p.device)
        return state

    def step(self, p, g, state, sc, w=None) -> None:
        raise NotImplementedError

    @staticmethod
    def advance(state, sc) -> None:
        """Count the step just taken, unless ``sc`` says it was skipped."""
        state["count"].add_((sc[4] == 0).to(torch.int32))


class Adam(FlatOptimizer):
    moments = ("m", "v")

    def __init__(self, name, fused, b1, b2, eps, wd, adam_w):
        super().__init__(name, fused)
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, wd
        # the optax chain of the non-fused path always decouples the decay
        self.adam_w = adam_w if fused else True

    def bias_corrections(self, state, sc) -> None:
        """``sc[1:3]``: the bias corrections of the step about to be
        taken, 1 - b^t in fp32 (the offload tiers' step reads them too)."""
        t = (state["count"] + 1).float()
        sc[1] = 1.0 - torch.pow(self.b1, t)
        sc[2] = 1.0 - torch.pow(self.b2, t)

    def update(self, p, g, m, v, sc, w=None) -> None:
        """The AdamW update of flat ``p, m, v`` (and ``w``) in place, with
        the bias corrections already in ``sc``: the whole step's, or one
        offload bucket's (``runtime/swap_tensor.py``)."""
        kw = dict(b1=self.b1, b2=self.b2, eps=self.eps, wd=self.wd,
                  adam_w=self.adam_w)
        if self.fused:
            fa.fused_adam(p, g, m, v, sc, w, **kw)
        else:
            fa.adam_update_reference(p, g, m, v, sc, w, **kw)

    def step(self, p, g, state, sc, w=None) -> None:
        self.bias_corrections(state, sc)
        self.update(p, g, state["m"], state["v"], sc, w)
        self.advance(state, sc)


class Lion(FlatOptimizer):
    moments = ("m",)

    def __init__(self, name, fused, b1, b2, wd):
        super().__init__(name, fused)
        self.b1, self.b2, self.wd = b1, b2, wd

    def step(self, p, g, state, sc, w=None) -> None:
        kw = dict(b1=self.b1, b2=self.b2, wd=self.wd)
        if self.fused:
            fa.fused_lion(p, g, state["m"], sc, w, **kw)
        else:
            fa.lion_update_reference(p, g, state["m"], sc, w, **kw)
        self.advance(state, sc)


class SGD(FlatOptimizer):
    """``optax.trace`` (momentum, Nesterov) then ``add_decayed_weights``."""

    def __init__(self, name, momentum, nesterov, wd):
        super().__init__(name, False)
        self.momentum, self.nesterov, self.wd = momentum, nesterov, wd
        self.moments = ("trace",) if momentum else ()

    def step(self, p, g, state, sc, w=None) -> None:
        lr, gscale, skip = sc[0], sc[3], sc[4] != 0
        u = g * gscale
        if self.momentum:
            tr = u + self.momentum * state["trace"]
            u = u + self.momentum * tr if self.nesterov else tr
            state["trace"].copy_(torch.where(skip, state["trace"], tr))
        if self.wd:
            u = u + self.wd * p
        p.copy_(torch.where(skip, p, p - lr * u))
        if w is not None:
            w.copy_(torch.where(skip, w, p.to(w.dtype)))
        self.advance(state, sc)


def build_optimizer(name: Optional[str], params: Dict[str, Any]
                    ) -> "tuple[FlatOptimizer, float]":
    """Return ``(optimizer, base_lr)`` for a config's optimizer subtree."""
    name = (name or "adamw").lower()
    p = dict(params or {})
    if name in _UNPORTED:
        raise NotImplementedError(
            f"optimizer {name!r} is not ported yet: ROADMAP {_UNPORTED[name]}")
    base_lr = float(p.get("lr", 1e-3))
    eps = float(p.get("eps", 1e-8))
    wd = float(p.get("weight_decay", 0.0))
    fused = is_fused_optimizer(name, p)
    if name in ("adam", "adamw", "fusedadam"):
        b1, b2 = tuple(p.get("betas", (0.9, 0.999)))
        adam_w = bool(p.get("adam_w_mode", name != "adam"))
        return Adam(name, fused, float(b1), float(b2), eps, wd,
                    adam_w), base_lr
    if name in ("lion", "fusedlion"):
        b1, b2 = tuple(p.get("betas", (0.9, 0.99)))
        return Lion(name, fused, float(b1), float(b2), wd), base_lr
    if name == "sgd":
        return SGD(name, float(p.get("momentum", 0.0)),
                   bool(p.get("nesterov", False)), wd), base_lr
    raise ValueError(f"Unknown optimizer type {name!r}")
