"""Mixture-of-Experts layer.

Counterpart of ``deepspeed_tpu/moe/layer.py`` (the reference
``deepspeed/moe/layer.py:17 MoE``, ``sharded_moe.py:533 MOELayer``,
``TopKGate:449``): the experts are stacked parameters ``[E, ...]`` in the
flax layout, so the expert FFN is ``torch.bmm`` over the ``[E, C, M]``
dispatched buffers, as the JAX layer's einsums are.

One device only: the layer serves the sorted gathers, which
``dispatch_impl="auto"`` resolves to.  The einsum and gather dispatches
of :mod:`~deepspeed_tpu_torch.moe.sharded_moe` are parity oracles for the
tests, not serving paths, so the layer refuses them.  The multi-device
``"alltoall"`` dispatch and the ``"Jitter"`` noisy gate belong to expert
parallelism and MoE training and raise naming ROADMAP A11.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.moe.sharded_moe import (routing_plan,
                                                 sorted_combine,
                                                 sorted_dispatch, topkgating)


class MoE(nn.Module):
    """Top-k routed MoE FFN: gate -> dispatch -> experts -> combine.

    ``forward(x)`` returns ``(y, l_aux)``.  The router ``gate [M, E]`` is
    built in fp32 and the logits are ``x.float() @ gate``; the expert
    banks (``swiglu``: ``w1``/``w3 [E, M, I]``, ``w2 [E, I, M]``;
    ``gelu`` adds ``b1 [E, I]``, ``b2 [E, M]``) are built in
    ``param_dtype`` and the FFN computes in their dtype.  An engine that
    casts the model to a serving dtype casts the router too unless it
    keeps the parameters :attr:`fp32_params` names, as the JAX v2 engine
    (which casts nothing) does.  A serving engine may swap the banks for
    quantized ones (:attr:`banks`), each expanded whole at every call
    (:meth:`bank`); ``b1``/``b2`` stay full precision, as in the JAX
    package.
    """

    # parameters a serving engine may keep in fp32 when it casts the rest
    fp32_params = ("gate",)

    def __init__(self, hidden_size: int, num_experts: int,
                 intermediate_size: int, k: int = 2,
                 capacity_factor: float = 1.25, min_capacity: int = 4,
                 drop_tokens: bool = True, activation: str = "swiglu",
                 param_dtype: torch.dtype = torch.float32,
                 noisy_gate_policy: Optional[str] = None,
                 normalize_weights: bool = True,
                 dispatch_impl: str = "auto"):
        super().__init__()
        if noisy_gate_policy is not None:
            raise NotImplementedError(
                f"noisy_gate_policy={noisy_gate_policy!r} is not ported "
                "yet: the jittered router serves MoE training, ROADMAP A11 "
                "(MoE training with expert parallelism)")
        if dispatch_impl == "alltoall":
            raise NotImplementedError(
                "dispatch_impl='alltoall' is not ported yet: it is the "
                "multi-device expert-parallel dispatch, ROADMAP A11 (MoE "
                "training with expert parallelism)")
        if dispatch_impl in ("einsum", "gather"):
            raise ValueError(
                f"dispatch_impl={dispatch_impl!r} is a parity oracle in "
                "moe/sharded_moe.py, not a serving path: the layer serves "
                "'sorted' (what 'auto' gives on one device)")
        if dispatch_impl not in ("auto", "sorted"):
            raise ValueError(f"unknown dispatch_impl {dispatch_impl!r}")
        if activation not in ("swiglu", "gelu"):
            raise ValueError(f"unknown MoE activation {activation!r}")
        self.hidden_size = M = hidden_size
        self.num_experts = E = num_experts
        self.intermediate_size = I = intermediate_size
        self.k = k
        self.capacity_factor = capacity_factor
        self.min_capacity = min_capacity
        self.drop_tokens = drop_tokens
        self.activation = activation
        self.normalize_weights = normalize_weights
        kw = dict(dtype=param_dtype)
        self.gate = nn.Parameter(torch.empty(M, E, dtype=torch.float32))
        self.w1 = nn.Parameter(torch.empty(E, M, I, **kw))
        if activation == "swiglu":
            self.w3 = nn.Parameter(torch.empty(E, M, I, **kw))
        else:
            self.b1 = nn.Parameter(torch.empty(E, I, **kw))
        self.w2 = nn.Parameter(torch.empty(E, I, M, **kw))
        if activation == "gelu":
            self.b2 = nn.Parameter(torch.empty(E, M, **kw))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights in place from ``generator``, in the dtype and
        on the device the parameters have: N(0, 1/fan_in) for the router
        and the banks (the port's stand-in for flax's ``lecun_normal``,
        as for every Linear), with the expert as the banks' batch axis
        (fan-in ``M`` for ``w1``/``w3``, ``I`` for ``w2``); biases 0."""
        for name, p in self.named_parameters(recurse=False):
            if name.startswith("b"):
                p.zero_()
            else:
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[-2]),
                          generator=generator)

    @property
    def banks(self) -> Tuple[str, ...]:
        """The names of this layer's expert banks, the matmul weights a
        serving engine may quantize (``w3`` for swiglu only)."""
        return ("w1", "w3", "w2") if self.activation == "swiglu" \
            else ("w1", "w2")

    def bank(self, name: str) -> torch.Tensor:
        """Expert bank ``name`` in full precision: the parameter, or a
        quantized bank expanded whole (one kernel launch on the card)."""
        w = getattr(self, name)
        return w if isinstance(w, torch.Tensor) else w.dequantized()

    def _expert_ffn(self, disp: torch.Tensor) -> torch.Tensor:
        """[E, C, M] dispatched tokens -> [E, C, M] expert outputs."""
        if self.activation == "swiglu":
            h = torch.bmm(disp, self.bank("w1"))
            return torch.bmm(F.silu(h) * torch.bmm(disp, self.bank("w3")),
                             self.bank("w2"))
        h = F.gelu(torch.bmm(disp, self.bank("w1")) + self.b1[:, None],
                   approximate="tanh")
        return torch.bmm(h, self.bank("w2")) + self.b2[:, None]

    def gating(self, x: torch.Tensor):
        """The :class:`~deepspeed_tpu_torch.moe.sharded_moe.GatingResult`
        for tokens ``x [G, M]``."""
        logits = x.float() @ self.gate.float()                  # [G, E]
        return topkgating(
            logits, k=self.k, capacity_factor=self.capacity_factor,
            min_capacity=self.min_capacity, drop_tokens=self.drop_tokens,
            normalize_weights=self.normalize_weights)

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Routes with ``capacity_factor`` always: the JAX layer's
        ``eval_capacity_factor`` takes effect only where a caller passes
        ``is_training=False``, and none of the JAX blocks does, whether it
        trains or serves."""
        shape = x.shape
        x = x.reshape(-1, self.hidden_size)                      # [G, M]
        gr = self.gating(x)
        plan = routing_plan(gr)
        # a quantized bank's dtype is the one it expands to
        out = self._expert_ffn(sorted_dispatch(x.to(self.w1.dtype),
                                               plan.slot_token))
        y = sorted_combine(out, gr.weights, plan.slot_of_copy)
        return y.reshape(shape), gr.l_aux


def is_moe(module: nn.Module) -> bool:
    """True when ``module`` holds an :class:`MoE` layer."""
    return any(isinstance(m, MoE) for m in module.modules())
