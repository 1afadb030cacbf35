"""MoE gating and dispatch math.

Counterpart of ``deepspeed_tpu/moe/sharded_moe.py`` (itself a re-design of
the reference ``deepspeed/moe/sharded_moe.py``: ``top1gating:183``,
``top2gating:290``, ``topkgating:374``, ``_capacity:161``): top-k gating
with a static per-expert capacity, and three ways to move tokens into
``[E, C, M]`` expert buffers and back, which give the same result:

- ``moe_dispatch`` / ``moe_combine``: the dense one-hot einsums, the
  parity oracle;
- ``moe_dispatch_gather`` / ``moe_combine_gather``: a row scatter and a
  row gather over the flat slot of each routed copy;
- ``sorted_dispatch`` / ``sorted_combine`` over a :class:`RoutingPlan`:
  expert-sorted row gathers (two stable sorts), linear in the token
  count, the serving path.

Plain torch throughout.  Slot arithmetic is integer, and nothing reads a
device value on the host: the capacity ``C`` is a Python int from the
static token count, so a CUDA graph captures the whole layer.  The dense
``combine`` / ``dispatch`` tensors are built on first use only (the JAX
package leaves them to XLA's dead-code elimination).  Gradients flow
through plain indexing; the JAX package's custom VJPs serve training and
come with it (ROADMAP A11, MoE training).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import torch


@dataclasses.dataclass
class GatingResult:
    """What :func:`topkgating` decides for ``G`` tokens over ``E``
    experts, with per-expert capacity ``capacity``: per choice ``k`` and
    token ``g``, the selected expert (``experts [k, G]``), the copy's
    slot within that expert's buffer (``positions [k, G]``) and its
    combine weight (``weights [k, G]``, fp32, 0 where the copy was
    dropped for capacity).  ``exp_counts [E]`` counts routed copies per
    expert before drops; ``l_aux`` is the load-balancing loss."""

    l_aux: torch.Tensor
    exp_counts: torch.Tensor
    experts: torch.Tensor
    positions: torch.Tensor
    weights: torch.Tensor
    capacity: int
    num_experts: int
    _combine: Optional[torch.Tensor] = None

    @property
    def combine(self) -> torch.Tensor:
        """``[G, E, C]`` fp32 combine weights (built on first use)."""
        if self._combine is None:
            k, G = self.weights.shape
            E, C = self.num_experts, self.capacity
            combine = self.weights.new_zeros((G, E, C))
            for j in range(k):
                combine = combine + (
                    self.weights[j][:, None, None] *
                    _one_hot(self.experts[j], E).float()[:, :, None] *
                    _one_hot(self.positions[j], C).float()[:, None, :])
            self._combine = combine
        return self._combine

    @property
    def dispatch(self) -> torch.Tensor:
        """``[G, E, C]`` bool dispatch mask."""
        return self.combine > 0


def _one_hot(idx: torch.Tensor, n: int) -> torch.Tensor:
    """int64 one-hot rows of width ``n``; an index ``>= n`` gives a zero
    row (``jax.nn.one_hot``'s rule).  A comparison, so that nothing
    checks the indices on the host."""
    return (idx.long()[:, None] ==
            torch.arange(n, device=idx.device)[None, :]).long()


def capacity(num_tokens: int, num_experts: int, capacity_factor: float,
             min_capacity: int, k: int = 1) -> int:
    """Static per-expert capacity (reference ``_capacity``,
    ``sharded_moe.py:161``; scaled by k so top-k routing has room)."""
    cap = int(math.ceil(k * capacity_factor * num_tokens / num_experts))
    return max(cap, min_capacity)


def topkgating(logits: torch.Tensor, k: int = 1,
               capacity_factor: float = 1.0, min_capacity: int = 4,
               drop_tokens: bool = True,
               normalize_weights: bool = True) -> GatingResult:
    """Top-k gating with capacity-bounded dispatch, as the JAX
    ``topkgating``: experts picked by iterative argmax (ties to the
    first index), each copy's slot by a token cumsum with later choices
    placed after every earlier choice, copies past capacity dropped, the
    gates renormalised over the surviving choices when
    ``normalize_weights`` (else the raw softmax gates, Qwen2-MoE's
    ``norm_topk_prob=False``), and the switch-transformer aux loss from
    the first choice."""
    G, E = logits.shape
    gates = torch.softmax(logits.float(), dim=-1)
    remaining = logits.float()
    masks, indices = [], []
    for _ in range(k):
        idx = remaining.argmax(dim=-1)
        mask = _one_hot(idx, E)                           # [G, E]
        masks.append(mask)
        indices.append(idx)
        remaining = remaining.masked_fill(mask > 0, float("-inf"))

    # aux loss: fraction of tokens * fraction of router prob per expert
    me = gates.mean(dim=0)
    ce = masks[0].float().mean(dim=0)
    l_aux = (me * ce).sum() * E
    exp_counts = sum(m.sum(dim=0) for m in masks)

    C = capacity(G, E, capacity_factor, min_capacity, k=k) \
        if drop_tokens else G

    positions, keeps = [], []
    offset = torch.zeros((E,), dtype=torch.long, device=logits.device)
    for mask in masks:
        loc = torch.cumsum(mask, dim=0) - mask + offset[None, :]
        offset = offset + mask.sum(dim=0)
        pos = (loc * mask).sum(dim=-1)                    # [G]
        positions.append(pos)
        keeps.append((pos < C).float())

    # renormalised over the SURVIVING choices: the reference zeroes
    # dropped choices before computing the gates (top2gating,
    # sharded_moe.py:290), so the other choices absorb the full weight
    gate_k = [gates.gather(1, idx[:, None])[:, 0] for idx in indices]
    if normalize_weights:
        denom = sum(g * keep for g, keep in zip(gate_k, keeps))
        denom = torch.clamp_min(denom, torch.finfo(torch.float32).eps)
    else:
        denom = torch.ones_like(gate_k[0])
    weights = [g * keep / denom for g, keep in zip(gate_k, keeps)]
    return GatingResult(l_aux=l_aux, exp_counts=exp_counts,
                        experts=torch.stack(indices).int(),
                        positions=torch.stack(positions).int(),
                        weights=torch.stack(weights), capacity=C,
                        num_experts=E)


def top1gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               **kw) -> GatingResult:
    return topkgating(logits, k=1, capacity_factor=capacity_factor,
                      min_capacity=min_capacity, **kw)


def top2gating(logits, capacity_factor: float = 1.0, min_capacity: int = 4,
               **kw) -> GatingResult:
    return topkgating(logits, k=2, capacity_factor=capacity_factor,
                      min_capacity=min_capacity, **kw)


def moe_dispatch(x: torch.Tensor, dispatch: torch.Tensor) -> torch.Tensor:
    """[G, M] tokens -> [E, C, M] expert buffers (reference
    ``einsum("sec,sm->ecm")``)."""
    return torch.einsum("gec,gm->ecm", dispatch.to(x.dtype), x)


def moe_combine(expert_out: torch.Tensor,
                combine: torch.Tensor) -> torch.Tensor:
    """[E, C, M] expert outputs -> [G, M] tokens (reference
    ``einsum("sec,ecm->sm")``)."""
    return torch.einsum("gec,ecm->gm", combine.to(expert_out.dtype),
                        expert_out)


def _dest_slots(gr: GatingResult) -> torch.Tensor:
    """[k, G] flat destination slot per routed copy; dropped copies point
    one past the end (``E * C``)."""
    E, C = gr.num_experts, gr.capacity
    dest = gr.experts.long() * C + gr.positions.long()
    return torch.where(gr.weights > 0, dest, E * C)


def moe_dispatch_gather(x: torch.Tensor, gr: GatingResult) -> torch.Tensor:
    """[G, M] tokens -> [E, C, M] expert buffers by row scatter.  The
    surviving (expert, slot) pairs are unique across choices, so the
    scatter has no collisions but in the one row past the end where
    every dropped copy lands, which is cut off."""
    k, G = gr.weights.shape
    E, C, M = gr.num_experts, gr.capacity, x.shape[-1]
    dest = _dest_slots(gr).reshape(-1)
    xk = x[None].expand(k, G, M).reshape(k * G, M)
    buf = x.new_zeros((E * C + 1, M)).index_copy_(0, dest, xk)
    return buf[:E * C].reshape(E, C, M)


def moe_combine_gather(expert_out: torch.Tensor,
                       gr: GatingResult) -> torch.Tensor:
    """[E, C, M] expert outputs -> [G, M] by row gather and a weighted
    sum over the k choices (inverse of :func:`moe_dispatch_gather`)."""
    E, C, M = expert_out.shape
    rows = _pad_rows(expert_out.reshape(E * C, M))[_dest_slots(gr)]
    w = gr.weights.to(expert_out.dtype)[:, :, None]
    return (w * rows).sum(dim=0)


class RoutingPlan(NamedTuple):
    slot_token: torch.Tensor    # [E, C]: token filling each slot, G = empty
    slot_of_copy: torch.Tensor  # [k, G]: flat slot e*C + c, E*C = dropped


def routing_plan(gr: GatingResult) -> RoutingPlan:
    """The sorted layout of the reference's grouped GEMM
    (``cutlass_ops/moe_gemm``): copies sorted by expert, stably, so that
    within an expert they keep the choice-major, then token order the
    gating's positions count in, and capacity keeps the same copies as
    every other dispatch."""
    k, G = gr.experts.shape
    E, C = gr.num_experts, gr.capacity
    dev = gr.experts.device
    ec = gr.experts.reshape(-1).long()                # [kG] expert per copy
    sort_idx = torch.argsort(ec, stable=True)         # sorted copy ids
    inv = torch.argsort(sort_idx, stable=True)        # copy -> sorted pos
    gs = torch.zeros((E,), dtype=torch.long, device=dev).scatter_add_(
        0, ec, torch.ones_like(ec))                   # copies per expert
    off = torch.cumsum(gs, dim=0) - gs                # first sorted pos
    cpos = torch.arange(C, device=dev)[None, :]
    src_pos = off[:, None] + cpos                     # [E, C]
    tok = torch.arange(G, device=dev).repeat(k)
    tok_sorted = tok[sort_idx]
    slot_token = torch.where(
        cpos < gs[:, None],
        tok_sorted[src_pos.clamp(0, k * G - 1)], G)
    c_of_copy = inv - off[ec]
    slot_of_copy = torch.where(c_of_copy < C, ec * C + c_of_copy, E * C)
    return RoutingPlan(slot_token=slot_token,
                       slot_of_copy=slot_of_copy.reshape(k, G))


def _pad_rows(x: torch.Tensor) -> torch.Tensor:
    """Append one zero row, so that a sentinel index gathers zeros."""
    return torch.cat([x, x.new_zeros((1,) + x.shape[1:])])


def sorted_dispatch(x: torch.Tensor, slot_token: torch.Tensor
                    ) -> torch.Tensor:
    """[G, M] tokens -> [E, C, M] expert buffers by row gather."""
    E, C = slot_token.shape
    return _pad_rows(x)[slot_token.reshape(-1)].reshape(E, C, x.shape[-1])


def sorted_combine(expert_out: torch.Tensor, weights: torch.Tensor,
                   slot_of_copy: torch.Tensor) -> torch.Tensor:
    """[E, C, M] expert outputs -> [G, M]: each copy's row gathered,
    summed over the k choices with the gating's combine weights (0 for
    dropped copies)."""
    E, C, M = expert_out.shape
    rows = _pad_rows(expert_out.reshape(E * C, M))[
        slot_of_copy.reshape(-1)].reshape(slot_of_copy.shape + (M,))
    return (weights.to(expert_out.dtype)[..., None] * rows).sum(dim=0)
