"""Token sampling for the generate loop.

Counterpart of ``sample_logits`` in ``deepspeed_tpu/inference/sampling.py``:
greedy argmax, temperature, top-k threshold and top-p ("mass before < p")
filters with the same rules, drawing from an explicit ``torch.Generator``
where the reference takes a JAX PRNG key.  The two frameworks' random
streams differ, so sampled tokens agree in distribution, not bit for bit.
The position-keyed and per-row batched variants come with the ragged v2
engine.
"""
from __future__ import annotations

from typing import Optional

import torch


def filter_logits(logits: torch.Tensor, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """The filter half of :func:`sample_logits` over fp32 logits [B, V]:
    kept entries scaled by temperature, filtered entries at ``-inf``."""
    logits = logits.float()
    if temperature != 1.0:
        logits = logits / max(temperature, 1e-6)
    if top_k and top_k > 0:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]    # [B, 1]
        logits = logits.masked_fill(logits < kth, -torch.inf)
    if top_p < 1.0:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # keep tokens while the mass BEFORE them is < top_p (always >=1 kept)
        keep_sorted = (cum - probs) < top_p
        kth_idx = keep_sorted.sum(dim=-1, keepdim=True) - 1
        cutoff = torch.gather(sorted_logits, -1, kth_idx)
        logits = logits.masked_fill(logits < cutoff, -torch.inf)
    return logits


def sample_logits(logits: torch.Tensor,
                  generator: Optional[torch.Generator] = None, *,
                  do_sample: bool = False, temperature: float = 1.0,
                  top_k: int = 0, top_p: float = 1.0) -> torch.Tensor:
    """Next token ids [B] (int64) from logits [B, V].  ``generator`` lives
    on the logits' device and is needed only when ``do_sample``."""
    if not do_sample:
        return logits.float().argmax(dim=-1)
    if generator is None:
        raise ValueError("sampling needs a torch.Generator")
    probs = torch.softmax(filter_logits(logits, temperature, top_k, top_p),
                          dim=-1)
    return torch.multinomial(probs, 1, generator=generator).squeeze(-1)
