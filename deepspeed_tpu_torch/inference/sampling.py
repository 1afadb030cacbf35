"""Token sampling for the generate loop.

Counterpart of ``sample_logits`` in ``deepspeed_tpu/inference/sampling.py``:
greedy argmax, temperature, top-k threshold and top-p ("mass before < p")
filters with the same rules, drawing from an explicit ``torch.Generator``
where the reference takes a JAX PRNG key.  The two frameworks' random
streams differ, so sampled tokens agree in distribution, not bit for bit.

The ragged v2 engine samples a continuous batch with per-row settings on
the device (:func:`filter_logits_batched`, :func:`sample_logits_batched`).
Its draws are position-keyed, the invariant the reference gets from
``position_keys``: JAX's threefry streams cannot be reproduced in torch,
so a row draws by Gumbel-max over its filtered logits, with noise from a
counter-based integer hash of (engine seed, request uid, cache position,
token id) computed in int64 tensor ops on the logits' device.  With no
generator state, the token drawn for (uid, position) is the same whatever
else is batched, and whether a fused tick or a decode block draws it.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

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


def filter_logits_batched(logits: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor
                          ) -> torch.Tensor:
    """Per-row temperature/top-k/top-p filter over [S, V] float32 logits
    (reference ``filter_logits_batched``): kept entries scaled by
    temperature, filtered entries at ``-inf``.  ``top_k <= 0`` and
    ``top_p >= 1`` disable their filters per row; top-p applies to the
    top-k-filtered distribution."""
    S, V = logits.shape
    lg = logits.float() / temperature.float().clamp_min(1e-6)[:, None]
    k = torch.where(top_k > 0, top_k.clamp(max=V), V).long()
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    kth = torch.gather(sorted_lg, 1, (k - 1)[:, None])
    lg = lg.masked_fill(lg < kth, -torch.inf)
    sorted_lg = torch.sort(lg, dim=-1, descending=True).values
    probs = torch.softmax(sorted_lg, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < top_p.float().clamp(0.0, 1.0)[:, None]
    kth_idx = (keep.sum(dim=-1, keepdim=True) - 1).clamp_min(0)
    cutoff = torch.gather(sorted_lg, 1, kth_idx)
    return lg.masked_fill(lg < cutoff, -torch.inf)


def _i64(c: int) -> int:
    """A 64-bit constant as the int64 with the same bits."""
    return c - (1 << 64) if c >= 1 << 63 else c


_GOLDEN = _i64(0x9E3779B97F4A7C15)
_MIX1 = _i64(0xBF58476D1CE4E5B9)
_MIX2 = _i64(0x94D049BB133111EB)


def _srl(x: torch.Tensor, s: int) -> torch.Tensor:
    """Logical right shift of int64 bits."""
    return (x >> s) & ((1 << (64 - s)) - 1)


def _mix64(x: torch.Tensor) -> torch.Tensor:
    """splitmix64's finalizer on int64 tensors (products wrap mod 2^64)."""
    x = (x ^ _srl(x, 30)) * _MIX1
    x = (x ^ _srl(x, 27)) * _MIX2
    return x ^ _srl(x, 31)


def position_keys(seed: int, uids: torch.Tensor,
                  positions: torch.Tensor) -> torch.Tensor:
    """Per-row int64 keys [S] for scheduling-invariant sampling: a pure
    function of (engine ``seed``, request uid, cache position), the
    counterpart of the reference's ``position_keys``."""
    base = int(_mix64(torch.tensor([seed * 2 + 1], dtype=torch.int64)))
    x = _mix64(uids.long() * _GOLDEN + base)
    return _mix64(x + positions.long() * _MIX1)


def gumbel_noise(keys: torch.Tensor, vocab: int) -> torch.Tensor:
    """Gumbel(0, 1) noise [S, vocab] in fp32 from per-row keys: the hash
    of (key, token id) gives 24 uniform bits, u in (0, 1), and
    -log(-log(u))."""
    ids = torch.arange(vocab, device=keys.device, dtype=torch.int64)
    h = _mix64(keys[:, None] + ids[None, :] * _GOLDEN)
    u = (_srl(h, 40).float() + 0.5) * float(np.float32(2.0 ** -24))
    return -torch.log(-torch.log(u))


def sample_logits_batched(logits: torch.Tensor,
                          keys: Optional[torch.Tensor],
                          do_sample: torch.Tensor, temperature: torch.Tensor,
                          top_k: torch.Tensor, top_p: torch.Tensor
                          ) -> torch.Tensor:
    """Per-ROW sampling on the device (reference
    ``sample_logits_batched``): next token ids [S] (int64) from logits
    [S, V], with ``do_sample``/``temperature``/``top_k``/``top_p`` as [S]
    tensors.  ``keys=None`` is the pure-greedy path (no sort); otherwise
    ``keys`` [S] from :func:`position_keys` and sampled rows draw
    ``argmax(filtered + Gumbel noise)``, which is a draw from softmax of
    the filtered logits."""
    logits = logits.float()
    greedy = logits.argmax(dim=-1)
    if keys is None:
        return greedy
    lg = filter_logits_batched(logits, temperature, top_k, top_p)
    sampled = (lg + gumbel_noise(keys, lg.shape[-1])).argmax(dim=-1)
    return torch.where(do_sample, sampled, greedy)
