"""KV cache for autoregressive decode.

Counterpart of ``deepspeed_tpu/inference/kv_cache.py``.  One
:class:`KVCache` per attention layer holds the K and V buffers in the
reference's TIME-MAJOR layout ``[max_len, B, Hkv, Dh]``, so the port and
the reference compare like with like.  JAX arrays are immutable, so the
reference threads a fresh buffer through every step and relies on XLA to
alias it; here the buffers are preallocated once per ``generate`` and each
call writes its tokens into them in place.

A cache made ``fixed`` serves a static-shape decode step, the shape a
CUDA graph can capture: a one-token call writes its K/V row at a
position given as a device tensor (``index_copy_``) and attends over the
whole buffer, masked by position in :func:`cached_attention`, as the
reference's scan over its fixed-size cache does.  No host integer moves,
so one captured step replays at every position.

Dense rectangular batches only (every sequence shares one length); the
ragged v2 engine's paged cache comes with its own port.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch


class KVCache:
    """One layer's preallocated K/V buffers and its write offset."""

    def __init__(self, max_len: int, batch: int, kv_heads: int,
                 head_dim: int, dtype: torch.dtype, device: torch.device,
                 fixed: bool = False):
        shape = (max_len, batch, kv_heads, head_dim)
        self.key = torch.zeros(shape, dtype=dtype, device=device)
        self.value = torch.zeros(shape, dtype=dtype, device=device)
        self.index = 0          # tokens cached so far (a host integer)
        self.fixed = fixed

    def update(self, k: torch.Tensor, v: torch.Tensor,
               positions: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Write this call's K/V ``[B, Hkv, S, Dh]`` at the current offset.

        Returns ``(k_full, v_full)``: views of the buffers over the slots
        written so far (the reference returns the whole ``max_len`` buffer
        and masks the tail; those slots contribute nothing either way).
        A ``fixed`` cache writes a one-token call at ``positions`` (a
        device tensor of one position) instead and returns the whole
        buffers; its host offset stays where the prefill left it."""
        S = k.shape[2]
        if self.fixed and S == 1:
            at = positions.reshape(-1)[:1].long()
            self.key.index_copy_(0, at, k.permute(2, 0, 1, 3))
            self.value.index_copy_(0, at, v.permute(2, 0, 1, 3))
            return self.key, self.value
        start = self.index
        if start + S > self.key.shape[0]:
            raise ValueError(
                f"{start} cached + {S} new tokens exceed the "
                f"{self.key.shape[0]}-slot cache")
        self.key[start:start + S].copy_(k.permute(2, 0, 1, 3))
        self.value[start:start + S].copy_(v.permute(2, 0, 1, 3))
        self.index = start + S
        return self.key[:self.index], self.value[:self.index]


def init_cache(num_layers: int, max_len: int, batch: int, kv_heads: int,
               head_dim: int, dtype: torch.dtype,
               device: torch.device, fixed: bool = False) -> List[KVCache]:
    """One zeroed :class:`KVCache` per layer (``fixed``: see
    :class:`KVCache`)."""
    return [KVCache(max_len, batch, kv_heads, head_dim, dtype, device,
                    fixed)
            for _ in range(num_layers)]


def cached_attention(q: torch.Tensor, k_full: torch.Tensor,
                     v_full: torch.Tensor, q_positions: torch.Tensor,
                     window: Optional[int] = None) -> torch.Tensor:
    """Attention of ``q`` [B, H, S, Dh] against the TIME-MAJOR cache
    buffers [L, B, Hkv, Dh], masking key slots beyond each query's
    absolute position.  ``q_positions``: [S] or [B, S] absolute positions.
    ``window``: Mistral-style sliding window — key slots more than
    ``window-1`` behind the query are masked too.  Scores scale by
    1/sqrt(Dh).

    As in the reference: the scores are masked in fp32 with -1e30, and the
    probabilities are cast to the value dtype before the PV product
    (greedy parity depends on both).  GQA groups the q heads over their
    shared KV head instead of repeating the cache."""
    B, H, S, Dh = q.shape
    L, Hkv = k_full.shape[0], k_full.shape[2]
    G = H // Hkv
    scale = 1.0 / math.sqrt(Dh)
    qg = q.reshape(B, Hkv, G, S, Dh)
    # the scale multiplies in fp32, as the reference's numpy-scalar product
    # promotes its scores
    att = torch.einsum("bgrsd,lbgd->bgrsl", qg, k_full).float() * scale
    qpos = q_positions if q_positions.dim() == 2 else q_positions[None]
    qpos = qpos[:, None, None, :, None]                # [B|1, 1, 1, S, 1]
    kpos = torch.arange(L, device=q.device)
    mask = kpos <= qpos
    if window is not None:
        mask = mask & (kpos > qpos - window)
    att = att.masked_fill(~mask, -1e30)
    p = torch.softmax(att, dim=-1).to(v_full.dtype)
    y = torch.einsum("bgrsl,lbgd->bgrsd", p, v_full)
    return y.reshape(B, H, S, Dh)
