"""Llama model family as PyTorch modules.

Counterpart of ``deepspeed_tpu/models/llama.py``: RMSNorm, rotary position
embeddings (split halves, fp32 angles), grouped-query attention, SwiGLU
MLP, untied LM head, and the family knobs shared with Mistral, Qwen2 and
Phi (sliding window, q/k/v biases, out-projection bias, partial rotary).

Module and parameter names follow the flax tree, so
``module_inject/flax_bridge.py`` maps one onto the other by rule.  Layers
are always unrolled (an ``nn.ModuleList``); the model computes in the
dtype of its weights, which ``init_inference`` sets to the serving dtype.
A KV cache is passed explicitly (``kv_cache=``, one per layer) where the
flax model threads a mutable ``"cache"`` collection: a ``KVCache`` for the
v1 engine, or a ``PagedKVPool`` together with the tick's ``RaggedMeta``
(``ragged_meta=``) for the ragged v2 engine, whose token batch is
``[1, T]`` with per-token positions ``[1, T]``.  Quantized serving (int8,
fp8, fp6, w8a8) swaps the projections, ``embed_tokens`` and ``lm_head`` in
place for the quantized modules of ``inference/quantization.py``, which
take the same calls, so the forward is one path for every weight format.
``weight_quant="w8a8"`` marks a config whose Linears consume w8a8 weights
natively (``W8A8Linear``): native w8a8 quantization sets it, and the
first forward refuses a model with no such Linear;
``LlamaForCausalLM.w8a8_native`` says the class can.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from deepspeed_tpu_torch.inference.kv_cache import KVCache, cached_attention
from deepspeed_tpu_torch.inference.paged import (KV_CACHE_DTYPES,
                                                 PagedKVPool, RaggedMeta,
                                                 staged_attend_stats)
from deepspeed_tpu_torch.models.gpt2 import (next_token_loss, remat_call,
                                             remat_policy_fn)
from deepspeed_tpu_torch.ops.flash_attention import (flash_attention,
                                                     mha_reference)
from deepspeed_tpu_torch.ops.ragged_paged_attention import (
    ragged_paged_attention, ragged_paged_attention_quant)


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    """Same fields as the flax ``LlamaConfig``, so one converts to the other
    field for field.  ``dtype``/``param_dtype`` are torch dtypes; modules
    are built in ``param_dtype`` and compute in their weights' dtype.
    ``remat`` checkpoints every block under autograd with
    ``remat_policy`` (``models/gpt2.py::remat_policy_fn``; "none" turns it
    off).
    ``scan_layers``, ``decode``, ``pipeline_microbatches`` and the
    paged-cache fields (``paged_decode``, ``kv_page_size``,
    ``kv_num_pages``, ``kv_cache_dtype``, set by the v2 engine) change
    nothing in the modules here (layers are always unrolled, and the cache
    is an argument).  Knobs of paths not ported yet raise."""

    vocab_size: int = 32000
    max_position_embeddings: int = 4096
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: int = 32          # < heads => GQA
    rms_norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"
    use_flash_attention: bool = True
    tensor_parallel: bool = False
    sequence_parallel: str = "none"
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    decode: bool = False
    ragged_decode: bool = False
    max_cache_len: int = 0
    paged_decode: bool = False
    kv_page_size: int = 64
    kv_num_pages: int = 0
    kv_cache_dtype: str = "none"
    attention_bias: bool = False
    sliding_window: Optional[int] = None
    attention_out_bias: bool = False
    partial_rotary_factor: float = 1.0
    weight_quant: str = "none"

    def __post_init__(self):
        if self.sequence_parallel not in ("none", "ulysses", "ring"):
            raise ValueError(
                f"sequence_parallel={self.sequence_parallel!r}: expected "
                "'none', 'ulysses' or 'ring'")
        unported = {
            "sequence_parallel": (self.sequence_parallel != "none",
                                  "ROADMAP A11 (sequence/)"),
            "pipeline_stages": (self.pipeline_stages > 1,
                                "ROADMAP A11 (parallel/pipeline.py)"),
            "tensor_parallel": (self.tensor_parallel,
                                "ROADMAP A7a (tensor-parallel serving)"),
            "ragged_decode": (self.ragged_decode,
                              "ROADMAP A12 (the slot-row ragged cache; the "
                              "v2 engine uses paged_decode)"),
        }
        if self.weight_quant not in ("none", "w8a8"):
            raise ValueError(f"weight_quant must be 'none' or 'w8a8', got "
                             f"{self.weight_quant!r}")
        if self.kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of "
                             f"{KV_CACHE_DTYPES}, got "
                             f"{self.kv_cache_dtype!r}")
        if self.remat_policy != "none":
            remat_policy_fn(self.remat_policy)
        for name, (is_set, item) in unported.items():
            if is_set:
                raise NotImplementedError(
                    f"LlamaConfig.{name}={getattr(self, name)!r} is not "
                    f"ported yet: {item}")

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @property
    def kv_cache_shape(self):
        """(layers, KV heads, head dim) of the v1 engine's KV cache."""
        return (self.num_hidden_layers, self.num_key_value_heads,
                self.head_dim)


PRESETS = {
    "llama2-7b": dict(hidden_size=4096, intermediate_size=11008,
                      num_hidden_layers=32, num_attention_heads=32,
                      num_key_value_heads=32),
    "llama2-13b": dict(hidden_size=5120, intermediate_size=13824,
                       num_hidden_layers=40, num_attention_heads=40,
                       num_key_value_heads=40),
    "llama2-70b": dict(hidden_size=8192, intermediate_size=28672,
                       num_hidden_layers=80, num_attention_heads=64,
                       num_key_value_heads=8),
    "llama3-8b": dict(vocab_size=128256, hidden_size=4096,
                      intermediate_size=14336, num_hidden_layers=32,
                      num_attention_heads=32, num_key_value_heads=8,
                      rope_theta=500000.0, max_position_embeddings=8192),
    # TinyLlama-1.1B shape
    "llama-1b": dict(hidden_size=2048, intermediate_size=5632,
                     num_hidden_layers=22, num_attention_heads=32,
                     num_key_value_heads=4),
    "tinyllama": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                      num_hidden_layers=2, num_attention_heads=4,
                      num_key_value_heads=2, max_position_embeddings=64),
}


def get_config(preset: str, **overrides) -> LlamaConfig:
    kw = dict(PRESETS[preset])
    kw.update(overrides)
    return LlamaConfig(**kw)


class RMSNorm(nn.Module):
    """RMS normalisation in fp32; the output takes the weight's dtype."""

    def __init__(self, dim: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(var + self.eps)
        return (y * self.weight.float()).to(self.weight.dtype)


@functools.lru_cache(maxsize=None)
def _inv_freq(dim: int, theta: float, device: torch.device) -> torch.Tensor:
    # computed in numpy float32 exactly as the flax model does
    inv = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float32) / dim))
    return torch.from_numpy(inv).to(device)


def rope_angles(positions: torch.Tensor, dim: int,
                theta: float) -> torch.Tensor:
    """fp32 rotary angles ``[..., S, dim/2]`` for ``positions`` [S] or
    [B, S]."""
    return positions.float()[..., None] * _inv_freq(dim, float(theta),
                                                    positions.device)


def apply_rotary(x: torch.Tensor, cos: torch.Tensor,
                 sin: torch.Tensor) -> torch.Tensor:
    """Rotate split halves of the last dim (not interleaved pairs) in
    fp32; ``cos``/``sin`` broadcast against ``x[..., :D/2]``."""
    x1, x2 = x.float().chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def rotary_embedding(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """Apply RoPE.  x: [B, H, S, D] (D even); positions: [S] or [B, S]."""
    angles = rope_angles(positions, x.shape[-1], theta)
    # [S, D/2] broadcasts over B, H; [B, S, D/2] over H
    angles = angles[None, None] if angles.dim() == 2 else angles[:, None]
    return apply_rotary(x, angles.cos(), angles.sin())


class LlamaAttention(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        H, Hkv, Dh, E = (cfg.num_attention_heads, cfg.num_key_value_heads,
                         cfg.head_dim, cfg.hidden_size)
        kw = dict(dtype=cfg.param_dtype)
        # Qwen2: biases on q/k/v only; Phi: a bias on o_proj
        self.q_proj = nn.Linear(E, H * Dh, bias=cfg.attention_bias, **kw)
        self.k_proj = nn.Linear(E, Hkv * Dh, bias=cfg.attention_bias, **kw)
        self.v_proj = nn.Linear(E, Hkv * Dh, bias=cfg.attention_bias, **kw)
        self.o_proj = nn.Linear(H * Dh, E, bias=cfg.attention_out_bias, **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                rope: Tuple[torch.Tensor, torch.Tensor],
                kv_cache: Optional[KVCache] = None,
                ragged_meta: Optional[RaggedMeta] = None) -> torch.Tensor:
        """x: [B, S, E]; ``rope``: (cos, sin) shaped to broadcast over
        [B, S, heads, rot/2].  A ``PagedKVPool`` cache takes the paged
        path: this tick's K/V rows are written into the pool, then ragged
        paged attention runs over it for all ``S`` tokens of the ``[1, S]``
        batch.  A ``ragged_meta`` with staged blocks (a layer's
        long-context chunk dispatches) returns the flash stats ``(m, l,
        acc)`` of the queries over those blocks instead, and writes
        nothing."""
        cfg = self.config
        B, S, _ = x.shape
        H, Hkv, Dh = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        cos, sin = rope
        rot = 2 * cos.shape[-1]

        def rotate(t):
            if rot >= Dh:
                return apply_rotary(t, cos, sin)
            # partial rotary (Phi family): rope the first `rot` dims
            return torch.cat([apply_rotary(t[..., :rot], cos, sin),
                              t[..., rot:]], dim=-1)

        # rotary in the projections' own [B, S, heads, Dh] layout; the
        # [B, heads, S, Dh] views below are strides only, which the flash
        # kernel reads directly
        q = rotate(self.q_proj(x).view(B, S, H, Dh))
        if ragged_meta is not None and ragged_meta.staged is not None:
            return self._paged(q[0], None, None, None, ragged_meta)
        k = rotate(self.k_proj(x).view(B, S, Hkv, Dh))
        v = self.v_proj(x).view(B, S, Hkv, Dh)
        if isinstance(kv_cache, PagedKVPool):
            y = self._paged(q[0], k[0], v[0], kv_cache, ragged_meta)
            return self.o_proj(y.reshape(B, S, H * Dh))
        q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

        if kv_cache is not None:
            k_full, v_full = kv_cache.update(k, v, positions)
            if S == 1:
                y = cached_attention(q, k_full, v_full, positions,
                                     window=cfg.sliding_window)
                return self.o_proj(y.transpose(1, 2).reshape(B, S, H * Dh))
            # full prefill: cache written above; attend within the chunk

        window = cfg.sliding_window
        if window is not None and S > window:
            # Mistral sliding window binds: causal AND within-window mask
            # through the reference attention (the kernel has no window)
            pos = torch.arange(S, device=x.device)
            keep = (pos[None, :] <= pos[:, None]) & \
                   (pos[None, :] > pos[:, None] - window)
            bias = torch.where(keep, 0.0, -1e30)[None, None]
            y = mha_reference(q, k, v, causal=False, bias=bias)
        elif cfg.use_flash_attention:
            y = flash_attention(q, k, v, causal=True)
        else:
            y = mha_reference(q, k, v, causal=True)
        return self.o_proj(y.transpose(1, 2).reshape(B, S, H * Dh))


    def _paged(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               pool: PagedKVPool, meta: Optional[RaggedMeta]
               ) -> torch.Tensor:
        """q [T, H, D], k and v [T, Hkv, D] (rotary applied): write this
        tick's rows into ``pool``, then attend over it, folding
        ``meta.carry`` in when there is one.  With ``meta.staged`` (the
        reference's ``staged_kv`` short-circuit) the queries attend each
        staged block in turn, their raw stats folded, and the stats come
        back; no pool is touched."""
        if meta is None:
            raise ValueError("a paged KV cache needs the tick's ragged_meta")
        kw = dict(sm_scale=1.0 / math.sqrt(q.shape[-1]),
                  sliding_window=self.config.sliding_window)
        st = meta.staged
        if st is not None:
            carry = None
            for kv, scales, kpos in st.blocks:
                carry = staged_attend_stats(q, kv, kpos, st.qpos,
                                            staged_scales=scales,
                                            carry=carry, **kw)
            return carry
        pool.write(k, v, meta.new_kv_dest)
        args = (meta.kv_lens, meta.page_indices, meta.cu_q_lens,
                meta.num_seqs)
        kw["carry"] = meta.carry
        if pool.quantized:
            return ragged_paged_attention_quant(q, pool.pages, pool.scales,
                                                *args, **kw)
        return ragged_paged_attention(q, pool.pages, *args, **kw)


class LlamaMLP(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        kw = dict(bias=False, dtype=cfg.param_dtype)
        E, I = cfg.hidden_size, cfg.intermediate_size
        self.gate_proj = nn.Linear(E, I, **kw)
        self.up_proj = nn.Linear(E, I, **kw)
        self.down_proj = nn.Linear(I, E, **kw)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class LlamaBlock(nn.Module):
    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        E, eps, pd = cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype
        self.input_layernorm = RMSNorm(E, eps, pd)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(E, eps, pd)
        self.mlp = LlamaMLP(cfg)

    def forward(self, x, positions, rope, kv_cache=None, ragged_meta=None):
        x = x + self.self_attn(self.input_layernorm(x), positions, rope,
                               kv_cache, ragged_meta)
        return x + self.mlp(self.post_attention_layernorm(x))

    def chunk_stats(self, x, positions, rope, ragged_meta: RaggedMeta):
        """The long-context chunk dispatches of this layer: input norm
        and q once, then the folded stats over every block of
        ``ragged_meta.staged`` (the reference's ``_ChunkScan``, which
        applies the block's own norm and attention weights, once a
        group)."""
        return self.self_attn(self.input_layernorm(x), positions, rope,
                              None, ragged_meta)


class LlamaModel(nn.Module):
    """``forward`` runs every layer; ``LongContextDriver`` runs them one
    at a time through ``embed_tokens``, :meth:`rope`, ``layers[i]`` (and
    its :meth:`LlamaBlock.chunk_stats`) and ``norm``.  ``block_cls`` is
    the layer's class (the MoE families swap it)."""

    block_cls = LlamaBlock

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.hidden_size,
                                         dtype=cfg.param_dtype)
        self.layers = nn.ModuleList(
            self.block_cls(cfg) for _ in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps,
                            cfg.param_dtype)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[List] = None,
                ragged_meta: Optional[RaggedMeta] = None) -> torch.Tensor:
        cfg = self.config
        S = input_ids.shape[1]
        if positions is None:
            positions = torch.arange(S, device=input_ids.device)
        rope = self.rope(positions)
        x = self.embed_tokens(input_ids)
        remat = (cfg.remat and cfg.remat_policy != "none"
                 and torch.is_grad_enabled() and kv_cache is None)
        for i, layer in enumerate(self.layers):
            if remat:
                # recompute the block in the backward (nn.remat of the
                # flax model): its input and what the policy saves are kept
                x = remat_call(layer, cfg.remat_policy, x, positions, rope)
            else:
                x = layer(x, positions, rope,
                          None if kv_cache is None else kv_cache[i],
                          ragged_meta)
        return self.norm(x)

    def rope(self, positions: torch.Tensor):
        """Rotary (cos, sin) of ``positions`` for every layer: [S] ->
        [1, S, 1, r/2], [B, S] -> [B, S, 1, r/2] (the [B, S, heads, Dh]
        layout)."""
        cfg = self.config
        rot = int(cfg.head_dim * cfg.partial_rotary_factor)
        angles = rope_angles(positions, min(rot, cfg.head_dim),
                             cfg.rope_theta)
        angles = angles[None, :, None] if angles.dim() == 2 \
            else angles[:, :, None]
        return angles.cos(), angles.sin()


class LlamaForCausalLM(nn.Module):
    # every Linear of this module tree may be a W8A8Linear: the v2 engine
    # keys native w8a8 serving off this class flag, as the reference's
    # engines key the int8 product path off flax's
    w8a8_native = True

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.model = LlamaModel(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype)
        self._w8a8_checked = False

    def _check_w8a8(self) -> None:
        """A ``weight_quant="w8a8"`` config consumes w8a8 weights
        natively, so its tree must hold ``W8A8Linear`` layers, as
        ``quantize_model_(..., "w8a8", native_w8a8=True)`` (the v2
        engine's ``quantize_weights="w8a8"``) leaves it; that call sets
        the field.  A Linear below the quantizer's ``min_size`` stays
        plain and runs in float, as the reference's ``w8a8_dot_general``
        passes a plain kernel through.  Checked at the first forward."""
        from ..inference.quantization import W8A8Linear

        if not any(isinstance(mod, W8A8Linear) for mod in self.modules()):
            raise ValueError(
                "weight_quant='w8a8' serves w8a8 weights natively, but no "
                "Linear of this model holds them: quantize with "
                "RaggedInferenceEngineV2(quantize_weights='w8a8'), or keep "
                "weight_quant='none'")
        self._w8a8_checked = True

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[List] = None,
                ragged_meta: Optional[RaggedMeta] = None,
                logit_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Logits [B, S, V] for ``input_ids`` [B, S].  With
        ``logit_rows`` (a ``[1, T]`` ragged batch), only those token rows
        reach the LM head: logits [len(logit_rows), V]."""
        if self.config.weight_quant == "w8a8" and not self._w8a8_checked:
            self._check_w8a8()
        h = self.model(input_ids, positions, kv_cache, ragged_meta)
        if logit_rows is not None:
            h = h[0, logit_rows]
        return self.lm_head(h)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights drawn from ``generator`` in place, in the dtype
        and on the device the parameters already have, module by module
        in ``modules()`` order (:meth:`init_module_weights`)."""
        for mod in self.modules():
            self.init_module_weights(mod, generator)

    @staticmethod
    @torch.no_grad()
    def init_module_weights(mod: nn.Module,
                            generator: torch.Generator) -> None:
        """One module's own weights: linear weights N(0, 1/fan_in),
        embeddings N(0, 1), norms 1, biases 0.  Calling it on every
        module in ``modules()`` order draws what :meth:`init_weights`
        draws, so a caller may hold one module's weights at a time."""
        if isinstance(mod, nn.Linear):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.in_features),
                               generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0, generator=generator)
        elif isinstance(mod, RMSNorm):
            mod.weight.fill_(1.0)


class LlamaLMLoss(nn.Module):
    """Loss-returning wrapper (the engine's module contract):
    ``module(batch) -> scalar`` next-token cross entropy in fp32.  The
    causal LM sits under ``lm``, as in the flax ``LlamaLMLoss``."""

    def __init__(self, cfg: LlamaConfig):
        super().__init__()
        self.config = cfg
        self.lm = LlamaForCausalLM(cfg)

    def forward(self, batch) -> torch.Tensor:
        input_ids = batch["input_ids"] if isinstance(batch, dict) else batch
        return next_token_loss(self.lm(input_ids), input_ids)

    def init_weights(self, generator: torch.Generator) -> None:
        self.lm.init_weights(generator)

    init_module_weights = staticmethod(LlamaForCausalLM.init_module_weights)


def flops_per_token(cfg: LlamaConfig, seq_len: Optional[int] = None
                    ) -> float:
    """Forward+backward FLOPs per token (PaLM convention), for MFU: a copy
    of ``deepspeed_tpu/models/llama.py::flops_per_token``."""
    E, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    Dh, H, Hkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    per_layer = (E * H * Dh + 2 * E * Hkv * Dh + H * Dh * E  # qkvo
                 + 3 * E * I)                                # gate/up/down
    n = L * per_layer + cfg.vocab_size * E                   # + lm head
    s = seq_len or cfg.max_position_embeddings
    attn = 12 * L * H * Dh * s
    return 6.0 * n + attn
