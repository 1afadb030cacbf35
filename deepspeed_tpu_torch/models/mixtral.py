"""Mixtral model family (sparse-MoE Llama) as PyTorch modules.

Counterpart of ``deepspeed_tpu/models/mixtral.py``: the Llama attention,
norm and rotary stack of :mod:`~deepspeed_tpu_torch.models.llama` with the
dense MLP swapped for the routed :class:`~deepspeed_tpu_torch.moe.MoE`
layer under the flax name ``block_sparse_moe``.  The model returns
``(hidden, aux / L)`` and the causal LM ``(logits, aux)``, where ``aux``
sums the layers' load-balancing losses; the serving engines keep the
logits (``inference/common.py::logits_of``).  The blocks route with
``capacity_factor`` when they serve too, as the JAX blocks do.  The
LM-loss wrapper comes with MoE training (ROADMAP A11).
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from deepspeed_tpu_torch.inference.paged import RaggedMeta
from deepspeed_tpu_torch.models.llama import (LlamaAttention, LlamaConfig,
                                              LlamaForCausalLM, LlamaModel,
                                              RMSNorm)
from deepspeed_tpu_torch.moe.layer import MoE


@dataclasses.dataclass(frozen=True)
class MixtralConfig(LlamaConfig):
    num_local_experts: int = 8
    num_experts_per_tok: int = 2
    capacity_factor: float = 1.25
    min_capacity: int = 4
    drop_tokens: bool = True
    # "auto" is "sorted" on one device; "alltoall" raises (ROADMAP A11)
    dispatch_impl: str = "auto"


PRESETS = {
    "mixtral-8x7b": dict(hidden_size=4096, intermediate_size=14336,
                         num_hidden_layers=32, num_attention_heads=32,
                         num_key_value_heads=8, vocab_size=32000,
                         num_local_experts=8, num_experts_per_tok=2,
                         rope_theta=1e6, max_position_embeddings=32768),
    "tinymixtral": dict(vocab_size=256, hidden_size=64, intermediate_size=128,
                        num_hidden_layers=2, num_attention_heads=4,
                        num_key_value_heads=2, max_position_embeddings=64,
                        num_local_experts=4, num_experts_per_tok=2),
}


def get_config(preset: str, **overrides) -> MixtralConfig:
    kw = dict(PRESETS[preset])
    kw.update(overrides)
    return MixtralConfig(**kw)


def make_moe(cfg: MixtralConfig, intermediate_size: int,
             normalize_weights: bool = True) -> MoE:
    """The family's routed FFN (``_moe`` of the flax model)."""
    return MoE(hidden_size=cfg.hidden_size,
               num_experts=cfg.num_local_experts,
               intermediate_size=intermediate_size,
               k=cfg.num_experts_per_tok,
               capacity_factor=cfg.capacity_factor,
               min_capacity=cfg.min_capacity, drop_tokens=cfg.drop_tokens,
               activation="swiglu", param_dtype=cfg.param_dtype,
               normalize_weights=normalize_weights,
               dispatch_impl=cfg.dispatch_impl)


class MixtralBlock(nn.Module):
    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        E, eps, pd = cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype
        self.input_layernorm = RMSNorm(E, eps, pd)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(E, eps, pd)
        self.block_sparse_moe = make_moe(cfg, cfg.intermediate_size)

    def forward(self, x, positions, rope, kv_cache=None, ragged_meta=None):
        """``(x, l_aux)``."""
        x = x + self.self_attn(self.input_layernorm(x), positions, rope,
                               kv_cache, ragged_meta)
        y, l_aux = self.block_sparse_moe(self.post_attention_layernorm(x))
        return x + y, l_aux


class MixtralModel(LlamaModel):
    """Returns ``(hidden, mean per-layer aux loss)``."""

    block_cls = MixtralBlock

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[List] = None,
                ragged_meta: Optional[RaggedMeta] = None):
        S = input_ids.shape[1]
        if positions is None:
            positions = torch.arange(S, device=input_ids.device)
        rope = self.rope(positions)
        x = self.embed_tokens(input_ids)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i, layer in enumerate(self.layers):
            x, l_aux = layer(x, positions, rope,
                             None if kv_cache is None else kv_cache[i],
                             ragged_meta)
            aux = aux + l_aux
        return self.norm(x), aux / len(self.layers)


class MixtralForCausalLM(nn.Module):
    """``forward`` returns ``(logits, aux)``."""

    model_cls = MixtralModel

    def __init__(self, cfg: MixtralConfig):
        super().__init__()
        if cfg.weight_quant != "none":
            raise ValueError(
                f"weight_quant={cfg.weight_quant!r}: an MoE model has no "
                "native w8a8 layers (its expert banks are no Linear, and "
                "no JAX engine serves a natively consumed w8a8 MoE); serve "
                "it with v1's quant.qtype='w8a8', which dequantizes, or "
                "weight-only int8, fp8 or fp6 in either engine")
        self.config = cfg
        self.model = self.model_cls(cfg)
        self.lm_head = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False,
                                 dtype=cfg.param_dtype)

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[List] = None,
                ragged_meta: Optional[RaggedMeta] = None,
                logit_rows: Optional[torch.Tensor] = None):
        """``(logits [B, S, V], aux)`` for ``input_ids [B, S]``; with
        ``logit_rows`` (a ``[1, T]`` ragged batch) only those rows reach
        the LM head, as in ``LlamaForCausalLM``.  Every row is routed."""
        h, aux = self.model(input_ids, positions, kv_cache, ragged_meta)
        if logit_rows is not None:
            h = h[0, logit_rows]
        return self.lm_head(h), aux

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Random weights drawn from ``generator`` in place, module by
        module in ``modules()`` order (:meth:`init_module_weights`)."""
        for mod in self.modules():
            self.init_module_weights(mod, generator)

    @staticmethod
    @torch.no_grad()
    def init_module_weights(mod: nn.Module,
                            generator: torch.Generator) -> None:
        """``LlamaForCausalLM.init_module_weights``, and the router and
        expert banks of an ``MoE`` (:meth:`MoE.init_weights`)."""
        if isinstance(mod, MoE):
            mod.init_weights(generator)
        else:
            LlamaForCausalLM.init_module_weights(mod, generator)


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def flops_per_token(cfg: MixtralConfig,
                    seq_len: Optional[int] = None) -> float:
    """Forward+backward FLOPs per token counting only the active
    parameters (top-k experts): a copy of the JAX family's."""
    E, I, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers
    Dh, H, Hkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    per_layer = (E * H * Dh + 2 * E * Hkv * Dh + H * Dh * E
                 + cfg.num_experts_per_tok * 3 * E * I)
    n = L * per_layer + cfg.vocab_size * E
    s = seq_len or cfg.max_position_embeddings
    attn = 12 * L * H * Dh * s
    return 6.0 * n + attn
