"""Qwen2-MoE model family (Qwen1.5-MoE, Qwen2-57B-A14B) as PyTorch modules.

Counterpart of ``deepspeed_tpu/models/qwen2_moe.py`` (the reference serves
the family through FastGen v2, ``model_implementations/qwen_v2_moe``):
Qwen2 attention with q/k/v biases, a routed MoE FFN under the flax name
``mlp`` whose top-k gates are not renormalised (``norm_topk_prob=False``),
and a dense shared expert blended by a per-token sigmoid gate:

    y = moe(h) + sigmoid(shared_expert_gate(h)) * shared_expert(h)

The model and causal LM return ``(hidden, aux / L)`` and ``(logits,
aux)``, as Mixtral's (:mod:`~deepspeed_tpu_torch.models.mixtral`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from deepspeed_tpu_torch.models.llama import (LlamaAttention, LlamaMLP,
                                              RMSNorm)
from deepspeed_tpu_torch.models.mixtral import (MixtralConfig,
                                                MixtralForCausalLM,
                                                MixtralModel, count_params,
                                                make_moe)

__all__ = ["Qwen2MoeConfig", "PRESETS", "get_config", "Qwen2MoeBlock",
           "Qwen2MoeModel", "Qwen2MoeForCausalLM", "count_params",
           "flops_per_token"]


@dataclasses.dataclass(frozen=True)
class Qwen2MoeConfig(MixtralConfig):
    # the experts' own (small) intermediate size and the shared expert's
    # (large) one: HF moe_intermediate_size / shared_expert_intermediate_size
    moe_intermediate_size: int = 0          # 0 -> intermediate_size
    shared_expert_intermediate_size: int = 0  # 0 -> no shared expert
    norm_topk_prob: bool = False
    attention_bias: bool = True             # q/k/v biases (Qwen2 lineage)

    @property
    def expert_intermediate(self) -> int:
        return self.moe_intermediate_size or self.intermediate_size


PRESETS = {
    # Qwen1.5-MoE-A2.7B
    "qwen1.5-moe-a2.7b": dict(
        vocab_size=151936, hidden_size=2048, intermediate_size=5632,
        moe_intermediate_size=1408, shared_expert_intermediate_size=5632,
        num_hidden_layers=24, num_attention_heads=16,
        num_key_value_heads=16, num_local_experts=60,
        num_experts_per_tok=4, rope_theta=1e6,
        max_position_embeddings=8192, rms_norm_eps=1e-6),
    # Qwen2-57B-A14B
    "qwen2-57b-a14b": dict(
        vocab_size=151936, hidden_size=3584, intermediate_size=18944,
        moe_intermediate_size=2560, shared_expert_intermediate_size=20480,
        num_hidden_layers=28, num_attention_heads=28,
        num_key_value_heads=4, num_local_experts=64,
        num_experts_per_tok=8, rope_theta=1e6,
        max_position_embeddings=32768, rms_norm_eps=1e-6),
    "tinyqwen2moe": dict(
        vocab_size=96, hidden_size=32, intermediate_size=64,
        moe_intermediate_size=48, shared_expert_intermediate_size=64,
        num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
        num_local_experts=4, num_experts_per_tok=2,
        max_position_embeddings=64, rms_norm_eps=1e-6),
}


def get_config(preset: str, **overrides) -> Qwen2MoeConfig:
    kw = dict(PRESETS[preset])
    kw.update(overrides)
    return Qwen2MoeConfig(**kw)


class Qwen2MoeBlock(nn.Module):
    def __init__(self, cfg: Qwen2MoeConfig):
        super().__init__()
        E, eps, pd = cfg.hidden_size, cfg.rms_norm_eps, cfg.param_dtype
        self.input_layernorm = RMSNorm(E, eps, pd)
        self.self_attn = LlamaAttention(cfg)
        self.post_attention_layernorm = RMSNorm(E, eps, pd)
        self.mlp = make_moe(cfg, cfg.expert_intermediate,
                            normalize_weights=cfg.norm_topk_prob)
        self.shared_expert = self.shared_expert_gate = None
        if cfg.shared_expert_intermediate_size:
            self.shared_expert = LlamaMLP(dataclasses.replace(
                cfg, intermediate_size=cfg.shared_expert_intermediate_size))
            self.shared_expert_gate = nn.Linear(E, 1, bias=False, dtype=pd)

    def forward(self, x, positions, rope, kv_cache=None, ragged_meta=None):
        """``(x, l_aux)``."""
        x = x + self.self_attn(self.input_layernorm(x), positions, rope,
                               kv_cache, ragged_meta)
        h = self.post_attention_layernorm(x)
        y, l_aux = self.mlp(h)
        if self.shared_expert is not None:
            shared = self.shared_expert(h)
            gate = torch.sigmoid(self.shared_expert_gate(h).float())
            y = y + gate.to(shared.dtype) * shared
        return x + y, l_aux


class Qwen2MoeModel(MixtralModel):
    """Returns ``(hidden, mean per-layer aux loss)``."""

    block_cls = Qwen2MoeBlock


class Qwen2MoeForCausalLM(MixtralForCausalLM):
    """``forward`` returns ``(logits, aux)``."""

    model_cls = Qwen2MoeModel


def flops_per_token(cfg: Qwen2MoeConfig,
                    seq_len: Optional[int] = None) -> float:
    """Forward+backward FLOPs per token counting the active parameters
    (top-k experts and the always-on shared expert): a copy of the JAX
    family's."""
    E, L = cfg.hidden_size, cfg.num_hidden_layers
    Dh, H, Hkv = cfg.head_dim, cfg.num_attention_heads, cfg.num_key_value_heads
    per_layer = (E * H * Dh + 2 * E * Hkv * Dh + H * Dh * E
                 + cfg.num_experts_per_tok * 3 * E * cfg.expert_intermediate
                 + 3 * E * cfg.shared_expert_intermediate_size + E)
    n = L * per_layer + cfg.vocab_size * E
    s = seq_len or cfg.max_position_embeddings
    attn = 12 * L * H * Dh * s
    return 6.0 * n + attn
