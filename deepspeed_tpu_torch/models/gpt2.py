"""GPT-2 model family as PyTorch modules.

Counterpart of ``deepspeed_tpu/models/gpt2.py``, the model of the JAX
package's benchmark configurations: learned token and position
embeddings, pre-LN blocks (``LayerNorm`` eps 1e-5), a fused ``c_attn``
projection with bias, multi-head attention (one KV head per query head),
a tanh-GELU MLP and, by default, an LM head tied to the token embedding.

Module and parameter names follow the flax tree (``transformer/wte``,
``h_<i>/attn/c_attn``, ...), so ``module_inject/flax_bridge.py`` maps one
onto the other by rule.  Layers are always unrolled (an ``nn.ModuleList``
named ``h``); the model computes in the dtype of its weights.  A KV cache
is passed explicitly (``kv_cache=``, one :class:`KVCache` per layer) for
the v1 engine, as in the port's Llama.

q, k and v are strided ``[B, H, S, D]`` views into the one ``[B, S, 3E]``
output of ``c_attn`` (a row stride of 3E): the flash kernels build their
TMA maps from the caller's strides, so the views reach them uncopied.

The tied head goes through the token embedding module itself
(``wte(x, attend=True)``, flax's ``wte.attend``), so that module hooks
(ZeRO stage 3's gathers) see both uses of the table.  Int8 serving swaps
``wte`` for a ``QuantizedEmbedding`` that dequantizes at each of the two
calls: the table is dequantized twice per forward.

This module also holds what the JAX package keeps in its GPT-2 module
and the Llama module imports from it: :func:`remat_policy_fn` with
:func:`remat_call` (selective activation checkpointing) and
:func:`next_token_loss`.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import List, Optional

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from deepspeed_tpu_torch.inference.kv_cache import KVCache, cached_attention
from deepspeed_tpu_torch.ops.flash_attention import flash_attention


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    """Same fields and defaults as the flax ``GPT2Config``, so one converts
    to the other field for field.  ``dtype``/``param_dtype`` are torch
    dtypes; modules are built in ``param_dtype`` and compute in their
    weights' dtype.  ``remat`` checkpoints every block under autograd with
    ``remat_policy`` (:func:`remat_policy_fn`); ``scan_layers``,
    ``decode`` and ``pipeline_microbatches`` change nothing in the modules
    here (layers are always unrolled, and the cache is an argument).
    Knobs of paths not ported yet raise."""

    vocab_size: int = 50257
    n_positions: int = 1024
    n_embd: int = 768
    n_layer: int = 12
    n_head: int = 12
    dropout: float = 0.0
    dtype: torch.dtype = torch.bfloat16
    param_dtype: torch.dtype = torch.float32
    scan_layers: bool = True
    remat: bool = True
    remat_policy: str = "full"
    use_flash_attention: bool = False
    tie_word_embeddings: bool = True
    tensor_parallel: bool = False
    pipeline_stages: int = 1
    pipeline_microbatches: int = 0
    decode: bool = False
    max_cache_len: int = 0

    def __post_init__(self):
        if self.remat_policy != "none":
            remat_policy_fn(self.remat_policy)
        unported = {
            "tensor_parallel": (self.tensor_parallel,
                                "ROADMAP A7a (tensor-parallel serving)"),
            "pipeline_stages": (self.pipeline_stages > 1,
                                "ROADMAP A11 (parallel/pipeline.py)"),
        }
        for name, (is_set, item) in unported.items():
            if is_set:
                raise NotImplementedError(
                    f"GPT2Config.{name}={getattr(self, name)!r} is not "
                    f"ported yet: {item}")

    @property
    def head_dim(self) -> int:
        return self.n_embd // self.n_head

    @property
    def kv_cache_shape(self):
        """(layers, KV heads, head dim) of the v1 engine's KV cache."""
        return self.n_layer, self.n_head, self.head_dim


# Preset sizes (the JAX package's, from the reference baseline configs)
PRESETS = {
    "gpt2-125m": dict(n_embd=768, n_layer=12, n_head=12),
    "gpt2-350m": dict(n_embd=1024, n_layer=24, n_head=16),
    "gpt2-760m": dict(n_embd=1536, n_layer=24, n_head=16),
    "gpt2-1.3b": dict(n_embd=2048, n_layer=24, n_head=32),
    "gpt2-2.7b": dict(n_embd=2560, n_layer=32, n_head=32),
    "gpt2-6.7b": dict(n_embd=4096, n_layer=32, n_head=32),
}


def get_config(preset: str, **overrides) -> GPT2Config:
    kw = dict(PRESETS[preset])
    kw.update(overrides)
    return GPT2Config(**kw)


# ---------------------------------------------------------------------------
# Selective activation checkpointing
# ---------------------------------------------------------------------------

_aten = torch.ops.aten
# matmuls without batch dims (nn.Linear on any input rank folds its batch
# into rows), and the batched ones (the plain attention's einsums)
_DOTS = (_aten.mm.default, _aten.addmm.default)
_BATCH_DOTS = (_aten.bmm.default, _aten.baddbmm.default)
_REMAT_POLICIES = {
    "full": (),
    # "dots" is dots_with_no_batch_dims_saveable; "dots_saveable" and
    # "checkpoint_dots" (one policy in JAX) save every dot
    "dots": _DOTS,
    "dots_saveable": _DOTS + _BATCH_DOTS,
    "checkpoint_dots": _DOTS + _BATCH_DOTS,
    "nothing_saveable": (),
}
# random draws are kept, never redrawn: dropout draws from an explicit
# generator, which the recompute must not advance a second time
_RANDOM = frozenset({_aten.rand, _aten.rand_like, _aten.bernoulli,
                     _aten.uniform_, _aten.normal_})


def remat_policy_fn(name: str):
    """The aten ops whose outputs a block keeps for the backward under
    the JAX policy ``name`` (an empty tuple: keep nothing, recompute the
    block); the flash forward, an autograd Function and no dot, is
    recomputed under every policy, as JAX recomputes its ``pallas_call``.
    Raises ``ValueError`` for a name the JAX package does not know
    ("none", no remat, is the caller's)."""
    if name not in _REMAT_POLICIES:
        raise ValueError(f"unknown remat policy {name!r}; "
                         f"one of {sorted(_REMAT_POLICIES)} or 'none'")
    return _REMAT_POLICIES[name]


@functools.lru_cache(maxsize=None)
def _context_fn(name: str):
    saved = frozenset(remat_policy_fn(name))

    def policy(ctx, op, *args, **kwargs):
        if op in saved or op.overloadpacket in _RANDOM:
            return CheckpointPolicy.MUST_SAVE
        return CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy)


def remat_call(fn, policy: str, *args):
    """``fn(*args)`` checkpointed (``nn.remat`` of the flax models): only
    the inputs and the outputs of the ops ``policy`` saves are kept; the
    rest is recomputed in the backward."""
    return checkpoint(fn, *args, use_reentrant=False,
                      context_fn=_context_fn(policy))


# ---------------------------------------------------------------------------
# Modules
# ---------------------------------------------------------------------------

def _dropout(x: torch.Tensor, rate: float,
             generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: keep with probability 1 - rate, scaled by
    1 / (1 - rate), the mask drawn from ``generator``."""
    if not rate:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) \
        >= rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


class Embed(nn.Embedding):
    """flax ``nn.Embed``: ``forward(ids)`` looks rows up and
    ``forward(x, attend=True)`` is ``x @ table^T``, the tied LM head."""

    calls_per_forward = 1       # the module hooks' count (ZeRO stage 3)

    def forward(self, x: torch.Tensor, attend: bool = False) -> torch.Tensor:
        if attend:
            return F.linear(x, self.weight)
        return F.embedding(x, self.weight)


class CausalSelfAttention(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        E = cfg.n_embd
        self.c_attn = nn.Linear(E, 3 * E, dtype=cfg.param_dtype)
        self.c_proj = nn.Linear(E, E, dtype=cfg.param_dtype)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv_cache: Optional[KVCache] = None, rate: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        cfg = self.config
        B, S, E = x.shape
        H, D = cfg.n_head, cfg.head_dim
        q, k, v = (t.view(B, S, H, D).transpose(1, 2)
                   for t in self.c_attn(x).split(E, dim=-1))
        if kv_cache is not None:
            k_full, v_full = kv_cache.update(k, v, positions)
            if S == 1:                  # decode step: attend to the cache
                y = cached_attention(q, k_full, v_full, positions)
                return self.c_proj(y.transpose(1, 2).reshape(B, S, E))
            # prefill: cache written above; attend within the chunk below
        if cfg.use_flash_attention:
            assert not rate, (
                "flash attention has no attention-probability dropout; set "
                "dropout=0 or use_flash_attention=False for training with "
                "dropout")
            y = flash_attention(q, k, v, causal=True)
        else:
            # the scale multiplies in fp32, as the flax model's numpy
            # scalar promotes its scores
            att = torch.einsum("bhqd,bhkd->bhqk", q, k).float() * (
                1.0 / math.sqrt(D))
            mask = torch.ones(S, S, dtype=torch.bool,
                              device=x.device).tril()
            att = att.masked_fill(~mask, torch.finfo(att.dtype).min)
            att = torch.softmax(att, dim=-1).to(x.dtype)
            att = _dropout(att, rate, generator)
            y = torch.einsum("bhqk,bhkd->bhqd", att, v)
        y = self.c_proj(y.transpose(1, 2).reshape(B, S, E))
        return _dropout(y, rate, generator)


class MLP(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        E = cfg.n_embd
        self.c_fc = nn.Linear(E, 4 * E, dtype=cfg.param_dtype)
        self.c_proj = nn.Linear(4 * E, E, dtype=cfg.param_dtype)

    def forward(self, x: torch.Tensor, rate: float = 0.0,
                generator: Optional[torch.Generator] = None
                ) -> torch.Tensor:
        # jax.nn.gelu's default is the tanh approximation
        h = self.c_proj(F.gelu(self.c_fc(x), approximate="tanh"))
        return _dropout(h, rate, generator)


class Block(nn.Module):
    def __init__(self, cfg: GPT2Config):
        super().__init__()
        E, pd = cfg.n_embd, cfg.param_dtype
        self.ln_1 = nn.LayerNorm(E, eps=1e-5, dtype=pd)
        self.attn = CausalSelfAttention(cfg)
        self.ln_2 = nn.LayerNorm(E, eps=1e-5, dtype=pd)
        self.mlp = MLP(cfg)

    def forward(self, x, positions, kv_cache=None, rate=0.0, generator=None):
        x = x + self.attn(self.ln_1(x), positions, kv_cache, rate, generator)
        return x + self.mlp(self.ln_2(x), rate, generator)


class GPT2Model(nn.Module):
    """Token ids ``[B, S]`` to logits ``[B, S, V]``.  Dropout (training
    mode, ``dropout`` > 0) draws from ``self.generator``, made on first
    use on the input's device with seed 0 unless the caller sets one."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        E, pd = cfg.n_embd, cfg.param_dtype
        self.wte = Embed(cfg.vocab_size, E, dtype=pd)
        self.wpe = Embed(cfg.n_positions, E, dtype=pd)
        self.h = nn.ModuleList(Block(cfg) for _ in range(cfg.n_layer))
        self.ln_f = nn.LayerNorm(E, eps=1e-5, dtype=pd)
        if cfg.tie_word_embeddings:
            self.wte.calls_per_forward = 2      # the lookup and the head
        else:
            self.lm_head = nn.Linear(E, cfg.vocab_size, bias=False,
                                     dtype=pd)
        self.generator: Optional[torch.Generator] = None

    def forward(self, input_ids: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                kv_cache: Optional[List[KVCache]] = None) -> torch.Tensor:
        cfg = self.config
        S = input_ids.shape[1]
        if positions is None:
            positions = torch.arange(S, device=input_ids.device)
        rate = cfg.dropout if self.training else 0.0
        if rate and self.generator is None:
            self.generator = torch.Generator(
                device=input_ids.device).manual_seed(0)
        gen = self.generator if rate else None
        x = _dropout(self.wte(input_ids) + self.wpe(positions), rate, gen)
        remat = (cfg.remat and cfg.remat_policy != "none"
                 and torch.is_grad_enabled() and kv_cache is None)
        for i, block in enumerate(self.h):
            if remat:
                x = remat_call(block, cfg.remat_policy, x, positions, None,
                               rate, gen)
            else:
                x = block(x, positions,
                          None if kv_cache is None else kv_cache[i], rate,
                          gen)
        x = self.ln_f(x)
        if cfg.tie_word_embeddings:
            return self.wte(x, attend=True)
        return self.lm_head(x)

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
        """One module's own weights at the flax initialisers' scales:
        Dense kernels ``lecun_normal`` (a normal truncated at two standard
        deviations, of variance 1/fan_in), embeddings N(0, 1/features),
        LayerNorm scale 1, biases 0.  Calling it on every module in
        ``modules()`` order draws what :meth:`init_weights` draws."""
        if isinstance(mod, nn.Linear):
            # the truncated normal's own std is 0.8796 of its scale
            std = 1.0 / math.sqrt(mod.in_features) / .87962566103423978
            w = torch.empty(mod.weight.shape, dtype=torch.float32,
                            device=mod.weight.device)
            nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            mod.weight.copy_(w)
            if mod.bias is not None:
                mod.bias.zero_()
        elif isinstance(mod, nn.Embedding):
            mod.weight.normal_(0.0, 1.0 / math.sqrt(mod.embedding_dim),
                               generator=generator)
        elif isinstance(mod, nn.LayerNorm):
            mod.weight.fill_(1.0)
            mod.bias.zero_()


class GPT2LMLoss(nn.Module):
    """Loss-returning wrapper (the engine's module contract):
    ``module(batch) -> scalar`` next-token cross entropy in fp32, ``batch``
    ``{"input_ids": [B, S]}`` or the ids themselves.  The model sits under
    ``transformer``, as in the flax ``GPT2LMLoss``."""

    def __init__(self, cfg: GPT2Config):
        super().__init__()
        self.config = cfg
        self.transformer = GPT2Model(cfg)

    def forward(self, batch) -> torch.Tensor:
        input_ids = batch["input_ids"] if isinstance(batch, dict) else batch
        return next_token_loss(self.transformer(input_ids), input_ids)

    def init_weights(self, generator: torch.Generator) -> None:
        self.transformer.init_weights(generator)

    init_module_weights = staticmethod(GPT2Model.init_module_weights)


def next_token_loss(logits: torch.Tensor,
                    input_ids: torch.Tensor) -> torch.Tensor:
    """Next-token cross entropy, ``mean(logsumexp(logits) - target
    logit)``: the logits stay in the compute dtype, the log-sum-exp and the
    gathered target logits are fp32."""
    logits = logits[:, :-1]
    targets = input_ids[:, 1:]
    lse = torch.logsumexp(logits.float(), dim=-1)
    tgt = logits.gather(-1, targets[..., None])[..., 0]
    return (lse - tgt.float()).mean()


def count_params(params) -> int:
    """Elements of a module's parameters or of a ``state_dict``'s
    tensors."""
    tensors = (params.parameters() if isinstance(params, nn.Module)
               else params.values())
    return sum(t.numel() for t in tensors)


def flops_per_token(cfg: GPT2Config, seq_len: Optional[int] = None) -> float:
    """Model fwd+bwd FLOPs per token for MFU (PaLM-appendix convention):
    ``6 * N_matmul + 12 * L * E * S`` where ``N_matmul`` counts matmul
    params (block weights + the LM head; embedding lookups are
    gathers)."""
    n = 12 * cfg.n_layer * cfg.n_embd ** 2 + cfg.vocab_size * cfg.n_embd
    s = seq_len or cfg.n_positions
    attn = 12 * cfg.n_layer * cfg.n_embd * s
    return 6.0 * n + attn
