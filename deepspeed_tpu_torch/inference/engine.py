"""Inference engine (v1).

Counterpart of ``deepspeed_tpu/inference/engine.py`` (the reference
``InferenceEngine``, ``deepspeed/inference/engine.py:40``, entry
``deepspeed.init_inference``).  ``generate`` runs a prefill over the prompt
(the flash kernel in every layer) and then one decode step per new token
against a per-layer KV cache, sampling on the device.

Where the JAX engine compiles the whole generate loop into one program (a
``lax.scan`` over decode steps), this one is a Python loop that enqueues
work on the current CUDA stream without waiting for it: no step reads a
device value on the host, so :meth:`InferenceEngine.generate_async`
returns while the card is still working, and :class:`PendingGeneration`
harvests the tokens when asked.

``quant.enabled`` (``qtype`` "int8") serves int8 weights: every matmul
weight is quantized group-wise once the weights are in the serving dtype
(``quant.group_size``, 128 by default) and dequantized at use
(:mod:`~deepspeed_tpu_torch.inference.quantization`).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional

import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.common import (HostStageStats, logits_of,
                                                  normalize_params)
from deepspeed_tpu_torch.inference.config import (DeepSpeedInferenceConfig,
                                                  load_inference_config)
from deepspeed_tpu_torch.inference.kv_cache import init_cache
from deepspeed_tpu_torch.inference.quantization import (check_format,
                                                        quantize_model_)
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.utils.logging import log_dist, logger

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32, "fp32": torch.float32}


def init_inference(model: nn.Module, config: Any = None,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None,
                   **kwargs) -> "InferenceEngine":
    """Create an :class:`InferenceEngine` (reference
    ``deepspeed.init_inference``, ``deepspeed/__init__.py:291``).

    ``model``: a causal-LM module of this package whose ``config``
    dataclass has ``decode`` and ``max_cache_len`` fields.  Build it under
    ``torch.device("meta")`` to have its weights made directly in the
    serving dtype on the card.  ``params``: a ``state_dict`` to load;
    without one a meta model gets random weights from ``generator``.
    ``device``: ``cuda`` by default; the CPU only when asked for.
    Other keyword arguments are config keys.
    """
    cfg = load_inference_config(config, **kwargs)
    return InferenceEngine(model, cfg, params=params, generator=generator,
                           device=device)


class PendingGeneration:
    """Deferred-harvest handle from :meth:`InferenceEngine.generate_async`.

    The work is already enqueued on the device; :meth:`result` blocks on
    the one device-to-host copy and caches the tokens.
    :meth:`device_array` exposes the device tensor for callers chaining
    further device work without paying the host copy."""

    def __init__(self, engine: "InferenceEngine", arr: torch.Tensor):
        self._engine = engine
        self._arr = arr
        self._result: Optional[torch.Tensor] = None
        self._done: Optional[torch.cuda.Event] = None
        if arr.is_cuda:
            self._done = torch.cuda.Event()
            self._done.record(torch.cuda.current_stream(arr.device))

    def device_array(self) -> torch.Tensor:
        return self._arr

    def ready(self) -> bool:
        """True when the tokens can be read without blocking (already
        harvested, or the device has finished the work)."""
        return (self._result is not None or self._done is None
                or self._done.query())

    def result(self) -> torch.Tensor:
        """Token ids ``[B, P + max_new_tokens]`` (int64, on the CPU)."""
        if self._result is None:
            st = self._engine.host_stats
            with st.stage("device"):
                st.blocking_gets += 1
                out = self._arr.cpu()
            st.harvests += 1
            with st.stage("harvest"):
                self._result = out
        return self._result


class InferenceEngine:
    def __init__(self, model: nn.Module, config: DeepSpeedInferenceConfig,
                 params: Optional[Dict[str, torch.Tensor]] = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        self.config = config
        self.dtype = _DTYPES[config.dtype]
        self.device = resolve_device(device)
        self.host_stats = HostStageStats()

        tp_size = (config.tensor_parallel.tp_size
                   if config.tensor_parallel.enabled else 1)
        if tp_size > 1:
            raise NotImplementedError(
                "tensor-parallel serving (tp_size > 1) is not ported yet: "
                "ROADMAP A7a")
        if config.quant.enabled:
            check_format(config.quant.qtype)

        mcfg = getattr(model, "config", None)
        if not (dataclasses.is_dataclass(mcfg) and
                {"decode", "max_cache_len"} <= {
                    f.name for f in dataclasses.fields(mcfg)}):
            raise TypeError(
                "init_inference needs a decoder model whose config "
                "dataclass has 'decode' and 'max_cache_len' fields "
                "(models/llama.py)")
        # rotary position tables bound usable positions; clamp the cache
        # so generate() can't run past them
        cache_len = mcfg.max_cache_len or config.max_out_tokens
        pos_bound = getattr(mcfg, "max_position_embeddings", None)
        if pos_bound is not None and cache_len > pos_bound:
            logger.warning(
                f"max_out_tokens={cache_len} exceeds the model's position "
                f"bound {pos_bound}; clamping the KV cache")
            cache_len = pos_bound
        self.max_cache_len = cache_len

        if params is None and not any(p.is_meta for p in model.parameters()):
            log_dist("init_inference: serving the model's own weights",
                     ranks=[0])
        elif params is None:
            log_dist("init_inference: params randomly initialized "
                     "(none provided)", ranks=[0])
        self.module = normalize_params(model, params, dtype=self.dtype,
                                       device=self.device,
                                       generator=generator).eval()
        if config.quant.enabled:
            # weight-only serving quantization, after the cast to the
            # serving dtype as in the reference: weights persist as int8
            # and dequantize at use
            b0, b1 = quantize_model_(self.module, config.quant.qtype,
                                     group_size=config.quant.group_size)
            log_dist(f"init_inference weights -> {config.quant.qtype}: "
                     f"{b0 / 2**20:.1f} MiB -> {b1 / 2**20:.1f} MiB",
                     ranks=[0])
        log_dist(f"InferenceEngine: dtype={config.dtype} "
                 f"device={self.device} max_cache_len={self.max_cache_len}",
                 ranks=[0])

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (reference
        ``InferenceEngine.forward``) — no KV cache."""
        ids = torch.as_tensor(input_ids, dtype=torch.long).to(self.device)
        return logits_of(self.module(ids))

    __call__ = forward

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def _generate(self, prompt: torch.Tensor, cache, max_new: int,
                  sample, eos_id: Optional[int]) -> torch.Tensor:
        B, P = prompt.shape
        model = self.module
        out = model(prompt, positions=torch.arange(P, device=self.device),
                    kv_cache=cache)
        tok = sample(logits_of(out)[:, -1])
        done = (torch.zeros(B, dtype=torch.bool, device=self.device)
                if eos_id is None else tok == eos_id)
        toks = [tok]
        for t in range(max_new - 1):
            pos = torch.full((1,), P + t, dtype=torch.long,
                             device=self.device)
            out = model(tok[:, None], positions=pos, kv_cache=cache)
            nxt = sample(logits_of(out)[:, -1])
            if eos_id is not None:
                # once a row has emitted EOS it keeps emitting EOS
                nxt = torch.where(done, eos_id, nxt)
                done = done | (nxt == eos_id)
            toks.append(nxt)
            tok = nxt
        return torch.cat([prompt, torch.stack(toks, dim=1)], dim=1)

    def generate_async(self, input_ids, max_new_tokens: int = 128,
                       do_sample: bool = False, temperature: float = 1.0,
                       top_k: int = 0, top_p: float = 1.0,
                       eos_token_id: Optional[int] = None,
                       generator: Optional[torch.Generator] = None
                       ) -> PendingGeneration:
        """Enqueue prefill and decode on the device and return WITHOUT
        waiting for it — the deferred-harvest half of :meth:`generate`.
        ``generator`` (on the engine's device) drives sampling; the
        default is one seeded with 0."""
        st = self.host_stats
        with st.stage("upload"):
            st.meta_uploads += 1
            prompt = torch.as_tensor(input_ids, dtype=torch.long).to(
                self.device)
        if prompt.dim() != 2:
            raise ValueError("input_ids must be [batch, prompt_len]")
        B, P = prompt.shape
        if self.config.max_batch_size and B > self.config.max_batch_size:
            raise ValueError(f"batch {B} exceeds max_batch_size "
                             f"{self.config.max_batch_size}")
        if max_new_tokens < max(self.config.min_out_tokens, 1):
            raise ValueError(f"max_new_tokens {max_new_tokens} < "
                             f"min_out_tokens {self.config.min_out_tokens}")
        if P + max_new_tokens > self.max_cache_len:
            raise ValueError(
                f"prompt {P} + max_new_tokens {max_new_tokens} exceeds "
                f"max_cache_len {self.max_cache_len} (raise max_out_tokens)")
        cfg = self.module.config
        with st.stage("plan"):
            cache = init_cache(cfg.num_hidden_layers, P + max_new_tokens, B,
                               cfg.num_key_value_heads, cfg.head_dim,
                               self.dtype, self.device)
        if do_sample and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)

        def sample(logits):
            return sample_logits(logits, generator, do_sample=do_sample,
                                 temperature=temperature, top_k=top_k,
                                 top_p=top_p)

        with st.stage("dispatch"):
            st.dispatches += 1
            arr = self._generate(prompt, cache, max_new_tokens, sample,
                                 eos_token_id)
        st.ticks += max_new_tokens
        return PendingGeneration(self, arr)

    def generate(self, input_ids, max_new_tokens: int = 128,
                 do_sample: bool = False, temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None
                 ) -> torch.Tensor:
        """Autoregressive generation: prefill + ``max_new_tokens`` decode
        steps.  Returns ``[B, P + max_new_tokens]`` token ids (int64, on
        the CPU).  (``generate_async`` is the non-blocking variant.)"""
        return self.generate_async(
            input_ids, max_new_tokens=max_new_tokens, do_sample=do_sample,
            temperature=temperature, top_k=top_k, top_p=top_p,
            eos_token_id=eos_token_id, generator=generator).result()

    def serving_stages(self) -> Dict[str, Any]:
        """Per-dispatch host-path breakdown + ``host_bound_fraction``
        (see :class:`~deepspeed_tpu_torch.inference.common.HostStageStats`)."""
        return self.host_stats.serving_stages()
