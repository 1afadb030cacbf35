"""Inference engine (v1).

Counterpart of ``deepspeed_tpu/inference/engine.py`` (the reference
``InferenceEngine``, ``deepspeed/inference/engine.py:40``, entry
``deepspeed.init_inference``).  ``generate`` runs a prefill over the prompt
(the flash kernel in every layer) and then one decode step per new token
against a per-layer KV cache, sampling on the device.

Where the JAX engine compiles the whole generate loop into one program (a
``lax.scan`` over decode steps with a fixed-size cache as its carry), this
one runs a static-shape decode step ``max_new_tokens - 1`` times: it
writes its K/V row at a position held in a device tensor into
preallocated ``fixed`` caches and attends over the whole buffer under the
position mask (:mod:`~deepspeed_tpu_torch.inference.kv_cache`), so that
no step reads a device value on the host.
:meth:`InferenceEngine.generate_async` returns while the card is still
working, and :class:`PendingGeneration` harvests the tokens when asked.
With ``enable_cuda_graph`` the step is captured as a CUDA graph once per
(batch, cache length, sampling settings) and replayed (ROADMAP A8b); the
EOS id lives in a device buffer, so it keys nothing.  The engine keeps
one decode state (its caches and its graphs) at a time: a call of
another batch or cache length frees it before it builds and captures
the next, and every graph of the engine shares one memory pool.  The
prefill stays eager, one launch chain that keeps the card busy
already.  Eager and replayed steps run the same kernels at the same
shapes, so their tokens are equal.  Sampled steps draw from a
``torch.Generator`` that each replay advances (the graph registers it
through ``CUDAGraph.register_generator_state``; a torch without that
raises for sampled graphs and captures greedy ones only).

``quant.enabled`` serves quantized weights (``qtype`` "int8", "fp8",
"fp6" or "w8a8"): every matmul weight is quantized once the weights are
in the serving dtype (int8 and fp6 in groups of ``quant.group_size``, 128
by default) and dequantized at use, "w8a8" weights too, one scale an
output channel, as the JAX v1 engine dequantizes its whole tree
(:mod:`~deepspeed_tpu_torch.inference.quantization`).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.common import (HostStageStats,
                                                  capture_graph, logits_of,
                                                  normalize_params)
from deepspeed_tpu_torch.inference.config import (DeepSpeedInferenceConfig,
                                                  load_inference_config)
from deepspeed_tpu_torch.inference.kv_cache import init_cache
from deepspeed_tpu_torch.inference.quantization import check_format
from deepspeed_tpu_torch.inference.sampling import sample_logits
from deepspeed_tpu_torch.utils.logging import log_dist, logger

_DTYPES = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
           "float16": torch.float16, "fp16": torch.float16,
           "float32": torch.float32, "fp32": torch.float32}


class _DecodeState:
    """The static-shape decode step's buffers for one (batch, cache
    length): ``fixed`` KV caches, the token fed next (``tok [B]``), its
    position (``pos [1]``), the EOS id (``eos [1]``, -1 for none), the
    rows that emitted EOS (``done [B]``) and the output rows
    (``seq [B, L]``: the prompt, then each new token).  ``graphs``: the
    step captured over these buffers, by sampling settings."""

    def __init__(self, cache, B: int, L: int, device: torch.device):
        self.cache = cache
        self.key = (B, L)
        self.tok = torch.zeros(B, dtype=torch.long, device=device)
        self.pos = torch.zeros(1, dtype=torch.long, device=device)
        self.eos = torch.full((1,), -1, dtype=torch.long, device=device)
        self.done = torch.zeros(B, dtype=torch.bool, device=device)
        self.seq = torch.zeros(B, L, dtype=torch.long, device=device)
        self.graphs: Dict[Tuple, Tuple] = {}


def init_inference(model: nn.Module, config: Any = None,
                   params: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None,
                   device: DeviceLike = None,
                   **kwargs) -> "InferenceEngine":
    """Create an :class:`InferenceEngine` (reference
    ``deepspeed.init_inference``, ``deepspeed/__init__.py:291``).

    ``model``: a causal-LM module of this package (``models/llama.py``,
    ``models/gpt2.py``, ``models/mixtral.py``, ``models/qwen2_moe.py``;
    an MoE model's ``(logits, aux)`` gives its logits, and ``quant``
    quantizes its expert banks too: group-wise int8 under w8a8) whose
    ``config`` dataclass has ``decode`` and
    ``max_cache_len`` fields and a ``kv_cache_shape``.  Build it under
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
                    f.name for f in dataclasses.fields(mcfg)} and
                hasattr(mcfg, "kv_cache_shape")):
            raise TypeError(
                "init_inference needs a decoder model whose config "
                "dataclass has 'decode' and 'max_cache_len' fields and a "
                "'kv_cache_shape' (models/llama.py, models/gpt2.py)")
        # learned and rotary position tables bound usable positions; clamp
        # the cache so generate() can't run past them (a position past a
        # learned table faults in the embedding's gather on the card)
        cache_len = mcfg.max_cache_len or config.max_out_tokens
        pos_bound = (getattr(mcfg, "n_positions", None) or
                     getattr(mcfg, "max_position_embeddings", None))
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
        # weight-only serving quantization, after the cast to the serving
        # dtype as in the reference: weights persist quantized and
        # dequantize at use (a quantized meta model is built module by
        # module)
        self.module = normalize_params(
            model, params, dtype=self.dtype, device=self.device,
            generator=generator,
            quantize=dict(fmt=config.quant.qtype,
                          group_size=config.quant.group_size)
            if config.quant.enabled else None).eval()
        # the one decode state whose steps are captured, and the memory
        # pool every graph of the engine shares
        self._graphed: Optional[_DecodeState] = None
        self._graph_pool = None
        if config.enable_cuda_graph and self.device.type != "cuda":
            log_dist("init_inference: enable_cuda_graph on the CPU runs the "
                     "static-shape decode step eagerly (CUDA graphs exist "
                     "only on cuda)", ranks=[0])
        log_dist(f"InferenceEngine: dtype={config.dtype} "
                 f"device={self.device} max_cache_len={self.max_cache_len} "
                 f"cuda_graph={config.enable_cuda_graph}", ranks=[0])

    # ------------------------------------------------------------------

    @torch.inference_mode()
    def forward(self, input_ids) -> torch.Tensor:
        """Full-sequence logits [B, S, V] (reference
        ``InferenceEngine.forward``) — no KV cache."""
        ids = torch.as_tensor(input_ids, dtype=torch.long).to(self.device)
        return logits_of(self.module(ids))

    __call__ = forward

    # ------------------------------------------------------------------

    def _state(self, B: int, L: int) -> _DecodeState:
        layers, kv_heads, head_dim = self.module.config.kv_cache_shape
        return _DecodeState(
            init_cache(layers, L, B, kv_heads, head_dim, self.dtype,
                       self.device, fixed=True),
            B, L, self.device)

    @torch.inference_mode()
    def _prefill(self, prompt: torch.Tensor, st: _DecodeState, sample,
                 eos_id: Optional[int]) -> None:
        """The eager prefill into ``st``: caches, first token, position,
        EOS id."""
        B, P = prompt.shape
        for c in st.cache:
            c.index = 0
        out = self.module(prompt,
                          positions=torch.arange(P, device=self.device),
                          kv_cache=st.cache)
        tok = sample(logits_of(out)[:, -1])
        st.seq[:, :P].copy_(prompt)
        st.seq[:, P].copy_(tok)
        st.tok.copy_(tok)
        st.pos.fill_(P)
        st.eos.fill_(-1 if eos_id is None else eos_id)
        torch.eq(tok, st.eos, out=st.done)

    @torch.inference_mode()
    def _decode_step(self, st: _DecodeState, sample) -> None:
        """One static-shape decode step, in place on ``st``: the token at
        ``pos`` goes through the model (its K/V row written at ``pos``,
        attention over the whole cache), the next one lands in
        ``seq[:, pos + 1]`` and ``pos`` advances.  Nothing is read on the
        host and nothing depends on a host integer, so one capture
        replays at every position."""
        out = self.module(st.tok[:, None], positions=st.pos,
                          kv_cache=st.cache)
        nxt = sample(logits_of(out)[:, -1])
        # once a row has emitted EOS it keeps emitting EOS (no token is
        # -1, so without an EOS id no row is ever done)
        nxt = torch.where(st.done, st.eos, nxt)
        st.done |= nxt == st.eos
        st.seq.index_copy_(1, st.pos + 1, nxt[:, None])
        st.tok.copy_(nxt)
        st.pos += 1

    def _generate(self, prompt: torch.Tensor, st: _DecodeState,
                  max_new: int, sampling: Dict,
                  generator: Optional[torch.Generator],
                  eos_id: Optional[int]) -> torch.Tensor:
        """Prefill and ``max_new - 1`` static-shape decode steps, eager;
        returns the ``[B, P + max_new]`` rows on the device."""
        sample = _sampler(sampling, generator)
        self._prefill(prompt, st, sample, eos_id)
        for _ in range(max_new - 1):
            self._decode_step(st, sample)
        return st.seq

    def _graph_entry(self, B: int, L: int, sampling: Dict):
        """``(state, graph, generator or None)``: the decode step for
        (batch, cache length, sampling settings), captured on first use
        over the engine's one graphed state.  A state of another batch or
        cache length is freed first, its graphs with it.  Capture runs
        before the call's prefill, while the state holds no live request:
        the warm-up before it runs for real.  The caches are zeroed for
        the call."""
        st = self._graphed
        if st is None or st.key != (B, L):
            self._graphed = st = None       # free its cache before the next
            st = self._graphed = self._state(B, L)
        skey = tuple(sorted(sampling.items()))
        if skey not in st.graphs:
            st.graphs[skey] = self._capture_step(st, sampling)
        with torch.inference_mode():
            for c in st.cache:              # a fresh cache, as eagerly
                c.key.zero_()
                c.value.zero_()
        return (st,) + st.graphs[skey]

    def _capture_step(self, st: _DecodeState, sampling: Dict):
        # the graph draws from a generator of its own, registered with
        # it; each call hands it the caller's generator state and back
        gen = (torch.Generator(device=self.device)
               if sampling["do_sample"] else None)
        sample = _sampler(sampling, gen)
        if self._graph_pool is None:
            self._graph_pool = torch.cuda.graph_pool_handle()
        with torch.inference_mode():
            # the warm-up runs for real: from position 0, its writes stay
            # inside the buffers whatever call the state served last
            st.pos.zero_()
        t0 = time.perf_counter()
        graph, _ = capture_graph(lambda: self._decode_step(st, sample),
                                 pool=self._graph_pool,
                                 generators=() if gen is None else (gen,))
        self.host_stats.graph_captures += 1
        self.host_stats.graph_capture_s += time.perf_counter() - t0
        return graph, gen

    def _generate_graphed(self, prompt: torch.Tensor, entry, max_new: int,
                          sampling: Dict, generator: Optional[torch.Generator],
                          eos_id: Optional[int]) -> torch.Tensor:
        """:meth:`_generate` with the decode steps replayed from the
        captured ``entry`` (:meth:`_graph_entry`); the same tokens."""
        st, graph, gen = entry
        self._prefill(prompt, st, _sampler(sampling, generator), eos_id)
        if gen is not None:
            gen.set_state(generator.get_state())
        for _ in range(max_new - 1):
            graph.replay()
        self.host_stats.graph_replays += max_new - 1
        if gen is not None:
            generator.set_state(gen.get_state())
        with torch.inference_mode():
            return st.seq.clone()       # the next call reuses the buffers

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
        if do_sample and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        sampling = dict(do_sample=bool(do_sample))
        if do_sample:
            sampling.update(temperature=float(temperature), top_k=int(top_k),
                            top_p=float(top_p))
        L = P + max_new_tokens
        # one new token has no decode step to capture
        graphed = (self.config.enable_cuda_graph and
                   self.device.type == "cuda" and max_new_tokens > 1)
        with st.stage("plan"):
            state = (self._graph_entry(B, L, sampling)
                     if graphed else self._state(B, L))
        with st.stage("dispatch"):
            st.dispatches += 1
            arr = (self._generate_graphed if graphed else self._generate)(
                prompt, state, max_new_tokens, sampling, generator,
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
        (see :class:`~deepspeed_tpu_torch.inference.common.HostStageStats`);
        with ``enable_cuda_graph``, the graph counters too."""
        out = self.host_stats.serving_stages()
        if self.config.enable_cuda_graph:
            out.update(self.host_stats.graph_stages())
        return out


def _sampler(sampling: Dict, generator: Optional[torch.Generator]
             ) -> Callable[[torch.Tensor], torch.Tensor]:
    def sample(logits):
        return sample_logits(logits, generator, **sampling)
    return sample
