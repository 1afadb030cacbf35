"""Ragged / continuous-batching inference engine (v2) for the H100.

Counterpart of ``deepspeed_tpu/inference/v2/ragged_engine.py`` (the
reference ``InferenceEngineV2``, ``inference/v2/engine_v2.py:30``, with
Dynamic SplitFuse scheduling): requests of different lengths share one
running batch, and a sequence joins the moment a slot frees.

- **Blocked KV.**  KV lives in fixed-size pages addressed by a
  per-sequence page table (:mod:`~deepspeed_tpu_torch.inference.paged`);
  device memory scales with pages, not ``max_seqs x max_seq_len``.
  Allocation is host-side (:class:`PageAllocator`): on demand with
  eviction when the pool runs dry, or worst case at admission.
- **One fused forward per tick.**  A ``[1, T]`` token batch,
  ``T = max_seqs + prefill_chunk``, carries one decode token for every
  ready sequence AND this tick's prefill chunk(s); raggedness lives in
  int32 metadata (``cu_q_lens`` et al.).  Every layer writes its K/V
  rows into its pool in place and runs the hand-written ragged
  paged-attention kernel (``ops/csrc/ragged_paged_attn.cu``), over
  full-width or int8/fp8 pages.
- **The decode block.**  When every live sequence is past prefill,
  ``step()`` runs ``decode_block_size`` decode ticks in a Python loop
  that enqueues everything on the current stream: ``kv_lens``, write
  rows and positions derive from the ``pos``/``active``/``remaining``
  carry on the device, sampling is batched and position-keyed on the
  device, and nothing is read on the host until the block's one
  device-to-host copy.  The host round trip amortizes to 1/K.

Greedy outputs equal the JAX engine's with ``pipeline=False`` token for
token (same scheduling, same admission and eviction decisions); sampled
outputs agree in distribution, drawn from a position-keyed hash instead of
JAX's threefry streams (:mod:`~deepspeed_tpu_torch.inference.sampling`).

Not ported yet, each raising ``NotImplementedError`` that names its
ROADMAP item: the pipelined host path (A8a), speculation (A9.4), KV
tiering (A9.2), the prefix cache (A9.3), long context (A9.5), weight
quantization (A9.6), handoff export/import (A9.7), tensor parallelism
(A7a), and the control plane, SLOs and trace sampling (A10).
"""
from __future__ import annotations

import dataclasses
import itertools
from collections import deque
from typing import Any, Deque, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from deepspeed_tpu_torch.accelerator import DeviceLike, resolve_device
from deepspeed_tpu_torch.inference.common import (HostStageStats,
                                                  kv_quant_block,
                                                  normalize_params)
from deepspeed_tpu_torch.inference.config import (ControlConfig,
                                                  KVTieringConfig,
                                                  PrefixCacheConfig,
                                                  SpeculationConfig,
                                                  load_inference_config)
from deepspeed_tpu_torch.inference.paged import (KV_CACHE_DTYPES,
                                                 PageAllocator, PagedKVPool,
                                                 RaggedMeta, kv_dequant_path,
                                                 pages_for)
from deepspeed_tpu_torch.inference.sampling import (position_keys,
                                                    sample_logits_batched)
from deepspeed_tpu_torch.ops.ragged_paged_attention import PAGE_SIZES
from deepspeed_tpu_torch.telemetry.requests import RequestLatencyTracker
from deepspeed_tpu_torch.utils.logging import log_dist, logger


def _unported(what: str, item: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported to the PyTorch v2 engine yet: ROADMAP {item}")


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray                    # [P] int32
    max_new_tokens: int = 64
    eos_token_id: Optional[int] = None
    do_sample: bool = False
    temperature: float = 1.0
    top_k: int = 0
    top_p: float = 1.0
    # runtime state
    slot: int = -1
    prefill_done: int = 0                 # context tokens already cached
    generated: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # prefill SOURCE: the prompt, or prompt + already-generated tokens
    # after an eviction (the continuation re-prefills its own output)
    ctx: Optional[np.ndarray] = None

    @property
    def ctx_len(self) -> int:
        return int(self.ctx.size if self.ctx is not None
                   else self.prompt.size)

    @property
    def length(self) -> int:
        # tokens in the KV cache: prefilled context + tokens generated
        # AFTER that context (an evicted continuation's ctx already
        # contains its earlier output)
        return self.prefill_done + len(self.generated) - \
            (self.ctx_len - self.prompt.size)


class RaggedInferenceEngineV2:
    """``put_request`` -> repeated ``step()`` -> ``get_outputs``.

    One ``step()`` = (admit waiting requests into free slots, reserving
    KV pages) + EITHER one fused SplitFuse tick (any sequence still
    prefilling: a decode token for every ready sequence plus prompt
    chunks, in one ``T = max_seqs + prefill_chunk`` batch) OR one
    ``decode_block_size``-tick decode block (everyone decoding).
    """

    def __init__(self, model: nn.Module, params: Any = None,
                 max_seqs: int = 8, max_seq_len: int = 512,
                 prefill_chunk: int = 128, seed: int = 0,
                 page_size: int = 64, num_pages: Optional[int] = None,
                 topology=None, decode_block_size: int = 8,
                 kv_cache_dtype: Optional[str] = None,
                 kv_pool_bytes: Optional[int] = None,
                 quantize_weights: Optional[str] = None,
                 kv_reserve: str = "on_demand",
                 pipeline: Optional[bool] = None,
                 speculation: Any = None,
                 draft_model=None, draft_params: Any = None,
                 draft_kv_cache_dtype: Optional[str] = None,
                 kv_tiering: Any = None, prefix_cache: Any = None,
                 slo: Any = None, trace_sample: Optional[int] = None,
                 replica: Optional[str] = None, control: Any = None,
                 config: Any = None,
                 generator: Optional[torch.Generator] = None,
                 device: DeviceLike = None):
        """``model``: a Llama-family module of this package (build it
        under ``torch.device("meta")`` to have its weights made directly
        in its ``config.dtype`` on the card).  ``params``: a
        ``state_dict`` (e.g. from the flax bridge); without one a meta
        model gets random weights from ``generator``.  ``seed`` keys the
        position-keyed sampling draws (the reference's ``rng``).
        ``device``: ``cuda`` by default, the CPU only when asked for.

        ``kv_cache_dtype``: ``None`` (config ``v2.kv_cache_dtype``
        decides; "none" by default) | "none" | "int8" | "fp8" |
        "fp8_e4m3" — the pool's page format.  ``kv_pool_bytes`` sizes the
        pool by a byte budget when ``num_pages`` is not given.
        ``kv_reserve``: "on_demand" (admit on context + one decode
        block of pages, grow per block, evict and requeue as a
        continuation when the pool runs dry) or "worst_case" (reserve
        prompt + max_new_tokens at admission).  ``replica`` is the
        scale-out metric label.  ``pipeline=False`` is the only host path
        (the config's default ``v2.pipeline`` resolves to it); every
        other feature kwarg raises ``NotImplementedError`` when it asks
        for a feature."""
        mcfg = getattr(model, "config", None)
        if not (dataclasses.is_dataclass(mcfg) and
                {"rope_theta", "paged_decode", "decode"} <= {
                    f.name for f in dataclasses.fields(mcfg)}):
            raise TypeError(
                "the ragged engine needs a Llama-family module of this "
                "package (per-token positions through attention and a "
                "paged-cache config)")
        self._check_unported(topology, quantize_weights, pipeline,
                             draft_model, draft_params,
                             draft_kv_cache_dtype, config, speculation,
                             kv_tiering, prefix_cache, control, slo,
                             trace_sample)
        if config is not None and kv_cache_dtype is None:
            kv_cache_dtype = load_inference_config(config).v2.kv_cache_dtype
        kv_cache_dtype = ("none" if kv_cache_dtype is None
                          else str(kv_cache_dtype))
        if kv_cache_dtype not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of "
                             f"{KV_CACHE_DTYPES}, got {kv_cache_dtype!r}")
        if int(page_size) not in PAGE_SIZES:
            raise ValueError(f"page_size {page_size} not in {PAGE_SIZES} "
                             "(the paged-attention kernel's tiles)")
        if kv_reserve not in ("on_demand", "worst_case"):
            raise ValueError(f"kv_reserve must be on_demand|worst_case, "
                             f"got {kv_reserve!r}")
        self.kv_cache_dtype = kv_cache_dtype
        self.device = resolve_device(device)
        self.dtype = mcfg.dtype
        self.pipeline = False

        self.page_size = int(page_size)
        self.pages_per_seq = pages_for(max_seq_len, self.page_size)
        if num_pages is None and kv_pool_bytes is not None:
            page_bytes = self._page_bytes(mcfg)
            num_pages = max(2, int(kv_pool_bytes) // page_bytes)
        if num_pages is None:
            # full provisioning: every slot can reach max_seq_len
            num_pages = 1 + max_seqs * self.pages_per_seq
        self.num_pages = int(num_pages)
        self.cfg = dataclasses.replace(
            mcfg, decode=True, paged_decode=True, max_cache_len=max_seq_len,
            kv_page_size=self.page_size, kv_num_pages=self.num_pages,
            kv_cache_dtype=kv_cache_dtype)
        self.max_seqs = max_seqs
        self.max_seq_len = max_seq_len
        self.prefill_chunk = prefill_chunk
        self.T = max_seqs + prefill_chunk          # fused batch width
        self.decode_block_size = max(int(decode_block_size), 1)
        self.kv_reserve = kv_reserve
        self.evictions = 0
        self.seed = int(seed)
        self.replica = "" if replica is None else str(replica)
        self.host_stats = HostStageStats(replica=self.replica)
        self.request_latency = RequestLatencyTracker()

        self.module = normalize_params(model, params, dtype=self.dtype,
                                       device=self.device,
                                       generator=generator).eval()
        self.allocator = PageAllocator(self.num_pages, self.page_size)
        self.page_table = np.full((max_seqs, self.pages_per_seq), -1,
                                  np.int32)
        self.cache = self._make_pools()
        # decode-block constants: every slot is one 1-token sequence
        self._block_cu = torch.arange(max_seqs + 1, dtype=torch.int32,
                                      device=self.device)
        self._block_ns = torch.tensor([max_seqs], dtype=torch.int32,
                                      device=self.device)
        self._uid = itertools.count()
        self.waiting: Deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_seqs
        self.finished: List[Request] = []
        self._unclaimed: Dict[int, np.ndarray] = {}
        self._stalled: List[Request] = []
        self._last_tokens = np.zeros((max_seqs,), np.int64)
        # streaming cursor: generated-token count already reported per
        # uid (stream_deltas); cancels counts cancellations at any stage
        self._stream_cursor: Dict[int, int] = {}
        self.cancels = 0
        log_dist(
            f"RaggedInferenceEngineV2: max_seqs={max_seqs} "
            f"max_seq_len={max_seq_len} prefill_chunk={prefill_chunk} "
            f"pages={self.num_pages}x{self.page_size} "
            f"kv={kv_cache_dtype} decode_block={self.decode_block_size} "
            f"device={self.device} (paged KV, fused SplitFuse step)",
            ranks=[0])

    # -- construction helpers -------------------------------------------

    @staticmethod
    def _check_unported(topology, quantize_weights, pipeline, draft_model,
                        draft_params, draft_kv_cache_dtype, config,
                        speculation, kv_tiering, prefix_cache, control,
                        slo, trace_sample) -> None:
        """Raise for every feature asked for that this port lacks; kwargs
        win over the config's ``v2`` subtree, as in the reference."""
        if topology is not None:
            raise _unported("tensor-parallel serving (topology)", "A7a")
        if quantize_weights is not None:
            raise _unported("quantize_weights", "A9.6")
        if (draft_model is not None or draft_params is not None
                or draft_kv_cache_dtype is not None):
            raise _unported("draft-model speculation", "A9.4")
        v2 = load_inference_config(config).v2 if config is not None \
            else None
        if pipeline or (pipeline is None and v2 is not None and
                        "pipeline" in v2.model_fields_set and v2.pipeline):
            raise _unported("the pipelined host path (pipeline=True)",
                            "A8a")
        if v2 is not None:
            speculation = v2.speculation if speculation is None \
                else speculation
            kv_tiering = v2.kv_tiering if kv_tiering is None else kv_tiering
            prefix_cache = (v2.prefix_cache if prefix_cache is None
                            else prefix_cache)
            control = v2.control if control is None else control
            slo = v2.slo if slo is None else slo
            trace_sample = (v2.trace_sample if trace_sample is None
                            else trace_sample)
        if isinstance(speculation, str):
            speculation = SpeculationConfig(mode=speculation)
        elif isinstance(speculation, dict):
            speculation = SpeculationConfig(**speculation)
        if speculation is not None and speculation.mode != "off":
            raise _unported(f"speculation (mode={speculation.mode!r})",
                            "A9.4")
        if isinstance(kv_tiering, dict):
            kv_tiering = KVTieringConfig(**{"enabled": True, **kv_tiering})
        if kv_tiering is not None and kv_tiering.long_context:
            raise _unported("long context (kv_tiering.long_context)",
                            "A9.5")
        if kv_tiering is not None and kv_tiering.enabled:
            raise _unported("kv_tiering", "A9.2")
        if isinstance(prefix_cache, bool):
            prefix_cache = PrefixCacheConfig(enabled=prefix_cache)
        elif isinstance(prefix_cache, dict):
            prefix_cache = PrefixCacheConfig(
                **{"enabled": True, **prefix_cache})
        if prefix_cache is not None and prefix_cache.enabled:
            raise _unported("prefix_cache", "A9.3")
        if isinstance(control, bool):
            control = ControlConfig(enabled=control)
        elif isinstance(control, dict):
            control = ControlConfig(**{"enabled": True, **control})
        if control is not None and control.enabled:
            raise _unported("the control plane (control)", "A10")
        if slo:
            raise _unported("SLO objectives (slo)", "A10")
        if trace_sample:
            raise _unported("tail-based trace sampling (trace_sample)",
                            "A10")

    def _make_pools(self) -> List[PagedKVPool]:
        c = self.cfg
        return [PagedKVPool(self.num_pages, self.page_size,
                            c.num_key_value_heads, c.head_dim,
                            self.kv_cache_dtype, self.dtype, self.device)
                for _ in range(c.num_hidden_layers)]

    def _page_bytes(self, mcfg) -> int:
        """Device bytes ONE page costs across every layer's pool (payload
        plus scale rows), counted from the pool tensors of a 2-page pool
        built on the meta device."""
        probe = [PagedKVPool(2, self.page_size, mcfg.num_key_value_heads,
                             mcfg.head_dim, self.kv_cache_dtype,
                             mcfg.dtype, torch.device("meta"))
                 for _ in range(mcfg.num_hidden_layers)]
        return sum(p.nbytes() for p in probe) // 2

    # -- request API ----------------------------------------------------

    def validate_request(self, prompt, max_new_tokens: int = 64) -> None:
        """The submit-time schedulability checks, without enqueuing —
        raises ``ValueError`` for a request that could never run on
        THIS engine."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        max_new = int(max_new_tokens)
        if max_new < 1:
            raise ValueError(
                "max_new_tokens must be >= 1 (prefill seeds the first "
                "token)")
        total = prompt.size + max_new
        if total > self.max_seq_len:
            raise ValueError(
                f"prompt ({prompt.size}) + max_new_tokens ({max_new}) = "
                f"{total} exceeds the engine token budget "
                f"max_seq_len={self.max_seq_len} — the request can never "
                "be scheduled; shorten the prompt or raise max_seq_len")
        if self.allocator.pages_for(total) > self.num_pages - 1:
            raise ValueError(
                f"request needs {self.allocator.pages_for(total)} KV "
                f"pages but the engine owns {self.num_pages - 1} "
                "usable pages — even after evicting every other "
                "sequence it could never be scheduled; raise num_pages")

    def put_request(self, prompt, **kw) -> int:
        """Queue a request; raises ``ValueError`` AT SUBMIT TIME for a
        request that could never be scheduled (admitting one would
        deadlock the FIFO queue behind an unschedulable head)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        max_new = int(kw.get("max_new_tokens", 64))
        self.validate_request(prompt, max_new)
        req = Request(uid=next(self._uid), prompt=prompt, **kw)
        self.waiting.append(req)
        self.request_latency.on_submit(req.uid)
        return req.uid

    def get_outputs(self) -> List[Tuple[int, np.ndarray]]:
        out = list(self._unclaimed.items())
        self._unclaimed = {}
        out += [(r.uid, np.concatenate([r.prompt,
                                        np.asarray(r.generated, np.int32)]))
                for r in self.finished]
        self.finished = []
        for uid, _ in out:
            self._stream_cursor.pop(uid, None)
        return out

    def stream_deltas(self) -> List[Tuple[int, List[int], int, bool]]:
        """Incremental token harvest for streaming front ends: one
        ``(uid, new_tokens, total_generated, done)`` tuple per request
        whose generated-token count grew since the last call, plus every
        newly finished request.  Call BEFORE :meth:`get_outputs` in the
        same tick — collecting an output clears its cursor."""
        out: List[Tuple[int, List[int], int, bool]] = []
        cur = self._stream_cursor
        live = [r for r in self.slots if r is not None]
        for r in itertools.chain(live, self.waiting):
            n = len(r.generated)
            seen = cur.get(r.uid, 0)
            if n > seen:
                out.append((r.uid, [int(t) for t in r.generated[seen:]],
                            n, False))
                cur[r.uid] = n
        for r in self.finished:
            n = len(r.generated)
            seen = cur.pop(r.uid, 0)
            out.append((r.uid, [int(t) for t in r.generated[seen:]],
                        n, True))
        return out

    def cancel(self, uid: int) -> Optional[str]:
        """Cancel one request at any stage, releasing its slot and pool
        pages.  Returns the stage it was cancelled at (``"queued"`` /
        ``"prefill"`` / ``"decode"`` / ``"finished"``) or ``None`` for an
        unknown uid (never submitted, or already collected)."""
        stage: Optional[str] = None
        for r in list(self.waiting):
            if r.uid == uid:
                self.waiting.remove(r)
                stage = "queued"
                break
        if stage is None:
            for i, r in enumerate(self.slots):
                if r is None or r.uid != uid:
                    continue
                stage = ("prefill" if r.prefill_done < r.ctx_len
                         else "decode")
                self.allocator.free(i)
                self.page_table[i, :] = -1
                self.slots[i] = None
                break
        if stage is None:
            for r in list(self.finished):
                if r.uid == uid:
                    self.finished.remove(r)
                    stage = "finished"
                    break
        if stage is None and uid in self._unclaimed:
            del self._unclaimed[uid]
            stage = "finished"
        if stage is None:
            return None
        self.cancels += 1
        self._stream_cursor.pop(uid, None)
        self.request_latency.on_cancel(uid)
        return stage

    def has_work(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.slots)

    def export_parked(self):
        raise _unported("export_parked", "A9.2")

    def import_parked(self, sessions):
        raise _unported("import_parked", "A9.2")

    def export_handoff(self):
        raise _unported("export_handoff", "A9.7")

    def import_handoff(self, sessions, *args, **kwargs):
        raise _unported("import_handoff", "A9.7")

    # -- stats ------------------------------------------------------------

    def serving_stages(self) -> Dict[str, Any]:
        """Per-dispatch host-path breakdown + ``host_bound_fraction``
        (:class:`~deepspeed_tpu_torch.inference.common.HostStageStats`),
        the quantized pool's ``kv_quant`` block, pool pressure and the
        per-request latency percentiles."""
        out = self.host_stats.serving_stages()
        if self.kv_cache_dtype != "none":
            out["kv_quant"] = kv_quant_block(
                self.cache, self.kv_cache_dtype,
                kv_dequant_path(self.device), self.num_pages)
        usable = max(self.num_pages - 1, 1)
        in_use = usable - self.allocator.free_pages
        out["pool"] = {
            "num_pages": self.num_pages,
            "pages_in_use": int(in_use),
            "waiting_requests": len(self.waiting),
            "pressure": round(in_use / usable + len(self.waiting), 4)}
        out["requests"] = self.request_latency.summary()
        return out

    def audit_kv_sharing(self) -> Dict[str, int]:
        """Refcount-conservation audit: every slot's page-table row is
        exactly the pages the allocator says it owns, and every page's
        refcount equals the page-table rows that reach it.  Raises
        ``AssertionError`` on a leak; returns the allocator's counts."""
        for s, r in enumerate(self.slots):
            if r is None:
                continue
            row = [int(p) for p in self.page_table[s] if p >= 0]
            owned = self.allocator.owned_pages(s)
            assert row == owned, (
                f"slot {s}: page-table row {row} != allocator "
                f"ownership {owned}")
        return self.allocator.audit(external={})

    def cache_bytes(self) -> int:
        """Device bytes held by the paged KV pools (scales with
        ``num_pages``, not with ``max_seqs * max_seq_len``)."""
        return sum(p.nbytes() for p in self.cache)

    # -- host <-> device funnels (every transfer is counted and timed) ---

    def _upload(self, x: np.ndarray) -> torch.Tensor:
        with self.host_stats.stage("upload"):
            self.host_stats.meta_uploads += 1
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """Blocking device -> host copy: the serving loop's only sync
        point (``host_stats.blocking_gets`` counts them)."""
        with self.host_stats.stage("device"):
            self.host_stats.blocking_gets += 1
            return t.cpu().numpy()

    @torch.inference_mode()
    def _forward(self, token_ids, positions, meta: RaggedMeta,
                 logit_rows=None) -> torch.Tensor:
        """One paged forward over a ``[1, T]`` batch: every layer writes
        its rows into its pool and attends; logits of ``logit_rows``
        (all ``T`` rows when None)."""
        out = self.module(token_ids, positions=positions,
                          kv_cache=self.cache, ragged_meta=meta,
                          logit_rows=logit_rows)
        return out if logit_rows is not None else out[0]

    # -- the decode block -------------------------------------------------

    @torch.inference_mode()
    def _decode_block(self, sampled: bool, last_tok, pos, active, remaining,
                      page_table, eos_ids, do_sample, temperature, top_k,
                      top_p, seeds):
        """K decode ticks over ``[1, max_seqs]`` batches, enqueued on the
        current stream with no host read: write rows, ``kv_lens`` and
        positions derive from the carry on the device, sampling is
        batched and position-keyed on the device.  Finished rows park on
        the trash page.  Returns ``(toks [K,S], produced [K,S],
        last_tok [S])`` as device tensors."""
        page, max_len = self.page_size, self.max_seq_len
        table0 = page_table.clamp_min(0).long()
        toks, produced = [], []
        for _ in range(self.decode_block_size):
            dest_page = table0.gather(1, (pos // page)[:, None])[:, 0]
            dest = torch.where(active, dest_page * page + pos % page, 0)
            meta = RaggedMeta(
                kv_lens=torch.where(active, pos + 1, 1).int(),
                page_indices=page_table, cu_q_lens=self._block_cu,
                num_seqs=self._block_ns, new_kv_dest=dest)
            logits = self._forward(last_tok[None],
                                   torch.where(active, pos, 0)[None], meta)
            # position-keyed rows: the draw at cache position `pos` is
            # the fused tick's draw for the same (uid, position)
            keys = position_keys(self.seed, seeds, pos) if sampled else None
            nxt = sample_logits_batched(logits, keys, do_sample,
                                        temperature, top_k, top_p)
            nxt = torch.where(active, nxt, last_tok)
            hit_eos = active & (nxt == eos_ids)
            remaining = remaining - active.long()
            toks.append(nxt)
            produced.append(active)
            pos = torch.where(active, pos + 1, pos)
            active = (active & ~hit_eos & (remaining > 0) &
                      (pos + 1 < max_len))
            last_tok = nxt
        return torch.stack(toks), torch.stack(produced), last_tok

    def _block_arrays(self, reqs: List[Request]):
        """Host numpy decode-block state for ``reqs``."""
        S = self.max_seqs
        last_tok = np.asarray(self._last_tokens, np.int64)
        pos = np.zeros((S,), np.int64)
        active = np.zeros((S,), bool)
        remaining = np.zeros((S,), np.int64)
        eos_ids = np.full((S,), -1, np.int64)
        do_sample = np.zeros((S,), bool)
        temperature = np.ones((S,), np.float32)
        top_k = np.zeros((S,), np.int64)
        top_p = np.ones((S,), np.float32)
        seeds = np.zeros((S,), np.int64)   # per-row sampling key (uid)
        for r in reqs:
            s = r.slot
            pos[s] = min(r.length - 1, self.max_seq_len - 1)
            active[s] = True
            remaining[s] = r.max_new_tokens - len(r.generated)
            if r.eos_token_id is not None:
                eos_ids[s] = r.eos_token_id
            do_sample[s] = r.do_sample
            temperature[s] = r.temperature
            top_k[s] = r.top_k
            top_p[s] = r.top_p
            seeds[s] = r.uid
        return (last_tok, pos, active, remaining, eos_ids, do_sample,
                temperature, top_k, top_p, seeds)

    def _fold_block(self, reqs: List[Request], toks: np.ndarray,
                    mask: np.ndarray) -> int:
        """Fold one harvested [K, S] block into request state."""
        produced = 0
        for r in reqs:
            new = toks[mask[:, r.slot], r.slot]
            r.generated.extend(int(t) for t in new)
            produced += int(new.size)
            if new.size:
                self.request_latency.on_tokens(r.uid, len(r.generated))
        return produced

    def _step_decode_block(self, reqs: List[Request]) -> int:
        """Run one decode block and fold its tokens into the host request
        state: one metadata upload and one blocking copy per block."""
        st = self.host_stats
        K, S = self.decode_block_size, self.max_seqs
        with st.stage("plan"):
            arrays = self._block_arrays(reqs)
            sampled = bool(arrays[5].any())
        (last_tok, pos, active, remaining, eos_ids, do_sample, temperature,
         top_k, top_p, seeds) = [self._upload(a) for a in arrays]
        table = self._upload(self.page_table)
        with st.stage("dispatch"):
            st.dispatches += 1
            toks, mask, new_last = self._decode_block(
                sampled, last_tok, pos, active, remaining, table, eos_ids,
                do_sample, temperature, top_k, top_p, seeds)
            packed = torch.cat([toks.reshape(-1), mask.reshape(-1).long(),
                                new_last])
        st.ticks += K
        packed = self._fetch(packed)
        st.harvests += 1
        with st.stage("harvest"):
            toks = packed[:K * S].reshape(K, S)
            mask = packed[K * S:2 * K * S].reshape(K, S).astype(bool)
            self._last_tokens = np.array(packed[2 * K * S:], np.int64)
            produced = self._fold_block(reqs, toks, mask)
            for r in reqs:
                self._maybe_finish(r)
            self._reap()
        return produced

    # -- the scheduler tick ---------------------------------------------

    def step(self) -> int:
        """One engine iteration; returns the number of tokens produced.
        All-decoding batches take the K-tick decode block; any
        prefilling sequence falls back to the fused SplitFuse tick."""
        st = self.host_stats
        with st.stage("plan"):
            self._admit()
            live = [r for r in self.slots if r is not None and not r.done]
            decoding_ready = bool(live) and all(
                r.prefill_done >= r.ctx_len for r in live)
            all_decoding = (
                decoding_ready and self.decode_block_size > 1 and
                all(self._ensure_pages(
                    r.slot,
                    r.length + min(self.decode_block_size,
                                   r.max_new_tokens - len(r.generated)))
                    for r in live))
        if all_decoding:
            return self._step_decode_block(live)
        with st.stage("plan"):
            plan = self._plan_tick()
        if plan is None:
            self._reap()
            # every live sequence is page-stalled: evict the youngest as
            # a continuation so the rest (and the queue) can progress
            if self._stalled and live:
                if len(live) == 1 and not self.waiting:
                    raise RuntimeError(
                        "KV pool too small for the only live sequence "
                        f"(uid={live[0].uid}, needs "
                        f"{pages_for(live[0].length + 1, self.page_size)}"
                        f" pages of {self.allocator.num_pages - 1}) — "
                        "raise num_pages or lower max_new_tokens")
                self._evict(max(self._stalled, key=lambda r: r.uid))
            return 0
        (token_ids, positions, kv_lens, page_indices, cu_q_lens, num_seqs,
         new_kv_dest, sample_rows, samplers) = plan
        (token_ids, positions, kv_lens, page_indices, cu_q_lens, num_seqs,
         new_kv_dest, sample_rows) = [self._upload(a) for a in (
             token_ids[None].astype(np.int64),
             positions[None].astype(np.int64), kv_lens, page_indices,
             cu_q_lens, num_seqs, new_kv_dest.astype(np.int64),
             sample_rows.astype(np.int64))]
        meta = RaggedMeta(kv_lens, page_indices, cu_q_lens, num_seqs,
                          new_kv_dest)
        with st.stage("dispatch"):
            st.dispatches += 1
            sel_logits = self._forward(token_ids, positions, meta,
                                       sample_rows)
        st.ticks += 1
        produced = self._sample(sel_logits, samplers)
        self._reap()
        return produced

    def _admit(self) -> None:
        for i in range(self.max_seqs):
            if not self.waiting:
                break
            if self.slots[i] is not None:
                continue
            req = self.waiting[0]
            if req.ctx is None:
                req.ctx = req.prompt
            need = self._admit_need(req)
            if self.allocator.pages_for(need) > self.num_pages - 1:
                # defense in depth behind put_request's submit-time check:
                # an unschedulable head would deadlock the FIFO queue
                self.waiting.popleft()
                raise ValueError(
                    f"request uid={req.uid} needs "
                    f"{self.allocator.pages_for(need)} KV pages to admit "
                    f"({need} tokens) but the engine owns "
                    f"{self.num_pages - 1} usable pages — it can never "
                    "be scheduled, even after full eviction")
            if self.allocator.pages_for(need) > self.allocator.free_pages:
                break                      # FIFO: wait for pages to free
            self.waiting.popleft()
            req.slot = i
            req.prefill_done = 0
            self.slots[i] = req
            self.page_table[i, :] = -1
            self._attach_and_allocate(req, need)
            self.request_latency.on_admit(req.uid)

    def _attach_and_allocate(self, req: Request, need: int) -> None:
        """Build slot ``req.slot``'s page run for an admission covering
        ``need`` tokens: fresh pages only (the prefix cache's attaches
        are ROADMAP A9.3)."""
        n = self.allocator.pages_for(need)
        pages = self.allocator.grow(req.slot, n)
        self.page_table[req.slot, :n] = pages

    def _admit_need(self, req: Request) -> int:
        """Token coverage ``_admit`` reserves for ``req``."""
        ctx_len = req.ctx_len
        rem = max(req.max_new_tokens - len(req.generated), 1)
        if self.kv_reserve == "worst_case":
            # worst case INCLUDING re-prefilled output for evicted
            # continuations (their ctx carries earlier tokens)
            return ctx_len + req.max_new_tokens - len(req.generated)
        # on-demand: context + the first decode block; growth per block
        return ctx_len + min(self.decode_block_size, rem)

    def _ensure_pages(self, slot: int, upto_tokens: int) -> bool:
        """Grow ``slot``'s page run to cover ``upto_tokens`` cache
        positions; False when the pool can't (the sequence sits this
        tick out, or gets evicted)."""
        upto_tokens = min(upto_tokens, self.max_seq_len)
        need = pages_for(upto_tokens, self.page_size)
        have = self.allocator.owned(slot)
        if need <= have:
            return True
        if need - have > self.allocator.free_pages:
            return False
        pages = self.allocator.grow(slot, need - have)
        self.page_table[slot, have:have + len(pages)] = pages
        return True

    def _evict(self, r: Request) -> None:
        """Requeue ``r`` as a CONTINUATION: its pages return to the pool,
        and on re-admission it re-prefills prompt + its own generated
        tokens (greedy continuations are exact)."""
        self.allocator.free(r.slot)
        self.page_table[r.slot, :] = -1
        self.slots[r.slot] = None
        r.ctx = np.concatenate(
            [r.prompt, np.asarray(r.generated, np.int32)])
        r.prefill_done = 0
        r.slot = -1
        self.waiting.append(r)             # back of the queue: the freed
        self.evictions += 1                # pages go to older work first
        logger.info(f"ragged engine: evicted uid={r.uid} "
                    f"({r.ctx.size} ctx tokens) — KV pool exhausted; "
                    "requeued as continuation")

    def _flat_dest(self, slot: int, pos: int) -> int:
        page = self.page_table[slot, pos // self.page_size]
        assert page > 0, "write into unallocated page"
        return int(page) * self.page_size + pos % self.page_size

    def _plan_tick(self):
        """Host-side SplitFuse plan: one decode token per ready sequence
        plus prompt chunks for prefilling sequences, all in ONE batch."""
        self._stalled = []
        decode_rs = []
        for r in self.slots:
            if r is None or r.done or r.prefill_done < r.ctx_len:
                continue
            # the tick writes the last generated token at position
            # length-1, so pages must cover `length` tokens
            if self._ensure_pages(r.slot, r.length):
                decode_rs.append(r)
            else:
                self._stalled.append(r)    # out of pages: sit this tick out
        prefill_rs = sorted(
            (r for r in self.slots
             if r is not None and r.prefill_done < r.ctx_len),
            key=lambda r: r.uid)
        if not decode_rs and not prefill_rs:
            return None

        token_ids = np.zeros((self.T,), np.int32)
        positions = np.zeros((self.T,), np.int32)
        new_kv_dest = np.full((self.T,), 0, np.int32)   # trash page row 0
        kv_lens = np.zeros((self.max_seqs,), np.int32)
        # metadata rows are indexed by PACKED sequence number j, not slot
        page_indices = np.full((self.max_seqs, self.pages_per_seq), -1,
                               np.int32)
        cu_q_lens = np.zeros((self.max_seqs + 1,), np.int32)
        sample_rows = np.zeros((self.max_seqs,), np.int32)
        samplers: List[Tuple[Request, int, bool]] = []  # (req, seq_j, sample?)

        budget = self.T - len(decode_rs)
        takes: Dict[int, int] = {}
        for r in prefill_rs:
            take = min(budget, r.ctx_len - r.prefill_done)
            if take <= 0:
                continue                   # batch-budget-limited, not stalled
            if not self._ensure_pages(r.slot, r.prefill_done + take):
                # partial growth: cover what the pool allows this tick
                coverable = (self.allocator.owned(r.slot) +
                             self.allocator.free_pages) * self.page_size
                take = min(take, coverable - r.prefill_done)
                if take <= 0:
                    self._stalled.append(r)     # page-limited
                    continue
                self._ensure_pages(r.slot, r.prefill_done + take)
            takes[r.uid] = take
            budget -= take

        # pack sequences in slot order (the kernel sees sequences via
        # cu_q_lens row j)
        stalled_uids = {r.uid for r in self._stalled}
        t = 0
        j = 0
        for r in [s for s in self.slots if s is not None]:
            if r.done or r.uid in stalled_uids:
                continue
            if r.prefill_done >= r.ctx_len:                 # decode: 1 tok
                p = min(r.length - 1, self.max_seq_len - 1)
                token_ids[t] = self._last_tokens[r.slot]
                positions[t] = p
                new_kv_dest[t] = self._flat_dest(r.slot, p)
                page_indices[j] = self.page_table[r.slot]
                kv_lens[j] = p + 1
                cu_q_lens[j + 1] = cu_q_lens[j] + 1
                sample_rows[j] = t
                samplers.append((r, j, True))
                t += 1
                j += 1
            else:                                           # prefill chunk
                take = takes.get(r.uid, 0)
                if take <= 0:
                    continue
                lo = r.prefill_done
                token_ids[t:t + take] = r.ctx[lo:lo + take]
                pos = np.arange(lo, lo + take)
                positions[t:t + take] = pos
                pg = self.page_table[r.slot, pos // self.page_size]
                assert (pg > 0).all(), "write into unallocated page"
                new_kv_dest[t:t + take] = (pg * self.page_size +
                                           pos % self.page_size)
                r.prefill_done += take
                page_indices[j] = self.page_table[r.slot]
                kv_lens[j] = r.prefill_done
                cu_q_lens[j + 1] = cu_q_lens[j] + take
                finishes = r.prefill_done >= r.ctx_len
                if finishes:
                    self.request_latency.on_prefill_done(r.uid, r.ctx_len)
                sample_rows[j] = t + take - 1
                samplers.append((r, j, finishes))
                t += take
                j += 1
        cu_q_lens[j + 1:] = cu_q_lens[j]
        if j == 0:
            return None
        return (token_ids, positions, kv_lens, page_indices, cu_q_lens,
                np.asarray([j], np.int32), new_kv_dest, sample_rows,
                samplers)

    def _sample(self, sel_logits: torch.Tensor, samplers) -> int:
        """Sample every finishing row of a fused tick in one batched,
        position-keyed call on the device, then one host copy."""
        pairs = [(r, j) for r, j, wants in samplers if wants]
        if not pairs:
            return 0
        rows = self._upload(np.asarray([j for _, j in pairs], np.int64))
        reqs = [r for r, _ in pairs]
        cfg = [self._upload(np.asarray(v, dt)) for v, dt in (
            ([r.do_sample for r in reqs], bool),
            ([r.temperature for r in reqs], np.float32),
            ([r.top_k for r in reqs], np.int64),
            ([r.top_p for r in reqs], np.float32))]
        keys = None
        if any(r.do_sample for r in reqs):
            # (uid, position)-keyed: the draw for token n of request u is
            # the same whatever else is co-batched, and the same as the
            # decode block's draw at that position
            keys = position_keys(
                self.seed,
                self._upload(np.asarray([r.uid for r in reqs], np.int64)),
                self._upload(np.asarray([r.length - 1 for r in reqs],
                                        np.int64)))
        with torch.inference_mode():
            dev_toks = sample_logits_batched(sel_logits[rows], keys, *cfg)
        toks = self._fetch(dev_toks)
        produced = 0
        with self.host_stats.stage("harvest"):
            for r, tok in zip(reqs, toks):
                r.generated.append(int(tok))
                self._last_tokens[r.slot] = int(tok)
                produced += 1
                self.request_latency.on_tokens(r.uid, len(r.generated))
                self._maybe_finish(r)
        return produced

    def _maybe_finish(self, req: Request) -> None:
        if (len(req.generated) >= req.max_new_tokens or
                (req.eos_token_id is not None and req.generated and
                 req.generated[-1] == req.eos_token_id) or
                req.length >= self.max_seq_len):
            req.done = True

    def _reap(self) -> None:
        for i, r in enumerate(self.slots):
            if r is not None and r.done:
                self.finished.append(r)
                self.slots[i] = None
                self.allocator.free(i)
                self.page_table[i, :] = -1
                self.request_latency.on_finish(r.uid)

    # -- convenience ------------------------------------------------------

    def generate_all(self, prompts: List[np.ndarray], **kw
                     ) -> Dict[int, np.ndarray]:
        """Submit everything, run until drained (batch convenience API —
        the serving loop calls ``step`` itself)."""
        uids = set(self.put_request(p, **kw) for p in prompts)
        outs: Dict[int, np.ndarray] = {}
        while self.has_work():
            self.step()
            for uid, toks in self.get_outputs():
                if uid in uids:
                    outs[uid] = toks
                else:
                    # foreign request (submitted outside this call): keep
                    # it claimable by the caller's own get_outputs()
                    self._unclaimed[uid] = toks
        return outs
