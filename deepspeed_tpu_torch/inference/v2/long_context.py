"""Partial residency for long context: the tiered KV store as virtual
memory for attention.

Counterpart of ``deepspeed_tpu/inference/v2/long_context.py`` (copied and
adapted, not imported).  A live sequence whose KV outgrows the device
pool keeps only its first ``sink_pages`` and its most recent
``window_pages`` resident (the StreamingLLM observation: the hot set is
the sinks and a recent window); the middle is parked in groups of
``chunk_pages`` through the host and NVMe tiers (digest-verified,
quantized payloads carried as they are).  Parked columns become ``-1``
holes in the page table: the paged kernels skip them while the surviving
columns keep their true positions.

A tick over such a sequence is a chunked scan, LAYER-MAJOR (an ordering
by chunk would be wrong: layer l+1's queries need layer l's whole
output)::

    x = embed(tokens)
    for each layer l:
        carry = neutral
        for each parked group g:              # a staged [R] block
            carry = fold(carry, stats(q_l(x), staged KV of g))
        x = block_l(x, carry)                 # resident pages + carry,
                                              # writes this tick's KV
    logits = lm_head(norm(x))

A chunk dispatch attends a STAGED dense block, a non-destructive,
verified page-in (:meth:`~deepspeed_tpu_torch.inference.kv_tiering.
TieredKVStore.peek`) whose (layer, group) slices go from pinned host
memory into a small ring of device buffers, one slice at a time, so
that device memory does not grow with the parked middle.  It returns
flash stats ``(m, l, acc)`` (:meth:`LlamaBlock.chunk_stats
<deepspeed_tpu_torch.models.llama.LlamaBlock.chunk_stats>`).  The finish
dispatch is the block itself over the pool, whose paged kernel folds
the carry in (``ops/csrc/ragged_paged_attn.cu``).  A layer's q is
computed once for all its chunk dispatches.  With no parked group
the finish takes the plain path, as a fully resident engine does.

Prefill ticks take one page of prompt tokens, decode ticks one token.
LongContextDriver owns no device state beyond the ring: pages live in
the engine's pools, the parked middle in the engine's tier store under
``mid-<uid>-<g>``, and sampling is the engine's position-keyed sampler,
so seeded sampling repeats a fully resident run's draws.  The layers of
the packed tier layout are the engine's ``_page_views`` in pool order
(a layer's pages, then its scales for a 1-byte pool).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from deepspeed_tpu_torch.inference.paged import RaggedMeta, StagedKV
from deepspeed_tpu_torch.telemetry import trace

__all__ = ["LongContextDriver"]

# staged (layer, group) slices a tick keeps on the device: uploads and
# the dispatches that read them are ordered on one stream, so a slot is
# written again only after the dispatch before it has read it
_RING = 4


class LongContextDriver:
    """Ticks the partially resident (``Request.lc``) sequences of a
    :class:`~deepspeed_tpu_torch.inference.v2.RaggedInferenceEngineV2`;
    the engine makes one when ``kv_tiering.long_context`` is on."""

    def __init__(self, engine):
        from deepspeed_tpu_torch.models.llama import LlamaForCausalLM

        eng = engine
        t = eng._tier_cfg
        assert eng.tiering is not None and t.long_context, (
            "LongContextDriver needs kv_tiering.long_context=True")
        # tensor-parallel serving is refused by the engine itself (A7a)
        if eng.quantize_weights is not None:
            raise NotImplementedError(
                "long-context partial residency does not compose with "
                "quantize_weights yet: the chunked scan runs the model's "
                "layers one at a time on raw weights")
        if not isinstance(eng.module, LlamaForCausalLM):
            raise NotImplementedError(
                "long-context partial residency supports Llama-family "
                "models (LlamaForCausalLM: the chunked scan runs "
                "LlamaBlock layer by layer)")
        self.eng = eng
        self.cfg = eng.cfg
        self.L = int(self.cfg.num_hidden_layers)
        self.sink = int(t.sink_pages)
        self.chunk = int(t.chunk_pages)
        self.R = self.chunk * eng.page_size      # staged rows a dispatch
        pool = eng.cache[0]
        self._quant = pool.quantized
        self._kv_shape = (self.R,) + tuple(pool.pages.shape[2:])
        # each layer's leaves in the packed layout: (offset, width) of its
        # pages and, for a 1-byte pool, of its scale rows
        tier = eng.tiering
        per = 2 if self._quant else 1
        self._leaves = [[(tier.offsets[li], tier.widths[li])
                         for li in range(l * per, (l + 1) * per)]
                        for l in range(self.L)]
        # the device ring, byte views [_RING, chunk, width] per leaf
        self._ring = [torch.empty((_RING, self.chunk, w), dtype=torch.uint8,
                                  device=eng.device)
                      for _, w in self._leaves[0]]
        self._ring_next = 0
        self._kpos_cache: Dict[int, torch.Tensor] = {}
        # what a run did: ticks, chunk (staged-stats) dispatches, groups
        # parked
        self.ticks = 0
        self.staged_dispatches = 0
        self.parks = 0

    # -- residency bookkeeping -------------------------------------------

    def _window(self) -> int:
        # read fresh each tick: window_pages may change between ticks
        return max(int(self.eng._tier_cfg.window_pages), 1)

    @staticmethod
    def _key(r, g: int) -> str:
        return f"mid-{r.uid}-{g}"

    def _ensure_col(self, r, col: int) -> bool:
        eng = self.eng
        if eng.page_table[r.slot, col] >= 0:
            return True
        eng._reclaim_for(1)
        if eng.allocator.free_pages < 1:
            return False
        eng.page_table[r.slot, col] = eng.allocator.grow(r.slot, 1)[0]
        return True

    def _grow(self, r, lo: int, hi: int) -> bool:
        """Pages for write positions ``[lo, hi)``: always at or past the
        frontier, never a parked column.  False: the pool is dry this
        tick."""
        eng = self.eng
        for col in range(lo // eng.page_size,
                         (hi - 1) // eng.page_size + 1):
            if not self._ensure_col(r, col):
                others = any(s is not None and s is not r and not s.done
                             for s in eng.slots)
                if others or eng.waiting:
                    return False           # a reap may free pages; wait
                raise RuntimeError(
                    f"long-context resident window cannot grow for "
                    f"uid={r.uid}: the HBM pool "
                    f"({eng.num_pages - 1} usable pages) is exhausted "
                    "and the spill tiers can't take the parked middle — "
                    "raise num_pages, raise kv_tiering host_pages/"
                    "nvme_pages, or shrink sink_pages/window_pages/"
                    "chunk_pages")
        return True

    def _park(self, r, written: int, frontier_col: int) -> None:
        """Park every FULLY WRITTEN group whose columns lie wholly below
        ``frontier_col - window_pages`` in the tiers (group g is columns
        ``[sink + g*chunk, sink + (g+1)*chunk)``; parked groups are always
        a contiguous prefix of the middle)."""
        eng = self.eng
        window = self._window()
        while True:
            g = r.lc_parked
            col0 = self.sink + g * self.chunk
            end = col0 + self.chunk
            if end * eng.page_size > written:
                return                      # group not fully written yet
            if end > frontier_col - window:
                return                      # inside the resident window
            if not eng.tiering.can_spill(self.chunk):
                return                      # tiers full: stay resident
            pages = [int(p) for p in eng.page_table[r.slot, col0:end]]
            eng.tiering.spill(self._key(r, g), eng._gather_pages(pages),
                              self.chunk)
            eng.allocator.release_pages(r.slot, pages)
            eng.page_table[r.slot, col0:end] = -1
            r.lc_parked += 1
            self.parks += 1
            if trace.enabled:
                trace.event("lc_park", cat="kv", uid=r.uid, group=g,
                            pages=self.chunk,
                            parked_pages=r.lc_parked * self.chunk)

    def residency(self, r) -> Dict[str, int]:
        """Resident against parked pages of ``r``."""
        resident = int((self.eng.page_table[r.slot] >= 0).sum())
        return {"resident_pages": resident,
                "parked_pages": r.lc_parked * self.chunk}

    # -- staging -----------------------------------------------------------

    def _kpos(self, g: int) -> torch.Tensor:
        if g not in self._kpos_cache:
            lo = (self.sink + g * self.chunk) * self.eng.page_size
            self._kpos_cache[g] = torch.arange(
                lo, lo + self.R, dtype=torch.int64, device=self.eng.device)
        return self._kpos_cache[g]

    def _stage(self, work: torch.Tensor, l: int):
        """Layer ``l``'s slice of a peeked group (``work``: its packed
        bytes as ``[chunk, page_stride]`` uint8 on the host) uploaded into
        the next ring slot, page by page; returns ``(kv, scales)`` device
        views in the pool's dtypes."""
        k = self._ring_next
        self._ring_next = (k + 1) % _RING
        views = []
        for ring, (off, w) in zip(self._ring, self._leaves[l]):
            dst = ring[k]
            with self.eng.tiering.timers.stage("pagein_h2d"):
                for i in range(self.chunk):
                    dst[i].copy_(work[i, off:off + w], non_blocking=True)
            views.append(dst)
        pool = self.eng.cache[l]
        kv = views[0].view(pool.pages.dtype).view(self._kv_shape)
        scales = (views[1].view(torch.float32).view(self._kv_shape[:2])
                  if self._quant else None)
        return kv, scales

    # -- the tick ----------------------------------------------------------

    @torch.inference_mode()
    def tick(self, r) -> int:
        """One prefill chunk (``page_size`` prompt tokens) or one decode
        token of a partially resident sequence; returns the tokens
        produced (0 for a prefill tick that does not finish the prompt,
        or a tick sat out for pages)."""
        eng = self.eng
        page = eng.page_size
        prefilling = r.prefill_done < r.ctx_len
        if prefilling:
            lo = r.prefill_done
            take = min(page, r.ctx_len - lo)
            Tq = page
            tokens = np.zeros((Tq,), np.int64)
            tokens[:take] = r.ctx[lo:lo + take]
        else:
            lo = r.length - 1               # this tick's write position
            take = 1
            Tq = 1
            tokens = np.asarray([eng._last_tokens[r.slot]], np.int64)
        hi = lo + take                      # tokens written after the tick
        if not self._grow(r, lo, hi):
            return 0                        # pool dry: sit the tick out
        self._park(r, lo, (hi - 1) // page)

        qpos = np.full((Tq,), -1, np.int64)  # padding rows see no key
        qpos[:take] = np.arange(lo, hi)
        positions = np.zeros((Tq,), np.int64)
        positions[:take] = np.arange(lo, hi)

        n_parked = r.lc_parked
        groups: List[int] = []
        w = self.cfg.sliding_window
        for g in range(n_parked):
            if w is not None:
                kmax = (self.sink + (g + 1) * self.chunk) * page - 1
                if kmax <= lo - int(w):
                    continue                # out of the sliding window
            groups.append(g)
        tier = eng.tiering
        if n_parked:
            # read-ahead for THIS tick's peeks, bounded by the staging
            # ring; the re-issue at the end overlaps the NEXT tick
            tier.prefetch([self._key(r, g) for g in groups])
        # every peeked buffer lives until the stream has run the copies
        # out of it (the end of the tick)
        staged = {g: torch.from_numpy(tier.peek(self._key(r, g))).view(
                      self.chunk, tier.page_stride)
                  for g in groups}

        model = eng.module.model
        pos = eng._upload(positions[None])
        qpos_dev = eng._upload(qpos)
        dest = np.zeros((Tq,), np.int64)    # padding rows: trash page 0
        pos_r = np.arange(lo, hi)
        pg = eng.page_table[r.slot, pos_r // page]
        assert (pg > 0).all(), "write into an unallocated page"
        dest[:take] = pg * page + pos_r % page
        meta = RaggedMeta(
            kv_lens=eng._upload(np.asarray([hi], np.int32)),
            page_indices=eng._upload(eng.page_table[r.slot][None]),
            cu_q_lens=eng._upload(np.asarray([0, take], np.int32)),
            num_seqs=eng._upload(np.asarray([1], np.int32)),
            new_kv_dest=eng._upload(dest))
        st = eng.host_stats
        with st.stage("dispatch"):
            rope = model.rope(pos)
            x = model.embed_tokens(eng._upload(tokens[None]))
            for l, layer in enumerate(model.layers):
                meta.carry = None
                if groups:
                    # each group's slice staged just before its fold
                    blocks = (self._stage(staged[g], l) + (self._kpos(g),)
                              for g in groups)
                    meta.carry = layer.chunk_stats(x, pos, rope, RaggedMeta(
                        *[None] * 5, staged=StagedKV(blocks, qpos_dev)))
                x = layer(x, pos, rope, eng.cache[l], meta)
        n_chunk = len(groups) * self.L
        if trace.enabled:
            trace.event("lc_tick", cat="kv", uid=r.uid, q_tokens=take,
                        kv_len=int(hi), parked_groups=len(groups),
                        staged_dispatches=n_chunk)
        self.ticks += 1
        self.staged_dispatches += n_chunk
        st.dispatches += 1 + n_chunk
        st.ticks += 1

        finishes = prefilling and hi >= r.ctx_len
        produced = 0
        if prefilling:
            r.prefill_done = hi
            if finishes:
                eng.request_latency.on_prefill_done(r.uid, r.ctx_len, 0)
        if finishes or not prefilling:
            logits = eng.module.lm_head(model.norm(x[0, take - 1:take]))
            produced = eng._sample(logits, [(r, 0, True)])
        if staged:
            eng._sync()                     # the peeked buffers are free
        # read-ahead for the NEXT tick: decode revisits the same groups,
        # so the NVMe -> host copies overlap the host's sampling/planning
        if n_parked:
            tier.prefetch([self._key(r, g) for g in groups]
                          [:max(eng.prefetch_lookahead, 1)])
        return produced
