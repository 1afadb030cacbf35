"""Blocked (paged) KV cache for ragged continuous batching.

Counterpart of ``deepspeed_tpu/inference/paged.py``: KV lives in
fixed-size pages addressed through a per-sequence page table, so device
memory scales with the tokens in flight, and one fused token batch mixes
decode tokens with prefill chunks (Dynamic SplitFuse).

- :class:`PageAllocator` and :func:`pages_for` are the reference's host
  code, copied: free list, refcounts, ``grow`` / ``attach`` / ``cow`` /
  ``free``, and the conservation ``audit``.
- :func:`ref_paged_attention` and :func:`ref_paged_attention_quant` are
  the plain PyTorch versions of the two paged-attention kernels, with the
  reference's masking rules; the kernels themselves are in
  ``ops/ragged_paged_attention.py`` (``ops/csrc/ragged_paged_attn.cu``).
- :class:`PagedKVPool` is the write half of the reference's
  ``paged_update_and_attend``: one layer's page buffer (and scale rows for
  a quantized pool), written IN PLACE each tick.  JAX threads a fresh
  buffer through every step; here an out-of-place update would copy the
  whole pool per layer per tick.

Layout contract (the kernels'): pages are ``[P, page, 2*Hkv, D]`` with K
at even combined-head indices and V at odd; a tick's new K/V rows are
scattered into the flat page buffer BEFORE attention, and ``kv_lens``
includes this tick's tokens.  Page 0 is the trash page: padding tokens
write there, no sequence is ever allocated it.

The reference's chunked long-context scan (``carry``, ``fold_stats``,
``_staged_attend_stats``) is not ported yet: ROADMAP A9.5.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

import numpy as np
import torch

TRASH_PAGE = 0

# same mask-value family as ops/flash_attention.py: vanishes under
# softmax, (mask - mask) stays exactly 0
_MASK_VALUE = -0.7 * float(np.finfo(np.float32).max)

# kv_cache_dtype -> (page storage dtype, largest quantized magnitude)
QUANT_FORMATS = {"int8": (torch.int8, 127.0),
                 "fp8": (torch.float8_e4m3fn, 448.0),
                 "fp8_e4m3": (torch.float8_e4m3fn, 448.0)}
KV_CACHE_DTYPES = ("none", *QUANT_FORMATS)


def _no_carry(carry) -> None:
    if carry is not None:
        raise NotImplementedError(
            "the flash (m, l, acc) carry of the chunked long-context scan "
            "is not ported yet: ROADMAP A9.5")


# ---------------------------------------------------------------------------
# Host-side page allocator (copied from the reference)
# ---------------------------------------------------------------------------

def pages_for(n_tokens: int, page_size: int) -> int:
    """Pages needed to hold ``n_tokens`` (ceil-div, min 1) — the single
    rounding rule shared by the allocator and the engine's page-table
    sizing."""
    return -(-max(n_tokens, 1) // page_size)


class PageAllocator:
    """Free-list page allocator over ``num_pages`` fixed-size pages.

    Page 0 is reserved (trash page for padding-token writes).  Sequences
    either reserve their worst case (``prompt + max_new_tokens``) at
    admission or take pages as they grow via :meth:`grow`, with the
    engine's scheduler providing admission backpressure and eviction
    when the pool runs dry mid-flight.

    Pages are refcounted so a prefix cache can share one physical page
    across many sequences (copy-on-write model):

    - :meth:`allocate` / :meth:`grow` hand out pages at refcount 1 —
      never a page whose refcount is still > 0;
    - :meth:`attach` maps an already-resident page into another slot
      read-only (incref);
    - :meth:`free` is a per-page decref — the page returns to the free
      list only when the last reference drops;
    - :meth:`incref` / :meth:`decref` track references held outside any
      slot;
    - :meth:`cow` resolves a write to a shared page: a page at
      refcount 1 is already private, otherwise a fresh private page is
      granted and the old reference dropped (the device copy is the
      caller's job).
    """

    def __init__(self, num_pages: int, page_size: int):
        assert num_pages >= 2, "need at least one non-trash page"
        self.num_pages = num_pages
        self.page_size = page_size
        self._free: List[int] = list(range(num_pages - 1, TRASH_PAGE, -1))
        self._owned: Dict[int, List[int]] = {}     # slot -> page ids
        self._ref = np.zeros(num_pages, dtype=np.int64)  # per-page refcount

    def pages_for(self, n_tokens: int) -> int:
        return pages_for(n_tokens, self.page_size)

    @property
    def free_pages(self) -> int:
        return len(self._free)

    def can_allocate(self, n_tokens: int) -> bool:
        return self.pages_for(n_tokens) <= len(self._free)

    def _pop_fresh(self) -> int:
        page = self._free.pop()
        assert self._ref[page] == 0, (
            f"free list held page {page} with refcount {self._ref[page]}")
        self._ref[page] = 1
        return page

    def allocate(self, slot: int, n_tokens: int) -> List[int]:
        need = self.pages_for(n_tokens)
        assert slot not in self._owned, f"slot {slot} already allocated"
        assert need <= len(self._free), "out of KV pages"
        pages = [self._pop_fresh() for _ in range(need)]
        self._owned[slot] = pages
        return pages

    def owned(self, slot: int) -> int:
        return len(self._owned.get(slot, ()))

    def owned_pages(self, slot: int) -> List[int]:
        return list(self._owned.get(slot, ()))

    def grow(self, slot: int, n_pages: int) -> List[int]:
        """Extend ``slot`` by ``n_pages`` (on-demand growth; caller
        checks ``free_pages`` first — running dry here is a scheduler
        bug, not backpressure).  Granted pages are exclusively owned
        (refcount 1)."""
        assert n_pages <= len(self._free), "out of KV pages (grow)"
        pages = [self._pop_fresh() for _ in range(n_pages)]
        self._owned.setdefault(slot, []).extend(pages)
        return pages

    def attach(self, slot: int, pages: List[int]) -> None:
        """Map already-resident ``pages`` into ``slot`` read-only.  Must
        precede any :meth:`grow` for the slot so the slot's page list
        stays in logical-position order."""
        for p in pages:
            assert p != TRASH_PAGE and self._ref[p] >= 1, (
                f"attach of non-resident page {p} (ref={self._ref[p]})")
            self._ref[p] += 1
        self._owned.setdefault(slot, []).extend(pages)

    def take_page(self) -> int:
        """Grant one fresh page (refcount 1) to an external holder."""
        assert self._free, "out of KV pages (take_page)"
        return self._pop_fresh()

    def incref(self, page: int) -> None:
        """Add an external (non-slot) reference."""
        assert page != TRASH_PAGE and self._ref[page] >= 1, (
            f"incref of non-resident page {page}")
        self._ref[page] += 1

    def decref(self, page: int) -> None:
        assert self._ref[page] >= 1, f"decref of free page {page}"
        self._ref[page] -= 1
        if self._ref[page] == 0:
            self._free.append(page)

    def refcount(self, page: int) -> int:
        return int(self._ref[page])

    def cow(self, slot: int, k: int):
        """Resolve a write to ``slot``'s ``k``-th page.  Returns
        ``(old, new)``: ``old is new`` when the page was already private,
        otherwise ``new`` is a fresh private page already remapped in the
        slot's page list and the caller must copy ``old -> new`` on the
        device and update its page table."""
        old = self._owned[slot][k]
        if self._ref[old] == 1:
            return old, old
        assert len(self._free) >= 1, "out of KV pages (cow)"
        new = self._pop_fresh()
        self._owned[slot][k] = new
        self.decref(old)
        return old, new

    def release_pages(self, slot: int, pages: List[int]) -> None:
        """Release a specific subset of ``slot``'s pages while the slot
        stays live; the remaining pages keep their relative order."""
        owned = self._owned[slot]
        for p in pages:
            owned.remove(p)
            self.decref(p)

    def free(self, slot: int) -> None:
        for p in self._owned.pop(slot, ()):
            self.decref(p)

    def audit(self, external: Optional[Dict[int, int]] = None
              ) -> Dict[str, int]:
        """Conservation check for the pool.  Free pages and referenced
        pages partition the non-trash pool; every page's refcount is
        covered by slot ownership plus ``external`` references when the
        caller supplies that map.  Raises ``AssertionError`` on a leak or
        double-grant; returns the counts."""
        owned = [p for pages in self._owned.values() for p in pages]
        counts: Dict[int, int] = {}
        for p in owned:
            counts[p] = counts.get(p, 0) + 1
        if external:
            for p, n in external.items():
                counts[p] = counts.get(p, 0) + n
        free_set = set(self._free)
        assert len(free_set) == len(self._free), (
            f"free list duplicate: {sorted(p for p in free_set if self._free.count(p) > 1)}")
        assert TRASH_PAGE not in free_set and TRASH_PAGE not in counts, (
            "trash page entered circulation")
        ref_pages = {p for p in range(self.num_pages)
                     if self._ref[p] > 0}
        assert not (free_set & ref_pages), (
            f"page both free and referenced: {sorted(free_set & ref_pages)}")
        for p in range(1, self.num_pages):
            r = int(self._ref[p])
            c = counts.get(p, 0)
            if external is not None:
                assert r == c, (
                    f"page {p}: refcount {r} != {c} references "
                    "(page-table rows + external holds)")
            else:
                assert r >= c, (
                    f"page {p}: refcount {r} < {c} slot references")
            if r == 0:
                assert p in free_set, f"page leak: page {p} ref 0 not free"
        assert len(free_set) + len(ref_pages) == self.num_pages - 1, (
            f"page leak: {self.num_pages - 1 - len(free_set) - len(ref_pages)} "
            "pages neither free nor referenced")
        shared = sum(1 for p in ref_pages if self._ref[p] > 1)
        return {"free": len(self._free), "owned": len(owned),
                "total": self.num_pages - 1, "shared": shared,
                "referenced": len(ref_pages)}


# ---------------------------------------------------------------------------
# Plain versions of the paged-attention kernels
# ---------------------------------------------------------------------------

def _token_layout(T: int, kv_lens: torch.Tensor, cu_q_lens: torch.Tensor,
                  num_seqs: torch.Tensor):
    """Per token: its sequence row, whether it is a real token (before
    ``cu_q_lens[num_seqs]``) and its absolute position in the sequence."""
    S = kv_lens.shape[0]
    t_idx = torch.arange(T, device=kv_lens.device)
    cu = cu_q_lens.long()
    seq_of_t = (t_idx[:, None] >= cu[None, 1:]).sum(dim=1)
    token_valid = t_idx < cu[num_seqs.long()[0]]
    seq_of_t = seq_of_t.clamp(max=S - 1)
    q_len = cu[1:] - cu[:-1]
    q_pos = ((kv_lens.long() - q_len)[seq_of_t] +
             (t_idx - cu[:-1][seq_of_t]))
    return seq_of_t, token_valid, q_pos


def ref_paged_attention(q: torch.Tensor, pages: torch.Tensor,
                        kv_lens: torch.Tensor, page_indices: torch.Tensor,
                        cu_q_lens: torch.Tensor, num_seqs: torch.Tensor, *,
                        sm_scale: float, sliding_window: Optional[int] = None,
                        carry=None) -> torch.Tensor:
    """Ragged paged attention over full-width pages, in fp32: the
    reference's mask-based formulation over the flat page buffer.

    q: ``[T, H, D]``; pages: ``[P, page, 2*Hkv, D]``; kv_lens ``[S]``;
    page_indices ``[S, pp]`` (-1 pads unused entries and marks interior
    holes: such columns never attend, and the surviving columns keep
    their positions, since a key's position is ``column * page + row``);
    cu_q_lens ``[S+1]``; num_seqs ``[1]``.  Tokens past
    ``cu_q_lens[num_seqs]`` give 0; masking is causal on absolute
    positions, plus the optional sliding window.  Returns ``[T, H, D]``
    in q's dtype.  O(T * P * page): test and check scale."""
    _no_carry(carry)
    T, H, D = q.shape
    P, page, combined, _ = pages.shape
    Hkv = combined // 2
    S, pp = page_indices.shape
    dev = q.device
    k_flat = pages[:, :, 0::2, :].reshape(P * page, Hkv, D).float()
    v_flat = pages[:, :, 1::2, :].reshape(P * page, Hkv, D).float()
    rows = torch.arange(P * page, device=dev)
    page_of_r, pos_in_page = rows // page, rows % page

    seq_of_t, token_valid, q_pos = _token_layout(T, kv_lens, cu_q_lens,
                                                 num_seqs)
    match = page_indices.long()[:, :, None] == page_of_r[None, None, :]
    owned = match.any(dim=1)                                       # [S, R]
    kvpos = (torch.where(match, torch.arange(pp, device=dev)[None, :, None],
                         0).sum(dim=1) * page + pos_in_page[None, :])
    kv_t = kvpos[seq_of_t]                                         # [T, R]
    mask = owned[seq_of_t] & (kv_t <= q_pos[:, None]) & token_valid[:, None]
    if sliding_window is not None:
        mask = mask & (kv_t > q_pos[:, None] - sliding_window)

    groups = H // Hkv
    k_r = k_flat.repeat_interleave(groups, dim=1)
    v_r = v_flat.repeat_interleave(groups, dim=1)
    att = torch.einsum("thd,rhd->htr", q.float(), k_r) * sm_scale
    att = att.masked_fill(~mask[None], _MASK_VALUE)
    p = torch.softmax(att, dim=-1)
    y = torch.einsum("htr,rhd->thd", p, v_r)
    return torch.where(token_valid[:, None, None], y, 0.0).to(q.dtype)


def ref_paged_attention_quant(q: torch.Tensor, pages: torch.Tensor,
                              scales: torch.Tensor, kv_lens: torch.Tensor,
                              page_indices: torch.Tensor,
                              cu_q_lens: torch.Tensor,
                              num_seqs: torch.Tensor, *, sm_scale: float,
                              sliding_window: Optional[int] = None,
                              carry=None) -> torch.Tensor:
    """Ragged paged attention over a QUANTIZED pool: gather each
    sequence's attended pages (still 1-byte) through its page-table row,
    dequantize only the gathered rows, then masked attention, one
    sequence at a time.  The dequantized intermediate is
    ``[pp*page, 2*Hkv, D]``, bounded by the pages a sequence attends,
    never the ``[P, ...]`` pool.  Rows sit at their kv position, so
    masking is ``row < kv_len``, the causal bound and the column's
    validity (a -1 entry gathers the trash page, whose rows must not
    attend).  Reads the metadata on the host.

    q: ``[T, H, D]``; pages: ``[P, page, 2*Hkv, D]`` int8 or
    float8_e4m3fn; scales: ``[P, page, 2*Hkv]`` fp32.  Other arguments
    and the return value as :func:`ref_paged_attention`."""
    _no_carry(carry)
    T, H, D = q.shape
    P, page, combined, _ = pages.shape
    Hkv = combined // 2
    groups = H // Hkv
    S, pp = page_indices.shape
    R = pp * page
    r_idx = torch.arange(R, device=q.device)
    cu = cu_q_lens.tolist()
    lens = kv_lens.tolist()
    out = torch.zeros(T, H, D, dtype=torch.float32, device=q.device)
    for j in range(min(int(num_seqs[0]), S)):
        t0, t1 = cu[j], cu[j + 1]
        if t1 <= t0:
            continue
        safe = page_indices[j].long().clamp_min(0)
        kv = (pages[safe].float() * scales[safe].float()[..., None]
              ).reshape(R, combined, D)
        k, v = kv[:, 0::2, :], kv[:, 1::2, :]                  # [R, Hkv, D]
        q_pos = lens[j] - (t1 - t0) + torch.arange(t1 - t0, device=q.device)
        col_valid = (page_indices[j] >= 0).repeat_interleave(page)
        mask = ((r_idx[None, :] <= q_pos[:, None]) &
                (r_idx[None, :] < lens[j]) & col_valid[None, :])
        if sliding_window is not None:
            mask = mask & (r_idx[None, :] > q_pos[:, None] - sliding_window)
        qg = q[t0:t1].float().reshape(t1 - t0, Hkv, groups, D)
        att = torch.einsum("nhgd,rhd->hgnr", qg, k) * sm_scale
        att = att.masked_fill(~mask, _MASK_VALUE)
        p = torch.softmax(att, dim=-1)
        out[t0:t1] = torch.einsum("hgnr,rhd->nhgd", p, v).reshape(
            t1 - t0, H, D)
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# One layer's page pool: the write half of paged_update_and_attend
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RaggedMeta:
    """One tick's ragged metadata, as device tensors: ``kv_lens [S]``,
    ``page_indices [S, pp]``, ``cu_q_lens [S+1]``, ``num_seqs [1]`` (all
    int32) and ``new_kv_dest [T]`` (int64 flat page rows to write)."""

    kv_lens: torch.Tensor
    page_indices: torch.Tensor
    cu_q_lens: torch.Tensor
    num_seqs: torch.Tensor
    new_kv_dest: torch.Tensor


class PagedKVPool:
    """One attention layer's KV page buffer.

    ``pages [P, page, 2*Hkv, D]`` in the model dtype (``fmt="none"``) or
    1-byte (``"int8"``, ``"fp8"``/``"fp8_e4m3"`` as float8_e4m3fn) with
    ``scales [P, page, 2*Hkv]`` fp32.  :meth:`write` scatters a tick's
    K/V rows in place; quantize-on-write follows the reference
    (``paged.py:560-578``): one scale per (row, combined head), floored
    at the smallest normal fp32 so its reciprocal never overflows."""

    def __init__(self, num_pages: int, page_size: int, kv_heads: int,
                 head_dim: int, fmt: str, dtype: torch.dtype,
                 device: torch.device):
        if fmt not in KV_CACHE_DTYPES:
            raise ValueError(f"kv_cache_dtype must be one of "
                             f"{KV_CACHE_DTYPES}, got {fmt!r}")
        self.fmt = fmt
        store, self.qmax = QUANT_FORMATS.get(fmt, (dtype, None))
        shape = (num_pages, page_size, 2 * kv_heads, head_dim)
        self.pages = torch.zeros(shape, dtype=store, device=device)
        self.scales = (None if self.qmax is None else
                       torch.zeros(shape[:3], dtype=torch.float32,
                                   device=device))

    @property
    def quantized(self) -> bool:
        return self.scales is not None

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for t in (self.pages, self.scales) if t is not None)

    def write(self, k: torch.Tensor, v: torch.Tensor,
              new_kv_dest: torch.Tensor) -> None:
        """Scatter ``k``, ``v`` ``[T, Hkv, D]`` into flat page rows
        ``new_kv_dest [T]``: K at even combined heads, V at odd.
        Padding tokens all point at the trash page's row 0; which of them
        lands there does not matter."""
        P, page, combined, D = self.pages.shape
        T = k.shape[0]
        rows = torch.stack([k, v], dim=2).reshape(T, combined, D)
        flat = self.pages.view(P * page, combined, D)
        if self.qmax is None:
            flat.index_copy_(0, new_kv_dest, rows.to(flat.dtype))
            return
        cf = rows.float()
        absmax = cf.abs().amax(dim=-1)                         # [T, 2Hkv]
        scale = torch.clamp_min(absmax / self.qmax,
                                float(np.finfo(np.float32).tiny))
        qv = cf / scale[..., None]
        if self.pages.dtype == torch.int8:
            qv = torch.clamp(torch.round(qv), -self.qmax, self.qmax)
        # float8 has no index_copy_ on every backend: scatter its bytes
        flat.view(torch.uint8).index_copy_(
            0, new_kv_dest, qv.to(flat.dtype).view(torch.uint8))
        self.scales.view(P * page, combined).index_copy_(0, new_kv_dest,
                                                         scale)


def kv_dequant_path(device: torch.device) -> str:
    """The read route a quantized pool takes on ``device``: the CUDA
    kernel ``ragged_paged_attention_quant`` on the card, the plain
    gathered-pages version on the CPU.  Neither widens the pool.  The
    engine reports it in ``serving_stages()['kv_quant']``."""
    return "cuda-quant" if torch.device(device).type == "cuda" \
        else "torch-gather"
