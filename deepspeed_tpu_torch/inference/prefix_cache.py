"""Cross-request prefix cache: a hash index over the paged-KV pool.

Copy of ``deepspeed_tpu/inference/prefix_cache.py`` (host-side Python, not
imported; its keys equal the reference's bit for bit).  The page table
already decouples logical position from physical pages; this module adds
the sharing layer on top, SGLang's RadixAttention observation that
identical token-id prefixes produce identical KV pages, so N requests
that send the same system prompt attend over ONE physical copy:

- token ids are chain-hashed at page granularity (vLLM's prefix-hash
  scheme: ``h_i = H(h_{i-1}, chunk_i)``), so a chunk's hash commits to
  the whole prefix before it, and page i of two sequences is shared only
  when tokens ``[0, (i+1)*page_size)`` match exactly;
- every index entry holds one allocator reference on its page, keeping
  the page resident after the request that prefilled it finishes;
- lookups VERIFY stored token ids against the query chunk before a page
  is attached: a hash collision degrades to a miss, never to
  cross-request KV corruption;
- under pool pressure, least-recently-used entries whose page nobody
  else references are demoted to the tiered KV store (keyed by prefix
  hash, not request uid: a spilled prefix restores once for all waiters)
  or dropped.

The index is host-side bookkeeping only; the engine owns the device
copies (copy-on-write) and the tier store.  Refcount rules live in
:class:`~deepspeed_tpu_torch.inference.paged.PageAllocator`.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from typing import (AbstractSet, Callable, FrozenSet, List, Optional,
                    Sequence, Tuple)

_EMPTY: FrozenSet[int] = frozenset()

# chain seed: hash of the empty prefix
ROOT_HASH = 0


def _chunk_hash(parent_hash: int, tokens: Tuple[int, ...]) -> int:
    """64-bit chain hash of one page-sized token chunk.  Module-level so
    adversarial tests can monkeypatch a colliding hash and prove that
    token-id verification — not hash uniqueness — is the safety
    contract."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent_hash.to_bytes(8, "little", signed=False))
    for t in tokens:
        h.update(int(t).to_bytes(4, "little", signed=True))
    return int.from_bytes(h.digest(), "little")


class PrefixEntry:
    """One fully-prefilled page of a hashed prefix chain."""

    __slots__ = ("key", "parent", "tokens", "page", "state", "hits")

    def __init__(self, key: int, parent: int, tokens: Tuple[int, ...],
                 page: Optional[int]):
        self.key = key
        self.parent = parent
        self.tokens = tokens
        self.page = page                    # physical page id when resident
        self.state = "resident" if page is not None else "spilled"
        self.hits = 0


class PrefixCacheIndex:
    """LRU index from chain hash -> :class:`PrefixEntry`.

    Holds one ``allocator`` reference per resident entry.  ``demote``
    and ``drop_spilled`` are engine-provided hooks (set after
    construction): ``demote(entry) -> bool`` moves a resident page's
    contents into the tiered store under the entry's tier key;
    ``drop_spilled(tier_key)`` deletes a demoted payload when its
    tombstone leaves the index.
    """

    def __init__(self, allocator, page_size: int, *,
                 max_entries: int = 1024, min_match_pages: int = 1):
        self.allocator = allocator
        self.page_size = page_size
        self.max_entries = max_entries
        self.min_match_pages = min_match_pages
        self._entries: "OrderedDict[int, PrefixEntry]" = OrderedDict()
        self.demote: Optional[Callable[[PrefixEntry], bool]] = None
        self.drop_spilled: Optional[Callable[[str], None]] = None
        # counters (engine folds these into serving_stages)
        self.lookups = 0
        self.hits = 0
        self.hit_pages = 0
        self.collisions = 0
        self.demotions = 0
        self.revivals = 0
        self.drops = 0

    # -- keys ---------------------------------------------------------------

    @staticmethod
    def tier_key(key: int) -> str:
        """Tiered-store key for a demoted prefix page — the prefix hash,
        NOT a request uid, so one restore serves every waiter."""
        return f"pfx-{key & (2 ** 64 - 1):016x}"

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: int) -> bool:
        return key in self._entries

    def get(self, key: int) -> Optional[PrefixEntry]:
        return self._entries.get(key)

    # -- lookup -------------------------------------------------------------

    def match(self, tokens: Sequence[int], *, touch: bool = True
              ) -> List[PrefixEntry]:
        """Longest verified chain prefix of ``tokens`` present in the
        index, as a list of entries (page i of the prefix at position
        i).  Only FULL pages participate; entries may be resident or
        spilled tombstones (the caller revives the latter).  Each
        entry's stored token ids are compared to the query chunk — a
        colliding hash with different tokens terminates the walk.
        ``touch=False`` keeps admission probes from perturbing LRU
        order (pipelined and unpipelined schedules must see the same
        index state)."""
        if touch:
            self.lookups += 1
        out: List[PrefixEntry] = []
        parent = ROOT_HASH
        page = self.page_size
        for lo in range(0, len(tokens) - page + 1, page):
            chunk = tuple(int(t) for t in tokens[lo:lo + page])
            key = _chunk_hash(parent, chunk)
            e = self._entries.get(key)
            if e is None or e.parent != parent:
                break
            if e.tokens != chunk:
                if touch:
                    self.collisions += 1
                break
            out.append(e)
            parent = key
        if len(out) < self.min_match_pages:
            return []
        if touch:
            for e in out:
                e.hits += 1
                self._entries.move_to_end(e.key)
            self.hits += 1
            self.hit_pages += len(out)
        return out

    # -- registration -------------------------------------------------------

    def register(self, parent: int, tokens: Sequence[int], page: int
                 ) -> int:
        """Record that resident ``page`` holds the KV for ``tokens``
        whose chain parent is ``parent``.  Takes one allocator ref on
        the page for a NEW entry; an existing entry with the same
        tokens is left canonical (the caller's private copy stays
        private).  Returns the chunk's chain hash."""
        chunk = tuple(int(t) for t in tokens)
        assert len(chunk) == self.page_size, (
            f"register needs one full page ({len(chunk)} tokens)")
        key = _chunk_hash(parent, chunk)
        e = self._entries.get(key)
        if e is not None:
            if e.tokens == chunk and e.parent == parent:
                if e.state == "spilled":
                    # a fresh resident copy supersedes the demoted
                    # payload: adopt the page, drop the tier entry
                    if self.drop_spilled is not None:
                        self.drop_spilled(self.tier_key(key))
                    e.page = page
                    e.state = "resident"
                    self.allocator.incref(page)
                    self.revivals += 1
                self._entries.move_to_end(key)
                return key
            # collision: different prefix hashed to the same key —
            # evict the old entry, the new registration wins
            self.collisions += 1
            self._drop(e)
        self._entries[key] = PrefixEntry(key, parent, chunk, page)
        self.allocator.incref(page)
        self._evict_overflow()
        return key

    def mark_spilled(self, e: PrefixEntry) -> None:
        """Entry's page was demoted to the tier store: drop the
        allocator ref, keep a tombstone so future matches revive it."""
        assert e.state == "resident"
        self.allocator.decref(e.page)
        e.page = None
        e.state = "spilled"
        self.demotions += 1

    def revive(self, e: PrefixEntry, page: int) -> None:
        """A spilled entry's payload was restored into fresh ``page``
        (caller already owns one ref for the index)."""
        assert e.state == "spilled"
        e.page = page
        e.state = "resident"
        self.revivals += 1

    # -- reclamation --------------------------------------------------------

    def reclaimable(self, exclude: AbstractSet[int] = _EMPTY) -> int:
        """Pages the index could hand back under pressure: resident
        entries nobody but the index references.  ``exclude`` holds
        entry keys a prospective admission is about to attach — they
        must not be counted as reclaimable for that same admission."""
        return sum(1 for e in self._entries.values()
                   if e.state == "resident" and e.key not in exclude
                   and self.allocator.refcount(e.page) == 1)

    def reclaim(self, n_pages: int,
                exclude: AbstractSet[int] = _EMPTY) -> int:
        """Free up to ``n_pages`` pool pages by demoting (or dropping)
        LRU resident entries whose page only the index holds.  Returns
        pages actually freed."""
        freed = 0
        for key in list(self._entries):
            if freed >= n_pages:
                break
            e = self._entries[key]
            if (e.state != "resident" or e.key in exclude
                    or self.allocator.refcount(e.page) != 1):
                continue
            if self.demote is not None and self.demote(e):
                self.mark_spilled(e)       # decref -> page back to free
            else:
                self._drop(e)
            freed += 1
        return freed

    def _drop(self, e: PrefixEntry) -> None:
        if e.state == "resident":
            self.allocator.decref(e.page)
        elif self.drop_spilled is not None:
            self.drop_spilled(self.tier_key(e.key))
        del self._entries[e.key]
        self.drops += 1

    def _evict_overflow(self) -> None:
        while len(self._entries) > self.max_entries:
            key = next(iter(self._entries))
            self._drop(self._entries[key])

    def clear(self) -> None:
        for key in list(self._entries):
            self._drop(self._entries[key])

    def stats(self) -> dict:
        resident = sum(1 for e in self._entries.values()
                       if e.state == "resident")
        return {
            "entries": len(self._entries),
            "resident_entries": resident,
            "spilled_entries": len(self._entries) - resident,
            "lookups": self.lookups,
            "hits": self.hits,
            "hit_pages": self.hit_pages,
            "hit_rate": round(self.hits / max(self.lookups, 1), 4),
            "collisions": self.collisions,
            "demotions": self.demotions,
            "revivals": self.revivals,
            "drops": self.drops,
        }
