"""The port's prefix cache (``inference/prefix_cache.py`` and its engine
half) against the JAX package's.

The index: ``_chunk_hash`` equals the reference's bit for bit, and the
port's and the JAX package's indexes, each over its own allocator, driven
through one ``register``/``match``/``reclaim``/``mark_spilled``/``revive``
script, give the same keys, entry states, page references and counters;
a colliding hash never shares a page.

Engines: the tiny fp32 Llama of ``torch_tier_helpers`` serves requests
sharing a two-page system prompt in both packages.  With the cache on,
pipeline on and off, the port's greedy tokens equal the JAX engine's and
its own cache-off run's, and its hit, hit-page, hit-token and COW counts
equal the JAX engine's; a full match (a prompt that is exactly the
prefix, and a verbatim repeat) copies its last page on write.  Also:
index pages demoted into the tiers and revived for later waiters, a
spilled sequence holding its shared prefix resident behind spill-holds,
``include_generated`` (multi-turn traffic hitting pages of generated
tokens), the ``min_match_pages`` floor, and the refcount audit after
every step and at the end of every run.  The JAX zero-new-compiles test
has no counterpart: the port compiles nothing per shape.
"""
import numpy as np
import pytest

import deepspeed_tpu_torch.inference.prefix_cache as pfx_mod
from deepspeed_tpu.inference import prefix_cache as jax_pfx
from deepspeed_tpu.inference.paged import PageAllocator as JaxAllocator
from deepspeed_tpu_torch.inference.paged import PageAllocator
from deepspeed_tpu_torch.inference.prefix_cache import (ROOT_HASH,
                                                        PrefixCacheIndex,
                                                        _chunk_hash)
from torch_tier_helpers import (PAGE, assert_same, jax_engine, port_engine,
                                serve, shared_prompts, weights)
import torch_cpu  # noqa: F401  (one torch thread a process)


@pytest.fixture(scope="module")
def w():
    return weights()


# -- the index -------------------------------------------------------------


def test_chunk_hash_equals_reference():
    r = np.random.default_rng(0)
    parent = ROOT_HASH
    assert ROOT_HASH == jax_pfx.ROOT_HASH
    for _ in range(4):
        chunk = tuple(int(t) for t in r.integers(-5, 2**20, size=PAGE))
        key = _chunk_hash(parent, chunk)
        assert key == jax_pfx._chunk_hash(parent, chunk)
        assert PrefixCacheIndex.tier_key(key) == \
            jax_pfx.PrefixCacheIndex.tier_key(key)
        parent = key


def _script(index_cls, alloc_cls):
    """One register/match/reclaim/demote/revive script over an index and
    its allocator; returns what each step showed."""
    al = alloc_cls(num_pages=12, page_size=PAGE)
    ix = index_cls(al, PAGE, max_entries=5, min_match_pages=1)
    demoted = []
    ix.demote = lambda e: demoted.append(e.key) or len(demoted) % 2 == 1
    ix.drop_spilled = lambda key: demoted.append(key)
    r = np.random.default_rng(1)
    toks = r.integers(1, 64, size=4 * PAGE)
    seen = []
    al.allocate(0, 4 * PAGE)
    parent = ROOT_HASH
    for k, page in enumerate(al.owned_pages(0)):
        parent = ix.register(parent, toks[k * PAGE:(k + 1) * PAGE], page)
        seen.append(parent)
    al.free(0)                           # the index keeps the pages
    hit = ix.match(np.concatenate([toks[:3 * PAGE], toks[:5]]))
    seen.append([(e.key, e.page, e.state) for e in hit])
    seen.append(ix.reclaimable(exclude={hit[0].key}))
    seen.append(ix.reclaim(3, exclude={hit[0].key}))
    seen.append(sorted((e.key, e.state, e.page)
                       for e in ix._entries.values()))
    spilled = next(e for e in ix._entries.values() if e.state == "spilled")
    page = al.take_page()
    ix.revive(spilled, page)
    resident = next(e for e in ix._entries.values()
                    if e.state == "resident" and e is not spilled)
    ix.mark_spilled(resident)
    # a re-registration of a spilled entry adopts the fresh page
    al.allocate(1, PAGE)
    again = ix.register(resident.parent, resident.tokens,
                        al.owned_pages(1)[0])
    seen.append(again == resident.key and resident.state)
    seen.append(sorted((e.key, e.state, e.page)
                       for e in ix._entries.values()))
    seen.append(ix.match(toks, touch=False) and len(ix.match(toks)))
    seen.append(demoted)
    seen.append(ix.stats())
    seen.append(al.audit()["referenced"])
    ix.clear()
    al.free(1)
    seen.append(al.audit()["free"])
    return seen


def test_index_script_equals_reference():
    assert _script(PrefixCacheIndex, PageAllocator) == _script(
        jax_pfx.PrefixCacheIndex, JaxAllocator)


def test_colliding_hash_never_shares(monkeypatch):
    monkeypatch.setattr(pfx_mod, "_chunk_hash", lambda parent, tokens: 7)
    al = PageAllocator(num_pages=6, page_size=PAGE)
    ix = PrefixCacheIndex(al, PAGE)
    al.allocate(0, PAGE)
    ix.register(ROOT_HASH, list(range(PAGE)), al.owned_pages(0)[0])
    assert ix.match(list(range(1, PAGE + 1))) == []
    assert ix.collisions == 1


# -- engines against the JAX package's -------------------------------------

# the sixth request repeats the first verbatim and the seventh is the
# system prompt alone: two full matches, each a COW and a one-token
# re-prefill; the rest diverge mid-page after the shared prefix
PROMPTS = shared_prompts(6, suffix=PAGE, repeat_of={5: 0})
PROMPTS.append(PROMPTS[1][:2 * PAGE].copy())


@pytest.mark.parametrize("pipeline", [False, True], ids=["unpiped", "piped"])
def test_prefix_cache_matches_jax_engine(w, pipeline):
    eng_kw = dict(pipeline=pipeline, num_pages=21)
    ref = jax_engine(w, prefix_cache=True, **eng_kw)
    want = serve(ref, PROMPTS, audit=False, max_new_tokens=20)
    off = serve(port_engine(w, **eng_kw), PROMPTS, max_new_tokens=20)
    eng = port_engine(w, prefix_cache=True, **eng_kw)
    got = serve(eng, PROMPTS, max_new_tokens=20)
    assert_same(got, want)
    assert_same(got, off)
    pc, ref_pc = (e.serving_stages()["prefix_cache"] for e in (eng, ref))
    for key in ("hit_requests", "miss_requests", "hit_tokens", "cow_copies",
                "hits", "hit_pages", "entries", "resident_entries"):
        assert pc[key] == ref_pc[key], key
    assert pc["cow_copies"] >= 2 and pc["hit_requests"] > 0
    rl = eng.request_latency.summary()
    assert rl["prefill_cached_tokens"] == pc["hit_tokens"] > 0
    assert (rl["prefill_computed_tokens"] + rl["prefill_cached_tokens"]
            == sum(p.size for p in PROMPTS))
    # only the index's resident entries outlive the drain
    assert eng.audit_kv_sharing()["referenced"] == pc["resident_entries"]
    eng.close()
    assert eng.allocator.audit(external={})["referenced"] == 0


def test_min_match_pages_gates_short_prefixes(w):
    eng = port_engine(w, prefix_cache={"min_match_pages": 2}, num_pages=21)
    serve(eng, shared_prompts(6, sys_pages=1), max_new_tokens=20)
    assert eng.serving_stages()["prefix_cache"]["hit_requests"] == 0


def test_composes_with_tiering_spill_holds(w):
    prompts = shared_prompts(6, suffix=10)
    off = serve(port_engine(w, num_pages=21), prompts, max_new_tokens=28)
    ref = jax_engine(w, prefix_cache=True, kv_tiering={"host_pages": 64})
    want = serve(ref, prompts, audit=False, max_new_tokens=28)
    eng = port_engine(w, prefix_cache=True, kv_tiering={"host_pages": 64})
    held = []
    spill = eng._spill

    def watched(r):
        ok = spill(r)
        held.append(ok and bool(r.spilled["shared_pages"]))
        return ok

    eng._spill = watched
    got = serve(eng, prompts, max_new_tokens=28)
    assert eng.spills == ref.spills > 0, "the pool forces spills"
    assert any(held), ("a spilled sequence with a shared prefix keeps its "
                       "shared pages resident behind spill-holds")
    assert eng.serving_stages()["prefix_cache"]["hit_requests"] == \
        ref.serving_stages()["prefix_cache"]["hit_requests"] > 0
    assert_same(got, want)
    assert_same(got, off)
    eng.close()


def test_demoted_prefix_revives_for_later_waiters(w):
    eng = port_engine(w, prefix_cache=True, kv_tiering={"host_pages": 64},
                      num_pages=21)
    serve(eng, shared_prompts(3, seed=5), max_new_tokens=20)
    ix = eng._pfx
    # pressure's stand-in: demote every reclaimable index page into the
    # tiers (keyed by prefix hash, not uid)
    assert ix.reclaim(ix.reclaimable()) >= 2
    assert ix.stats()["spilled_entries"] >= 2
    assert any(eng.tiering.holds(PrefixCacheIndex.tier_key(k))
               for k in ix._entries)
    eng.audit_kv_sharing()
    second = shared_prompts(2, seed=5)
    off = serve(port_engine(w, num_pages=21), second, max_new_tokens=20)
    on = serve(eng, second, max_new_tokens=20)
    st = ix.stats()
    assert st["revivals"] >= 2 and st["hits"] >= 2
    for a, b in zip([off[k] for k in sorted(off)],
                    [on[k] for k in sorted(on)]):
        np.testing.assert_array_equal(a, b)
    assert eng.tiering.stats()["pages_verified"] >= 2
    eng.audit_kv_sharing()
    eng.close()


def test_include_generated_multi_turn(w):
    """A second turn that resends the first turn's prompt and answer hits
    the pages of the generated tokens too."""
    (first,) = shared_prompts(1, suffix=PAGE)
    outs = {}
    for pkg, make in (("jax", jax_engine), ("port", port_engine)):
        eng = make(w, prefix_cache={"include_generated": True},
                   num_pages=21, pipeline=False)
        (turn1,) = serve(eng, [first], audit=False,
                         max_new_tokens=2 * PAGE).values()
        turn2 = np.concatenate([turn1, first[:5]])
        outs[pkg] = (turn1, serve(eng, [turn2], audit=False,
                                  max_new_tokens=8),
                     eng.serving_stages()["prefix_cache"])
        if pkg == "port":
            eng.audit_kv_sharing()
    (t1, o2, pc), (j1, j2, jpc) = outs["port"], outs["jax"]
    np.testing.assert_array_equal(t1, j1)
    assert_same(o2, j2)
    assert pc["hit_pages"] == jpc["hit_pages"] >= 4, (
        "two prompt pages and two of generated tokens")
