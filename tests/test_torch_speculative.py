"""The port's speculative decoding (v2 ``speculation``, n-gram and
draft-model) against the JAX package's.

Mirrors ``tests/unit/test_speculative.py`` on its models: the tiny fp32
Llama of ``torch_tier_helpers`` (vocab 64, width 32, 2 layers) and a
draft of width 16 and 1 layer, each one flax tree through the weight
bridge, at that file's engine settings (3 slots, 4-tick blocks, a
harvest every 3) with pages of 16.

- ``sampling.speculative_verify``: greedy rows equal the JAX function's
  ``(out_toks, accept_len)`` exactly on the same logits; sampled rows
  reproduce the filtered target distribution by Monte-Carlo (40000
  trials, atol 0.012, the reference's) for point-mass and draft
  proposals and under top-k/top-p.  The port draws from keys, so its
  trials are rows with distinct uids.
- The speculative block's carry, tokens, mask and counts equal the JAX
  ``_spec_block_fn(False)``'s on the same inputs (fresh pools), n-gram
  (with its history) and draft.
- Greedy engine runs: the port with speculation on equals the port with
  it off and the JAX engine with it on, token for token, for n-gram with
  mid-run admissions, draft and self-draft, pipeline on and off; and on
  the reference's edge cases (eviction backpressure, k beyond the
  remaining budget, the ``max_seq_len`` cap mid-chunk, an early eos,
  rollback across a harvest window).
- Sampled runs are bit-identical with the pipeline on and off (n-gram
  and draft), and through the graphs' static buffers; greedy slots
  among sampled ones equal speculation off.
- A pipelined speculative run fetches fewer times than it dispatches and
  reports ``serving_stages()["speculation"]``; config and validation;
  the compositions the reference tests (int8 pools, the prefix cache,
  tiering), each equal to speculation off with the audits clean.
- The plain paged attention with ``kv_lens`` past the page table's span
  (a verify tick near ``max_seq_len``) equals the same call over a wider
  table whose extra columns are holes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.inference import sampling as jsampling
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference import paged, sampling
from deepspeed_tpu_torch.inference.config import SpeculationConfig
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from torch_tier_helpers import (TINY, assert_same, prompts, serve,
                                shared_prompts, weights)
import torch_cpu  # noqa: F401  (one torch thread a process)

DTINY = dict(TINY, hidden_size=16, intermediate_size=32, num_hidden_layers=1,
             num_attention_heads=2, num_key_value_heads=1)
# the reference file's engine (page size 16: the port's kernels take 16+)
SPEC = dict(max_seqs=3, max_seq_len=128, prefill_chunk=8, page_size=16,
            decode_block_size=4, harvest_interval=3)
SAMPLED = dict(max_new_tokens=9, do_sample=True, temperature=0.8, top_k=8,
               top_p=0.9)


@pytest.fixture(scope="module")
def w():
    out = weights()
    dcfg = jax_llama.LlamaConfig(**DTINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32, remat=False,
                                 scan_layers=False,
                                 use_flash_attention=False)
    dparams = jax_llama.LlamaForCausalLM(dcfg).init(
        jax.random.PRNGKey(9), jnp.zeros((1, 8), jnp.int32))
    dparams = jax.tree_util.tree_map(np.asarray, dparams)
    out.update(dcfg=dcfg, dparams=dparams,
               dstate=flax_to_state_dict(dparams))
    return out


def _port_model(cfg=TINY):
    with torch.device("meta"):
        return llama.LlamaForCausalLM(
            llama.LlamaConfig(**cfg, dtype=torch.float32))


def port(w, spec="off", draft=None, **kw):
    """A port engine; ``draft``: "draft" (the small draft) or "self"."""
    if draft is not None:
        kw.update(draft_model=_port_model(DTINY if draft == "draft"
                                          else TINY),
                  draft_params=w["dstate" if draft == "draft" else "state"])
    return RaggedInferenceEngineV2(_port_model(), params=w["state"],
                                   device="cpu", speculation=spec,
                                   **{**SPEC, **kw})


def jax_eng(w, spec="off", draft=None, **kw):
    if draft is not None:
        kw.update(draft_model=jax_llama.LlamaForCausalLM(
            w["dcfg"] if draft == "draft" else w["cfg"]),
            draft_params=w["dparams" if draft == "draft" else "params"])
    return JaxEngine(jax_llama.LlamaForCausalLM(w["cfg"]),
                     params=w["params"], speculation=spec,
                     rng=jax.random.PRNGKey(11), **{**SPEC, **kw})


def drive(eng, sizes, mid=None, audit=True, **req_kw):
    """The reference's ``_serve``: ``sizes`` submitted first, ``mid`` maps
    a step index to prompts submitted then.  Audits a port engine's pool
    after every step."""
    for p in prompts(sizes):
        eng.put_request(p, **req_kw)
    mid = dict(mid or {})
    outs, step = {}, 0
    while eng.has_work() or mid:
        for p in mid.pop(step, []):
            eng.put_request(p, **req_kw)
        if eng.has_work():
            eng.step()
            outs.update(eng.get_outputs())
            if audit:
                eng.audit_kv_sharing()
        step += 1
    outs.update(eng.get_outputs())
    return outs


# -- speculative_verify against the JAX function -----------------------------

def test_greedy_verify_equals_jax():
    r = np.random.default_rng(6)
    S, K1, V = 7, 4, 8
    logits = r.normal(size=(S, K1, V)).astype(np.float32)
    greedy = logits.argmax(-1)
    draft = r.integers(0, V, size=(S, K1 - 1))
    draft[:3] = greedy[:3, :K1 - 1]               # full and partial matches
    draft[1, 2] = (greedy[1, 2] + 1) % V
    args = (np.zeros(S, bool), np.ones(S, np.float32), np.zeros(S, np.int32),
            np.ones(S, np.float32))
    want = jsampling.speculative_verify(
        jnp.asarray(logits), jnp.asarray(draft, jnp.int32), None, None,
        *map(jnp.asarray, args))
    got = sampling.speculative_verify(
        torch.from_numpy(logits), torch.from_numpy(draft), None, None,
        *map(torch.from_numpy, args))
    for g, w_ in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w_))
    assert got[1].tolist()[:3] == [3, 2, 3]


class TestVerifyDistribution:
    """The accept / residual-resample core leaves the output distributed
    as the target's filtered distribution (the reference's oracle)."""

    N, V, K = 40000, 8, 3

    def _freq(self, seed, target_logits, draft_probs=None, temperature=0.7,
              top_k=0, top_p=1.0):
        N, V, K = self.N, self.V, self.K
        r = np.random.default_rng(seed)
        logits = torch.from_numpy(target_logits).expand(N, K + 1, V)
        if draft_probs is None:
            # point mass: any fixed proposal samples its own delta
            draft = torch.from_numpy(r.integers(0, V, size=(1, K))).expand(
                N, K)
            q = None
        else:
            # the theorem needs d ~ q: each trial draws its proposals
            cum = np.cumsum(draft_probs, axis=-1)
            u = r.random((N, K, 1))
            draft = torch.from_numpy(
                np.minimum((u > cum[None]).sum(-1), V - 1))
            q = torch.from_numpy(draft_probs).expand(N, K, V)
        # each trial is a request of its own: distinct uids, so distinct
        # keys at the same positions
        keys = sampling.position_keys(
            seed, torch.arange(N)[:, None].expand(N, K + 1),
            torch.arange(K + 1)[None, :].expand(N, K + 1))
        out, _ = sampling.speculative_verify(
            logits, draft, q, keys, torch.ones(N, dtype=torch.bool),
            torch.full((N,), temperature), torch.full((N,), top_k),
            torch.full((N,), top_p))
        freq = np.bincount(out[:, 0].numpy(), minlength=V) / N
        flt = sampling.filter_logits_batched(
            torch.from_numpy(target_logits[:1]),
            torch.tensor([temperature]), torch.tensor([top_k]),
            torch.tensor([top_p]))
        return freq, torch.softmax(flt, dim=-1)[0].numpy()

    def test_point_mass_draft(self):
        t = np.random.default_rng(0).normal(
            size=(self.K + 1, self.V)).astype(np.float32)
        freq, expect = self._freq(1, t)
        np.testing.assert_allclose(freq, expect, atol=0.012)

    def test_draft_distribution(self):
        r = np.random.default_rng(2)
        t = r.normal(size=(self.K + 1, self.V)).astype(np.float32)
        q = torch.softmax(torch.from_numpy(r.normal(
            size=(self.K, self.V)).astype(np.float32)), dim=-1).numpy()
        freq, expect = self._freq(3, t, draft_probs=q)
        np.testing.assert_allclose(freq, expect, atol=0.012)

    def test_top_k_top_p(self):
        t = np.random.default_rng(4).normal(
            size=(self.K + 1, self.V)).astype(np.float32)
        freq, expect = self._freq(5, t, temperature=0.9, top_k=4, top_p=0.8)
        assert (freq[expect == 0] == 0).all(), "drew a filtered token"
        np.testing.assert_allclose(freq, expect, atol=0.012)


# -- the speculative block against the JAX block ------------------------------

@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_block_carry_matches_jax(w, mode):
    """One greedy block over the same inputs on fresh pools: a slot whose
    budget runs out mid-block, one that runs through over a repeating
    history, an inactive one and one that reaches ``max_seq_len``
    mid-chunk.  Carry, tokens, mask and the proposed/accepted counts are
    equal, and the n-gram history too.  In draft mode each tick's first
    draft step of the port also writes the draft's row one below the
    cursor (``test_self_draft_kv_tracks_the_target``), where the
    reference's draft reads what its pool held: the JAX block runs over
    the draft pool the port's block left, which holds the same token's
    row there, and every row the JAX draft reads later it writes itself
    first, except after a tick that accepts every proposal (the stale
    row): this block has none."""
    S, L = 4, 64
    kw = dict(max_seqs=S, max_seq_len=L, pipeline=False)
    draft = "draft" if mode == "draft" else None
    jeng = jax_eng(w, mode, draft, **kw)
    eng = port(w, mode, draft, **kw)
    pp = eng.pages_per_seq
    table = (1 + np.arange(S * pp, dtype=np.int32)).reshape(S, pp)
    rng = np.random.default_rng(0)
    hist = np.zeros((S, L + 1), np.int64)
    hist[0, :6] = rng.integers(1, 64, 6)
    hist[1, :31] = np.tile([5, 9, 13, 7, 21, 9, 13], 5)[:31]
    hist[3, :L - 3] = rng.integers(1, 64, L - 3)
    inputs = dict(
        last_tok=np.asarray([17, 21, 0, 33]),
        pos=np.asarray([5, 30, 0, L - 4]),
        active=np.asarray([True, True, False, True]),
        remaining=np.asarray([3, 40, 0, 50]),
        page_table=table, eos_ids=np.full(S, -1),
        do_sample=np.zeros(S, bool), temperature=np.ones(S, np.float32),
        top_k=np.zeros(S), top_p=np.ones(S, np.float32), seeds=np.arange(S))
    order = ("last_tok", "pos", "active", "remaining", "page_table",
             "eos_ids", "do_sample", "temperature", "top_k", "top_p")
    jin = [jnp.asarray(inputs[n].astype(np.int32)
                       if inputs[n].dtype.kind == "i" else inputs[n])
           for n in order]
    dtypes = {"page_table": np.int32, "active": bool, "do_sample": bool,
              "temperature": np.float32, "top_p": np.float32}
    thist = torch.from_numpy(hist.copy())
    got = [t.numpy() for t in eng._spec_block(False, thist, *[
        torch.from_numpy(np.asarray(inputs[n], dtype=dtypes.get(n, np.int64)))
        for n in order + ("seeds",)])]
    dcache = jeng._draft_cache
    if mode == "draft":
        leaves, tree = jax.tree_util.tree_flatten(dcache)
        assert len(leaves) == len(eng._draft_cache) == 1   # one layer
        dcache = jax.tree_util.tree_unflatten(
            tree, [jnp.asarray(eng._draft_cache[0].pages.numpy())])
    out = jeng._spec_block_fn(False)(
        jeng.params, jeng._draft_params, jeng.cache, dcache,
        jnp.asarray(hist[:, :L].astype(np.int32)), *jin,
        jax.random.PRNGKey(0))
    want = [np.asarray(x) for x in out[2:]]
    K, K1 = SPEC["decode_block_size"], jeng.spec_k + 1
    assert want[6].reshape(K, K1, S).sum(axis=1).max() < K1
    if mode == "ngram":
        np.testing.assert_array_equal(thist[:, :L].numpy(), want[0],
                                      err_msg="hist")
    names = ("last_tok", "pos", "active", "remaining", "toks", "mask",
             "prop", "accd")
    for name, g, w_ in zip(names, got, want[1:]):
        np.testing.assert_array_equal(g, w_.astype(g.dtype), err_msg=name)
    assert got[4].shape == (K * K1, S)
    assert got[3][0] == 0 and not got[2][0]          # budget ran out
    assert got[1][3] == L - 1 and not got[2][3]      # capped at max_seq_len
    assert got[6] > 0


# -- greedy: spec on == spec off == the JAX engine's spec on -----------------

MID = {4: prompts([7], seed=9), 9: prompts([13], seed=10)}


@pytest.mark.parametrize("mode,draft,sizes,mid,new", [
    ("ngram", None, [5, 11, 3], MID, 10),
    ("draft", "draft", [5, 11, 3], None, 10),
    ("draft", "self", [5, 9], None, 16),
], ids=["ngram_midrun", "draft", "self_draft"])
def test_greedy_equals_off_and_jax(w, mode, draft, sizes, mid, new):
    want = drive(jax_eng(w, mode, draft), sizes, mid, audit=False,
                 max_new_tokens=new)
    off = drive(port(w), sizes, mid, max_new_tokens=new)
    for pipeline in (True, False):
        eng = port(w, mode, draft, pipeline=pipeline)
        got = drive(eng, sizes, mid, max_new_tokens=new)
        assert_same(got, want)
        assert_same(got, off)
        spec = eng.serving_stages()["speculation"]
        assert spec["spec_dispatches"] > 0 and spec["proposed"] > 0
        assert eng.audit_kv_sharing()["referenced"] == 0
    if draft == "self":
        assert spec["acceptance_rate"] >= 0.95, spec


def test_self_draft_kv_tracks_the_target(w):
    """Self-draft (the draft is the target): after every block, the
    draft's pools hold the target's K/V at every position the draft's
    coverage claims (one below each live slot's cursor; the next
    block's first draft step writes that row and the cursor's).  Those
    rows include the last proposal's of every tick that accepted all k,
    which the reference's draft never writes: it attends to a stale row
    there, and on this model its self-draft acceptance falls to 0.66
    (21 of 32, the JAX engine at
    ``test_greedy_equals_off_and_jax[self_draft]``'s traffic)."""
    eng = port(w, "draft", "self", pipeline=False)
    for p in prompts([5, 9, 30]):
        eng.put_request(p, max_new_tokens=40)
    checked = 0
    while eng.has_work():
        eng.step()
        for r in eng.slots:
            if r is None or eng._draft_len[r.slot] == 0:
                continue
            pos = np.arange(eng._draft_len[r.slot])
            rows = torch.from_numpy(eng.page_table[r.slot, pos // 16] * 16
                                    + pos % 16).long()
            for t, d in zip(eng.cache, eng._draft_cache):
                torch.testing.assert_close(
                    d.pages.flatten(0, 1)[rows], t.pages.flatten(0, 1)[rows],
                    atol=1e-5, rtol=1e-5)
            checked += 1
    assert checked >= 3
    # what stays unaccepted is the budget clamp of each sequence's last
    # tick
    assert eng.serving_stages()["speculation"]["acceptance_rate"] >= 0.9


EDGES = {
    # a tight pool: the k+1-wide write span forces stalls and evictions
    "eviction_backpressure": (dict(max_seqs=4, prefill_chunk=16,
                                   num_pages=9), [12, 20, 9, 16],
                              dict(max_new_tokens=40)),
    "k_beyond_budget": ({}, [5, 11, 3], dict(max_new_tokens=2)),
    "max_len_mid_chunk": (dict(max_seqs=2, max_seq_len=32), [20, 9],
                          dict(max_new_tokens=12)),
    "rollback_across_harvests": (dict(kv_reserve="worst_case",
                                      harvest_interval=4), [4, 6],
                                 dict(max_new_tokens=24)),
}


@pytest.mark.parametrize("name", list(EDGES))
def test_greedy_edge_cases(w, name):
    eng_kw, sizes, req = EDGES[name]
    off = drive(port(w, **eng_kw), sizes, **req)
    eng = port(w, "ngram", **eng_kw)
    got = drive(eng, sizes, **req)
    assert_same(got, off)
    st = eng.host_stats
    assert st.spec_dispatches > 0
    if name == "eviction_backpressure":
        assert eng.evictions > 0, "the pool is sized to force eviction"
    if name == "max_len_mid_chunk":
        assert any(v.size == 32 for v in got.values()), \
            "the traffic should reach the max_seq_len cap"
        want = drive(jax_eng(w, "ngram", **eng_kw), sizes, audit=False,
                     **req)
        assert_same(got, want)
    if name == "rollback_across_harvests":
        assert st.harvests < st.spec_dispatches, (
            f"harvests={st.harvests} should defer across "
            f"{st.spec_dispatches} speculative dispatches")


def test_greedy_early_eos(w):
    probe = drive(port(w), [5], max_new_tokens=2)
    eos = int(next(iter(probe.values()))[-2])
    kw = dict(max_new_tokens=30, eos_token_id=eos)
    off = drive(port(w), [5, 9], **kw)
    on = drive(port(w, "ngram"), [5, 9], **kw)
    assert_same(on, off)
    assert any(t[-1] == eos and t.size < 5 + 30 for t in on.values())


# -- sampled ------------------------------------------------------------------

@pytest.mark.parametrize("mode,draft,graph", [
    ("ngram", None, False), ("draft", "draft", False),
    ("ngram", None, True), ("draft", "draft", True)],
    ids=["ngram", "draft", "ngram_static", "draft_static"])
def test_sampled_pipeline_on_off_bit_identical(w, mode, draft, graph):
    cfg = {"enable_cuda_graph": True} if graph else None
    on = drive(port(w, mode, draft, pipeline=True, config=cfg), [4, 12, 3],
               **SAMPLED)
    off = drive(port(w, mode, draft, pipeline=False), [4, 12, 3],
                **SAMPLED)
    assert_same(on, off)


def test_mixed_greedy_and_sampled_slots(w):
    outs = {}
    for spec in ("ngram", "off"):
        eng = port(w, spec)
        ps = prompts([5, 8], seed=3)
        greedy = eng.put_request(ps[0], max_new_tokens=8)
        eng.put_request(ps[1], max_new_tokens=8, do_sample=True,
                        temperature=0.8)
        o = {}
        while eng.has_work():
            eng.step()
            o.update(eng.get_outputs())
        outs[spec] = o[greedy]
    np.testing.assert_array_equal(outs["ngram"], outs["off"])


# -- steady state and stats ---------------------------------------------------

def _decode_phase(w, spec):
    eng = port(w, spec, max_seqs=2, harvest_interval=4,
               kv_reserve="worst_case")
    for p in prompts([4, 6], seed=5):
        eng.put_request(p, max_new_tokens=24)
    eng.step()
    while eng.has_work() and any(s is not None and s.prefill_done <
                                 s.ctx_len for s in eng.slots):
        eng.step()
    eng.host_stats.reset()
    while eng.has_work():
        eng.step()
    return eng


def test_spec_decode_stays_pipelined(w):
    st = _decode_phase(w, "ngram").host_stats
    assert st.spec_dispatches >= 2
    # one carry upload set (11 arrays + hist) per pipeline entry
    assert st.meta_uploads <= 12 * max(st.harvests, 1)
    assert st.blocking_gets < st.dispatches
    assert st.harvests == st.blocking_gets


def test_spec_stats_reported(w):
    stages = _decode_phase(w, "ngram").serving_stages()
    spec = stages["speculation"]
    for key in ("spec_dispatches", "draft_ms", "verify_ms", "proposed",
                "accepted", "acceptance_rate", "mean_accepted_len",
                "tokens", "effective_tokens_per_dispatch"):
        assert key in spec, spec
    assert spec["proposed"] > 0 and stages["verify_ms"] > 0
    assert spec["tokens"] >= spec["spec_dispatches"]


# -- config and validation ----------------------------------------------------

def test_engine_consumes_config_subtree(w):
    eng = port(w, None, config={"v2": {"speculation": {
        "mode": "ngram", "k": 2, "ngram": 2}}})
    assert (eng.spec_mode, eng.spec_k, eng.spec_ngram) == ("ngram", 2, 2)
    eng2 = port(w, SpeculationConfig(mode="off"),
                config={"v2": {"speculation": {"mode": "ngram"}}})
    assert eng2.spec_mode == "off"


def test_draft_mode_requires_draft_model(w):
    with pytest.raises(ValueError, match="draft model"):
        port(w, "draft")


def test_draft_vocab_mismatch_refused(w):
    bad = _port_model(dict(DTINY, vocab_size=32))
    with pytest.raises(ValueError, match="vocab"):
        port(w, "draft", draft_model=bad)


def test_draft_pool_follows_target_format(w):
    eng = port(w, "draft", "draft", kv_cache_dtype="int8")
    assert eng.draft_kv_cache_dtype == "int8"
    assert all(p.quantized and p.pages.shape[2:] == (2, 8)
               for p in eng._draft_cache)
    over = port(w, "draft", "draft", kv_cache_dtype="int8",
                draft_kv_cache_dtype="none")
    assert not any(p.quantized for p in over._draft_cache)


# -- compositions -------------------------------------------------------------

@pytest.mark.parametrize("mode,draft", [("ngram", None),
                                        ("draft", "draft")])
def test_speculation_on_int8_pool(w, mode, draft):
    off = drive(port(w, kv_cache_dtype="int8"), [5, 11, 3],
                max_new_tokens=10)
    eng = port(w, mode, draft, kv_cache_dtype="int8")
    got = drive(eng, [5, 11, 3], max_new_tokens=10)
    assert eng.host_stats.spec_dispatches > 0
    assert_same(got, off)


@pytest.mark.parametrize("mode,draft", [("ngram", None),
                                        ("draft", "draft")])
def test_speculation_with_prefix_cache(w, mode, draft):
    """Shared prefix pages: the draft's rows in them are written by each
    sharer's catch-up; the tokens equal speculation and the cache off,
    and the refcount audit is clean after every step."""
    ps = shared_prompts(6, suffix=10)
    kw = dict(max_seqs=4, prefill_chunk=16)
    off = serve(port(w, **kw), ps, max_new_tokens=20)
    eng = port(w, mode, draft, prefix_cache=True, **kw)
    got = serve(eng, ps, max_new_tokens=20)
    assert eng.host_stats.spec_dispatches > 0
    assert eng.serving_stages()["prefix_cache"]["hit_requests"] > 0
    assert_same(got, off)
    eng.close()
    assert eng.allocator.audit(external={})["referenced"] == 0


@pytest.mark.parametrize("mode,draft", [("ngram", None),
                                        ("draft", "draft")])
def test_speculation_with_tiering(w, mode, draft):
    kw = dict(max_seqs=4, prefill_chunk=16, num_pages=9)
    ps = prompts([12, 20, 9, 16])
    off = serve(port(w, **kw), ps)
    eng = port(w, mode, draft, kv_tiering={"host_pages": 64}, **kw)
    got = serve(eng, ps)
    assert eng.spills > 0 and eng.restores > 0
    assert eng.host_stats.spec_dispatches > 0
    assert_same(got, off)
    assert eng.tiering.audit()["sessions"] == 0
    eng.close()


# -- the plain paged attention past the page table ----------------------------

@pytest.mark.parametrize("quant", [False, True], ids=["full", "int8"])
def test_plain_paged_attention_past_the_table(quant):
    """A verify tick near ``max_seq_len``: ``kv_lens`` exceeds ``pp *
    page``.  The rows past the table attend to nothing more; every row
    equals the same call over a table two columns wider whose extra
    columns are holes (positions are not shifted), and the full-width
    version equals JAX's plain version on that call."""
    r = np.random.default_rng(11)
    H, Hkv, D, page, pp = 4, 2, 64, 16, 3
    q_lens, kv_lens = [5, 5, 1], [pp * page + 3, 20, pp * page]
    S, P = 3, 1 + 3 * pp
    table = (1 + np.arange(S * pp, dtype=np.int32)).reshape(S, pp)
    wide = np.concatenate([table, np.full((S, 2), -1, np.int32)], axis=1)
    pool = r.standard_normal((P, page, 2 * Hkv, D)).astype(np.float32)
    q = torch.from_numpy(r.standard_normal(
        (sum(q_lens), H, D)).astype(np.float32))
    cu = torch.tensor(np.concatenate([[0], np.cumsum(q_lens)]),
                      dtype=torch.int32)
    lens = torch.tensor(kv_lens, dtype=torch.int32)
    ns = torch.tensor([S], dtype=torch.int32)
    sm = 1 / np.sqrt(D)
    if quant:
        pl = paged.PagedKVPool(P, page, Hkv, D, "int8", torch.float32, "cpu")
        rows = torch.from_numpy(pool).view(P * page, 2 * Hkv, D)
        pl.write(rows[:, 0::2], rows[:, 1::2], torch.arange(P * page))
        fn = lambda t: paged.ref_paged_attention_quant(
            q, pl.pages, pl.scales, lens, torch.from_numpy(t), cu, ns,
            sm_scale=sm)
    else:
        fn = lambda t: paged.ref_paged_attention(
            q, torch.from_numpy(pool), lens, torch.from_numpy(t), cu, ns,
            sm_scale=sm)
    got = fn(table)
    torch.testing.assert_close(got, fn(wide), atol=1e-6, rtol=0)
    assert torch.isfinite(got).all()
    if not quant:
        want = np.asarray(jpaged.ref_paged_attention(
            jnp.asarray(q.numpy()), jnp.asarray(pool), jnp.asarray(kv_lens,
                                                                   jnp.int32),
            jnp.asarray(table), jnp.asarray(cu.numpy()),
            jnp.asarray([S], jnp.int32), sm_scale=sm))
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
