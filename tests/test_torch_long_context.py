"""The port's long context (A9.5: ``inference/v2/long_context.py``, the
carry of the paged plain versions, ``staged_attend_stats``, the tier
store's ``peek``) against the JAX package's.

The model and engine are the JAX long-context tests' (``tinyllama`` cut to
2 layers, width 32, head dim 8, fp32; 16-row pages; sink 1, window 2,
group 2, so a resident window of 6 pages), one flax tree through the
weight bridge.  Engine runs are shared through module-scoped fixtures.

- Greedy, 200 + 48 tokens on an 8-page pool: the port's tokens equal the
  JAX long-context engine's and the port's fully resident engine's, and
  its page-in and park counters equal the JAX engine's; seeded sampling
  equals the port's fully resident run (the draws are position-keyed).
- The reference's cases: 4x over the pool; long-context and normal
  traffic together, pipeline on and off bit-identical and each stream
  equal to its own resident run; the two named rejections; small
  requests never take the path; int8 and fp8 pools equal their resident
  runs; a transient bitflip on page-in heals by re-read; pool, refcount
  and tier audits clean every step under prefix COW and spill pressure;
  a cancel drops the parked groups.
- ``ref_paged_attention(carry=)``, ``ref_paged_attention_quant(carry=)``
  and ``staged_attend_stats`` against the JAX functions on seeded inputs
  (fp32, atol 1e-5: the same sums in another order), neutral and random
  carries (some rows neutral), with and without a sliding window,
  interior holes; the quantized carry also against JAX's Pallas kernel #8
  in interpret mode (atol 5e-6, the tolerance the JAX package's own
  test holds #8 to).
- ``peek`` against the JAX store's: the same bytes, from the host tier
  and from NVMe after a prefetch, and the entry survives every peek.
"""
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.inference.kv_tiering import TieredKVStore as JaxStore
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.ops import ragged_paged_attention_quant as jax_kernel8
from deepspeed_tpu_torch.inference import paged
from deepspeed_tpu_torch.inference.kv_tiering import TieredKVStore
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from deepspeed_tpu_torch.resilience import faults
import torch_cpu  # noqa: F401  (one torch thread a process)

TINY = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=512)
# sink 1 + window 2 + group 2 + 1 = 6 resident pages (96 tokens)
LC_TIER = {"host_pages": 256, "long_context": True,
           "sink_pages": 1, "window_pages": 2, "chunk_pages": 2}
ENGINE = dict(max_seqs=4, max_seq_len=512, prefill_chunk=16, page_size=16,
              decode_block_size=4, kv_reserve="on_demand")
SAMPLED = dict(do_sample=True, temperature=0.8, top_k=10)


@pytest.fixture(scope="module")
def w():
    cfg = jax_llama.get_config("tinyllama", **TINY, dtype=jnp.float32,
                               param_dtype=jnp.float32, scan_layers=False,
                               remat=False, use_flash_attention=False)
    params = jax_llama.LlamaForCausalLM(cfg).init(
        jax.random.PRNGKey(7), np.zeros((1, 8), np.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    return dict(cfg=cfg, params=params, state=flax_to_state_dict(params))


def port(w, tiering=None, num_pages=24, fmt="none", prefix=None,
         pipeline=False, **kw):
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(
            llama.LlamaConfig(**TINY, dtype=torch.float32))
    return RaggedInferenceEngineV2(
        model, params=w["state"], device="cpu", num_pages=num_pages,
        kv_cache_dtype=fmt, kv_tiering=tiering, prefix_cache=prefix,
        pipeline=pipeline, **{**ENGINE, **kw})


def jax_lc(w, num_pages=8, fmt="none"):
    return JaxEngine(jax_llama.LlamaForCausalLM(w["cfg"]),
                     params=w["params"], pipeline=False,
                     num_pages=num_pages, kv_cache_dtype=fmt,
                     kv_tiering=dict(LC_TIER), rng=jax.random.PRNGKey(11),
                     **ENGINE)


def prompt(size, seed=3):
    return np.random.default_rng(seed).integers(1, 64, size=(size,),
                                                dtype=np.int32)


def serve(eng, prompts, audit=True, **kw):
    """Submit, step until drained (auditing the pool, refcounts and tiers
    after every step of a port engine); returns {uid: tokens}."""
    kw.setdefault("max_new_tokens", 40)
    for p in prompts:
        eng.put_request(p, **kw)
    outs, steps = {}, 0
    while eng.has_work():
        eng.step()
        outs.update(eng.get_outputs())
        if audit:
            eng.audit_kv_sharing()
            if eng.tiering is not None:
                eng.tiering.audit()
        steps += 1
        assert steps < 8000, "engine made no progress"
    outs.update(eng.get_outputs())
    return outs


def assert_same(a, b):
    assert sorted(a) == sorted(b), (sorted(a), sorted(b))
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=f"uid {uid}")


COUNTERS = ("pageins", "pagein_pages", "spills", "pages_spilled")


@pytest.fixture(scope="module")
def greedy(w):
    """200 + 48 greedy: resident (24 pages), long context on 8 pages in
    the port and in the JAX package."""
    p = prompt(200)
    ref = serve(port(w, num_pages=24), [p], max_new_tokens=48)
    eng = port(w, tiering=dict(LC_TIER), num_pages=8)
    out = serve(eng, [p], max_new_tokens=48)
    st = eng.serving_stages()["kv_tiering"]
    eng.close()
    jeng = jax_lc(w)
    jout = serve(jeng, [p], audit=False, max_new_tokens=48)
    jst = jeng.serving_stages()["kv_tiering"]
    jeng.close()
    return dict(ref=ref, out=out, st=st, jout=jout, jst=jst,
                ticks=eng._lc.ticks, parks=eng._lc.parks)


def test_greedy_equals_jax_lc_and_resident(greedy):
    assert_same(greedy["out"], greedy["ref"])
    assert_same(greedy["out"], greedy["jout"])
    st, jst = greedy["st"], greedy["jst"]
    assert st["pageins"] > 0 and greedy["parks"] > 0
    assert {k: st[k] for k in COUNTERS} == {k: jst[k] for k in COUNTERS}
    # every page-in is verified; the tier copies stay parked until reaped
    assert st["pages_verified"] == st["pagein_pages"]
    assert st["restores"] == 0 and st["resident_spilled_sessions"] == 0


def test_seeded_sampling_equals_resident(w):
    p = prompt(200)
    ref = serve(port(w, num_pages=24), [p], **SAMPLED)
    out = serve(port(w, tiering=dict(LC_TIER), num_pages=8), [p], **SAMPLED)
    assert_same(out, ref)


def test_4x_over_pool_decodes_end_to_end(w):
    eng = port(w, tiering=dict(LC_TIER), num_pages=8)
    outs = serve(eng, [prompt(400)], max_new_tokens=56)
    (_, toks), = outs.items()
    assert toks.size == 456 >= 4 * (8 - 1) * 16
    st = eng.serving_stages()["kv_tiering"]
    assert st["pageins"] > 0 and st["pagein_pages"] > 0
    assert st["pagein_wait_s"] >= st["pagein_verify_s"] > 0
    assert eng._lc.parks >= 10
    eng.close()
    ref = serve(port(w, num_pages=40), [prompt(400)], max_new_tokens=56)
    np.testing.assert_array_equal(toks, ref[0])


@pytest.mark.parametrize("pipeline", [False, True])
def test_mixed_lc_and_normal_traffic(w, pipeline):
    """A long-context sequence decodes beside normal requests; every
    stream equals its own resident run, pipeline on and off."""
    long_p, shorts = prompt(200), [prompt(12, 5), prompt(20, 6)]
    ref = list(serve(port(w, num_pages=40), [long_p]).values())
    ref += list(serve(port(w, num_pages=40), shorts,
                      max_new_tokens=16).values())
    eng = port(w, tiering=dict(LC_TIER), num_pages=12, pipeline=pipeline)
    for p in shorts:
        eng.put_request(p, max_new_tokens=16)
    eng.put_request(long_p, max_new_tokens=40)
    assert eng.waiting[-1].lc and not eng.waiting[0].lc
    outs = serve(eng, [])
    by_len = {v.size: v for v in ref}
    assert len(outs) == 3
    for v in outs.values():
        np.testing.assert_array_equal(v, by_len[v.size])
    assert eng._lc.ticks > 0
    eng.close()


def test_rejection_names_resident_window(w):
    """The resident window (6 pages) must fit the pool: 5 usable pages
    reject, 6 accept."""
    small = port(w, tiering=dict(LC_TIER), num_pages=6)
    with pytest.raises(ValueError, match="partial-residency window"):
        small.put_request(prompt(100), max_new_tokens=60)
    small.close()
    fits = port(w, tiering=dict(LC_TIER), num_pages=7)
    assert fits.put_request(prompt(100), max_new_tokens=60) >= 0
    fits.close()


def test_rejection_names_combined_tiers(w):
    eng = port(w, tiering=dict(LC_TIER, host_pages=4), num_pages=8)
    # cap = 7 usable + 4 host = 11 pages = 176 tokens
    with pytest.raises(ValueError, match="combined tiers"):
        eng.put_request(prompt(120), max_new_tokens=60)
    assert eng.put_request(prompt(120), max_new_tokens=56) >= 0
    eng.close()


def test_small_requests_unaffected(w):
    eng = port(w, tiering=dict(LC_TIER), num_pages=8)
    uid = eng.put_request(prompt(20), max_new_tokens=16)
    assert not eng.waiting[-1].lc
    outs = serve(eng, [])
    assert outs[uid].size == 36 and eng._lc.ticks == 0
    eng.close()


def test_refusals(w):
    with pytest.raises(NotImplementedError, match="quantize_weights"):
        port(w, tiering=dict(LC_TIER), quantize_weights="int8")


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quantized_pool_parity(w, fmt):
    """Parked quantized pages (payload and scale rows) survive the park
    and page-in cycle: the output equals the resident quantized run, and
    the JAX long-context engine's for int8."""
    p = prompt(200)
    ref = serve(port(w, num_pages=24, fmt=fmt), [p])
    eng = port(w, tiering=dict(LC_TIER), num_pages=8, fmt=fmt)
    out = serve(eng, [p])
    assert eng.serving_stages()["kv_tiering"]["pageins"] > 0
    eng.close()
    assert_same(out, ref)
    if fmt == "int8":
        jeng = jax_lc(w, fmt=fmt)
        assert_same(out, serve(jeng, [p], audit=False))
        jeng.close()


def test_transient_bitflip_on_pagein_heals(w, greedy):
    """A flipped bit in a parked group's working copy fails its digest at
    page-in and heals by re-read from the tier copy; the output stays
    exact."""
    with faults.FaultInjector(seed=5) as inj:
        inj.bitflip("kv.read_page", bits=1, count=1)
        eng = port(w, tiering=dict(LC_TIER), num_pages=8)
        out = serve(eng, [prompt(200)], max_new_tokens=48)
    st = eng.serving_stages()["kv_tiering"]
    assert st["rereads"] >= 1 and st["reread_recovered"] >= 1
    assert st["quarantined"] == 0
    assert_same(out, greedy["ref"])
    eng.close()


def test_conservation_under_prefix_cow_and_spill_pressure(w):
    """Long context, shared-prefix traffic (one full match: a COW) and
    whole-session spill pressure at once: the audits hold every step, and
    the drained engine leaves no live reference or parked payload."""
    r = np.random.default_rng(9)
    sys_p = r.integers(1, 64, size=(32,), dtype=np.int32)
    shared = [np.concatenate(
        [sys_p, r.integers(1, 64, size=(12,), dtype=np.int32)])
        for _ in range(4)]
    shared[3] = shared[0].copy()
    eng = port(w, tiering=dict(LC_TIER), num_pages=14, prefix=True)
    eng.put_request(prompt(200), max_new_tokens=40)
    outs = serve(eng, shared, max_new_tokens=16)
    assert len(outs) == 5 and eng._lc.ticks > 0
    fin = eng.audit_kv_sharing()
    assert fin["referenced"] == eng._pfx.stats()["resident_entries"]
    assert eng.tiering.audit()["sessions"] == 0
    eng.close()
    assert eng.allocator.audit(external={})["referenced"] == 0


def test_cancel_drops_parked_groups(w):
    eng = port(w, tiering=dict(LC_TIER), num_pages=8)
    uid = eng.put_request(prompt(200), max_new_tokens=40)
    while eng.tiering.audit()["sessions"] < 2:
        eng.step()
    assert eng.cancel(uid) == "lc"
    assert eng.tiering.audit()["sessions"] == 0
    assert eng.audit_kv_sharing()["referenced"] == 0
    eng.close()


# -- the plain carry functions against the JAX package's ------------------


def _case(seed, q_lens, kv_lens, H, Hkv, D, page, holes=(), fmt=None):
    """numpy q, a shuffled pool (and scales), metadata; ``holes`` lists
    (sequence, column) entries set to -1."""
    r = np.random.default_rng(seed)
    S = len(q_lens)
    cols = [-(-kv // page) for kv in kv_lens]
    P = 1 + sum(cols) + 2
    ids = list(r.permutation(np.arange(1, P)))
    table = np.full((S, max(cols) + 1), -1, np.int32)
    for j, c in enumerate(cols):
        table[j, :c] = ids[:c]
        ids = ids[c:]
    for j, c in holes:
        table[j, c] = -1
    shape = (P, page, 2 * Hkv, D)
    scales = None
    if fmt == "int8":
        pool = r.integers(-127, 128, size=shape).astype(np.int8)
    elif fmt == "fp8":
        pool = np.clip(r.standard_normal(shape) * 100, -448, 448).astype(
            jnp.float8_e4m3fn)
    else:
        pool = r.standard_normal(shape).astype(np.float32)
    if fmt is not None:
        scales = (r.random(shape[:3]) * 0.02 + 0.001).astype(np.float32)
    q = r.standard_normal((sum(q_lens), H, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    meta = (np.asarray(kv_lens, np.int32), table, cu,
            np.asarray([S], np.int32))
    return q, pool, scales, meta


def _torch(x):
    if x.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(x))


def _carry(kind, T, H, D, seed):
    """The neutral carry, or random stats with every third row neutral."""
    m, l, acc = (np.asarray(x) for x in paged.neutral_carry(T, H, D))
    if kind == "random":
        r = np.random.default_rng(seed)
        live = (np.arange(T) % 3 != 2)[:, None]
        m = np.where(live, r.standard_normal((T, H)), m).astype(np.float32)
        l = np.where(live, r.random((T, H)) + 0.5, 0).astype(np.float32)
        acc = np.where(live[..., None], r.standard_normal((T, H, D)),
                       0).astype(np.float32)
    return m, l, acc


# name: (q_lens, kv_lens, H, Hkv, D, page, holes, window)
CARRY_CASES = {
    "decode_prefill_holes": ([1, 7, 1], [40, 30, 64], 4, 2, 64, 8,
                             ((0, 1), (0, 2), (2, 3)), None),
    "window": ([1, 12], [60, 50], 8, 2, 64, 8, ((1, 2),), 20),
    "no_resident_key": ([1, 1], [40, 9], 4, 2, 64, 8,
                        ((0, 0), (0, 1), (0, 2), (0, 3), (0, 4)), 3),
}


@pytest.mark.parametrize("kind", ["neutral", "random"])
@pytest.mark.parametrize("name", sorted(CARRY_CASES))
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_plain_carry_against_jax(name, kind, fmt):
    q_lens, kv_lens, H, Hkv, D, page, holes, window = CARRY_CASES[name]
    q, pool, scales, meta = _case(sorted(CARRY_CASES).index(name), q_lens,
                                  kv_lens, H, Hkv, D, page, holes, fmt)
    carry = _carry(kind, q.shape[0], H, D, 4)
    sm = 1 / np.sqrt(D)
    if fmt is None:
        want = jpaged.ref_paged_attention(
            jnp.asarray(q), jnp.asarray(pool), *map(jnp.asarray, meta),
            sm_scale=sm, sliding_window=window,
            carry=tuple(map(jnp.asarray, carry)))
        got = paged.ref_paged_attention(
            _torch(q), _torch(pool), *map(_torch, meta), sm_scale=sm,
            sliding_window=window, carry=tuple(map(_torch, carry)))
    else:
        want = jpaged.ref_paged_attention_quant(
            jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales),
            *map(jnp.asarray, meta), sm_scale=sm, sliding_window=window,
            carry=tuple(map(jnp.asarray, carry)))
        got = paged.ref_paged_attention_quant(
            _torch(q), _torch(pool), _torch(scales), *map(_torch, meta),
            sm_scale=sm, sliding_window=window,
            carry=tuple(map(_torch, carry)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    if name == "no_resident_key" and kind == "random":
        # a row that sees no resident key returns the normalized carry
        m, l, acc = carry
        np.testing.assert_allclose(got.numpy()[0], acc[0] / l[0][:, None],
                                   rtol=1e-6)


@pytest.mark.parametrize("kind", ["neutral", "random"])
@pytest.mark.parametrize("fmt", ["int8", "fp8"])
def test_quant_carry_against_pallas_kernel8(fmt, kind):
    q, pool, scales, meta = _case(11, [1, 5, 1], [30, 21, 48], 4, 2, 128, 8,
                                  ((0, 1), (2, 2), (2, 3)), fmt)
    carry = _carry(kind, q.shape[0], 4, 128, 5)
    sm = 1 / np.sqrt(128)
    want = np.asarray(jax_kernel8(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales),
        *map(jnp.asarray, meta), sm_scale=sm,
        carry=tuple(map(jnp.asarray, carry)), interpret=True))
    got = paged.ref_paged_attention_quant(
        _torch(q), _torch(pool), _torch(scales), *map(_torch, meta),
        sm_scale=sm, carry=tuple(map(_torch, carry))).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


class _Stats(fnn.Module):
    """Runs the JAX package's ``_staged_attend_stats`` and keeps its sown
    stats."""
    window: object = None

    @fnn.compact
    def __call__(self, q, meta):
        return jpaged._staged_attend_stats(
            self, q, meta, types.SimpleNamespace(sliding_window=self.window))


@pytest.mark.parametrize("kind", ["none", "neutral", "random"])
@pytest.mark.parametrize("window", [None, 24])
@pytest.mark.parametrize("fmt", [None, "int8", "fp8"])
def test_staged_attend_stats_against_jax(fmt, window, kind):
    r = np.random.default_rng(21)
    T, H, Hkv, D, R = 5, 4, 2, 8, 32
    q = r.standard_normal((T, H, D)).astype(np.float32)
    if fmt == "int8":
        kv = r.integers(-127, 128, size=(R, 2 * Hkv, D)).astype(np.int8)
    elif fmt == "fp8":
        kv = np.clip(r.standard_normal((R, 2 * Hkv, D)) * 100, -448,
                     448).astype(jnp.float8_e4m3fn)
    else:
        kv = r.standard_normal((R, 2 * Hkv, D)).astype(np.float32)
    scales = (None if fmt is None else
              (r.random((R, 2 * Hkv)) * 0.02 + 0.001).astype(np.float32))
    kpos = np.arange(16, 16 + R, dtype=np.int32)
    qpos = np.asarray([40, 41, 42, 20, -1], np.int32)   # a pad row, and
    meta = {"staged_kv": jnp.asarray(kv),                # one before most
            "staged_kpos": jnp.asarray(kpos),
            "staged_qpos": jnp.asarray(qpos)}
    if scales is not None:
        meta["staged_scales"] = jnp.asarray(scales)
    carry = None if kind == "none" else _carry(kind, T, H, D, 6)
    if carry is not None:
        meta.update(carry_m=carry[0], carry_l=carry[1], carry_acc=carry[2])
    _, got_vars = _Stats(window).apply(
        {}, jnp.asarray(q.transpose(1, 0, 2)[None]), meta, mutable=["carry"])
    want = got_vars["carry"]["stats"][0]
    got = paged.staged_attend_stats(
        _torch(q), _torch(kv), torch.from_numpy(kpos).long(),
        torch.from_numpy(qpos).long(), sm_scale=1 / np.sqrt(D),
        staged_scales=None if scales is None else _torch(scales),
        sliding_window=window,
        carry=None if carry is None else tuple(map(_torch, carry)))
    for g, wv in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=1e-5,
                                   rtol=1e-6)


# -- peek against the JAX store's -------------------------------------------

PAGE_SHAPES = [(16, 4, 8), (16, 4)]          # a layer's pages + scales
PAGE_DTYPES = [np.int8, np.float32]


def _group(seed, n=2):
    r = np.random.default_rng(seed)
    return [r.integers(-127, 128, size=(n,) + PAGE_SHAPES[0]).astype(np.int8),
            r.random((n,) + PAGE_SHAPES[1]).astype(np.float32)]


def test_peek_against_jax_store(tmp_path):
    kw = dict(page_shapes=PAGE_SHAPES, page_dtypes=PAGE_DTYPES,
              pages_per_seq=4, host_pages=2, nvme_pages=8)
    st = TieredKVStore(nvme_dir=str(tmp_path / "port"), **kw)
    jst = JaxStore(nvme_dir=str(tmp_path / "jax"), **kw)
    groups = {f"mid-0-{g}": _group(g) for g in range(3)}
    for key, arrs in groups.items():
        st.spill(key, st.pack(arrs, 2), 2)      # the older ones demote
        jst.spill(key, arrs, 2)
    st._writes.drain()
    jst._writes.drain()
    assert st._entries["mid-0-0"].state == "nvme"
    assert st.prefetch(["mid-0-0"]) == jst.prefetch(["mid-0-0"]) == 1
    for _ in range(2):                          # the entries survive
        for key, arrs in groups.items():
            got = st.unpack(st.peek(key), 2)
            want = jst.peek(key)
            for a, b, c in zip(got, want, arrs):
                np.testing.assert_array_equal(a, b)
                np.testing.assert_array_equal(a, c)
            assert st.holds(key)
    names = ("pageins", "pagein_pages", "pagein_bytes",
             "pagein_prefetch_hits", "pagein_prefetch_misses")
    assert ({k: st.counters[k] for k in names} ==
            {k: jst.counters[k] for k in names})
    assert st.counters["pagein_prefetch_hits"] == 1
    assert st.counters["pages_verified"] == 12
    assert st.audit()["sessions"] == 3
    for key, arrs in groups.items():            # still restorable
        for a, b in zip(st.unpack(st.restore(key), 2), arrs):
            np.testing.assert_array_equal(a, b)
    st.close()
    jst.close()
