"""The port's ragged v2 engine against the JAX package's.

A tiny fp32 Llama (head dim 64, GQA 2:1, unrolled flax params passed
through the weight bridge) serves through both packages'
``RaggedInferenceEngineV2`` (both with ``pipeline=False``; the pipelined
path is ``test_torch_serving_pipeline.py``'s) on the same numpy prompts.  Greedy tokens must be equal, token for token, in every
scenario: a single request, a ragged batch, a prompt chunked across
``prefill_chunk``, more requests than slots, staggered admission, EOS
freeing a slot, decode blocks of 1 and 8 ticks, a tight on-demand pool
that evicts (with equal eviction counts), ``worst_case`` reserve, and
int8 and fp8 pools.  One JAX engine serves every scenario that shares its
settings (its state is clean between runs), which keeps this file light.

Also: the paged forward's logits against the JAX model's ``paged_decode``
apply on the same tick metadata (fp32, atol 1e-4); the allocator audit
after every run; ``cancel`` at each stage; every deferred feature raising
``NotImplementedError`` with its ROADMAP item; the CPU only on request;
and the batched sampler (the filter against JAX's at atol 1e-6, the
position-keyed draw's invariance to co-batching and to tick-vs-block
path, and its frequencies against softmax of the filtered logits).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.stats
import torch

from deepspeed_tpu.inference.sampling import \
    filter_logits_batched as jax_filter
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.telemetry import requests as jax_requests
from deepspeed_tpu_torch.inference import sampling
from deepspeed_tpu_torch.inference.paged import PagedKVPool, RaggedMeta
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from deepspeed_tpu_torch.telemetry import requests
import torch_cpu  # noqa: F401  (one torch thread a process)

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
BASE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, page_size=16,
            decode_block_size=8)
# engine settings -> scenarios served with them
SETTINGS = {
    "base": {},
    "block1": dict(decode_block_size=1),
    "tight": dict(num_pages=6),
    "worst_case": dict(kv_reserve="worst_case"),
    "int8": dict(kv_cache_dtype="int8"),
    "fp8": dict(kv_cache_dtype="fp8"),
}


def _prompts(sizes, seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, 256, size=(s,), dtype=np.int32) for s in sizes]


# scenario: (settings, prompts, max_new_tokens)
SCENARIOS = {
    "single": ("base", _prompts([5], 0), 6),
    "ragged_batch": ("base", _prompts([3, 9, 5, 12], 1), 5),
    "chunked_prompt": ("base", _prompts([40], 2), 4),
    "more_than_slots": ("base", _prompts([4, 6, 3, 7, 5, 8], 3), 4),
    "block1": ("block1", _prompts([5, 23, 9], 4), 10),
    "tight_pool_evicts": ("tight", _prompts([5, 9, 23, 40, 3, 17], 0), 12),
    "worst_case": ("worst_case", _prompts([5, 9, 23, 40, 3, 17], 0), 12),
    "int8_pool": ("int8", _prompts([5, 9, 23, 40, 3, 17], 0), 12),
    "fp8_pool": ("fp8", _prompts([5, 9, 23, 40, 3, 17], 0), 12),
}


def _jax_cfg(**kw):
    return jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32, remat=False,
                                 scan_layers=False,
                                 use_flash_attention=False, **kw)


def _staggered(engine):
    """p1 decodes a few steps alone, then p2 joins mid-flight."""
    p1, p2 = _prompts([6, 4], 5)
    engine.put_request(p1, max_new_tokens=8)
    for _ in range(4):
        engine.step()
    engine.put_request(p2, max_new_tokens=8)
    outs = {}
    while engine.has_work():
        engine.step()
        outs.update(engine.get_outputs())
    return [outs[u] for u in sorted(outs)]


def _eos_run(engine, eos):
    (prompt,) = _prompts([5], 6)
    engine.put_request(prompt, max_new_tokens=40, eos_token_id=eos)
    steps = 0
    while engine.has_work():
        engine.step()
        steps += 1
    ((_, toks),) = engine.get_outputs()
    return toks, steps


@pytest.fixture(scope="module")
def served():
    """Flax params, the bridged state_dict, and the JAX engine's outputs
    for every scenario (one JAX engine per settings group)."""
    params = jax_llama.LlamaForCausalLM(_jax_cfg()).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    want, evictions = {}, {}
    for name, kw in SETTINGS.items():
        eng = JaxEngine(jax_llama.LlamaForCausalLM(_jax_cfg()),
                        params=params, pipeline=False, **{**BASE, **kw})
        for scen, (group, prompts, new) in SCENARIOS.items():
            if group != name:
                continue
            before = eng.evictions
            outs = eng.generate_all(prompts, max_new_tokens=new)
            want[scen] = [outs[u] for u in sorted(outs)]
            evictions[scen] = eng.evictions - before
        if name == "base":
            want["staggered"] = _staggered(eng)
            (probe,) = eng.generate_all(_prompts([5], 6),
                                        max_new_tokens=3).values()
            eos = int(probe[-1])                 # its third greedy token
            want["eos"] = (_eos_run(eng, eos), eos)
    return dict(params=params, state=flax_to_state_dict(params), want=want,
                evictions=evictions)


def port_engine(state, device="cpu", **kw):
    kw.setdefault("pipeline", False)
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(
            llama.LlamaConfig(**TINY, dtype=torch.float32))
    return RaggedInferenceEngineV2(model, params=state, device=device,
                                   **{**BASE, **kw})


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_greedy_matches_jax_engine(served, scenario):
    group, prompts, new = SCENARIOS[scenario]
    eng = port_engine(served["state"], **SETTINGS[group])
    outs = eng.generate_all(prompts, max_new_tokens=new)
    got = [outs[u] for u in sorted(outs)]
    assert len(got) == len(prompts)
    for g, w in zip(got, served["want"][scenario]):
        np.testing.assert_array_equal(g, w)
    assert eng.evictions == served["evictions"][scenario]
    if scenario == "tight_pool_evicts":
        assert eng.evictions > 0
    audit = eng.audit_kv_sharing()
    assert audit["free"] == audit["total"] == eng.num_pages - 1
    st = eng.serving_stages()
    assert st["requests"]["completed"] == len(prompts)
    if group in ("int8", "fp8"):
        assert st["kv_quant"]["dequant_path"] == "torch-gather"
        assert st["kv_quant"]["scale_rows_written"] > 0


def test_staggered_admission_matches_jax_engine(served):
    got = _staggered(port_engine(served["state"]))
    for g, w in zip(got, served["want"]["staggered"]):
        np.testing.assert_array_equal(g, w)


def test_eos_frees_slot_like_jax_engine(served):
    (want_toks, want_steps), eos = served["want"]["eos"]
    eng = port_engine(served["state"])
    toks, steps = _eos_run(eng, eos)
    np.testing.assert_array_equal(toks, want_toks)
    assert toks[-1] == eos and toks.size < 5 + 40
    assert steps == want_steps
    eng.audit_kv_sharing()


@pytest.mark.parametrize("fmt", ["none", "int8"])
def test_paged_forward_logits_match_jax(served, fmt):
    """Two ticks through the paged forward of both models: a prefill
    chunk, then a tick mixing a decode token of sequence 0 with a chunk
    of sequence 1 that attends across its first page."""
    P, page = 8, 16
    jcfg = _jax_cfg(paged_decode=True, decode=True, kv_num_pages=P,
                    kv_page_size=page, kv_cache_dtype=fmt,
                    max_cache_len=64)
    jmodel = jax_llama.LlamaForCausalLM(jcfg)
    ticks = [  # token ids, positions, kv_lens, table, cu, num_seqs, dest
        (np.arange(1, 21), np.r_[np.arange(12), np.arange(8)],
         [12, 8], [[3, 5], [2, -1]], [0, 12, 20, 20], [2],
         np.r_[48 + np.arange(12), 32 + np.arange(8)]),
        (np.arange(30, 40), np.r_[12, 8 + np.arange(9)],
         [13, 17], [[3, 5], [2, 6]], [0, 1, 10, 10], [2],
         np.r_[60, 40 + np.arange(8), 96]),
    ]
    pools = [PagedKVPool(P, page, 2, 64, fmt, torch.float32,
                         torch.device("cpu")) for _ in range(2)]
    model = port_engine(served["state"]).module
    cache = None
    for ids, pos, kvl, table, cu, ns, dest in ticks:
        table = np.asarray(table, np.int32)
        table = np.pad(table, ((0, 1), (0, 0)), constant_values=-1)
        meta = dict(kv_lens=np.asarray(kvl + [0], np.int32),
                    page_indices=table, cu_q_lens=np.asarray(cu, np.int32),
                    num_seqs=np.asarray(ns, np.int32),
                    new_kv_dest=np.asarray(dest, np.int32))
        jmeta = {k: jnp.asarray(v) for k, v in meta.items()}
        variables = {"params": served["params"]["params"]}
        if cache is None:
            cache = jmodel.init(jax.random.PRNGKey(0), ids[None],
                                positions=pos[None],
                                ragged_meta=jmeta)["cache"]
            cache = jax.tree_util.tree_map(jnp.zeros_like, cache)
        want, mut = jmodel.apply({**variables, "cache": cache}, ids[None],
                                 positions=pos[None], ragged_meta=jmeta,
                                 mutable=["cache"])
        cache = mut["cache"]
        tmeta = RaggedMeta(*(torch.from_numpy(meta[k]) for k in (
            "kv_lens", "page_indices", "cu_q_lens", "num_seqs")),
            new_kv_dest=torch.from_numpy(meta["new_kv_dest"]).long())
        with torch.no_grad():
            got = model(torch.from_numpy(ids[None]),
                        positions=torch.from_numpy(pos[None]),
                        kv_cache=pools, ragged_meta=tmeta)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=0)


def test_cancel_at_each_stage_frees_pages(served):
    eng = port_engine(served["state"], max_seqs=2)
    long, short, queued = _prompts([40, 6, 5], 7)
    u_long = eng.put_request(long, max_new_tokens=4)
    u_short = eng.put_request(short, max_new_tokens=30)
    u_queued = eng.put_request(queued, max_new_tokens=4)
    eng.step()                       # both slots admitted; long mid-prefill
    assert eng.cancel(u_queued) == "queued"
    assert eng.cancel(u_long) == "prefill"
    eng.audit_kv_sharing()
    eng.step()
    assert eng.cancel(u_short) == "decode"
    assert eng.allocator.free_pages == eng.num_pages - 1
    u_done = eng.put_request(short, max_new_tokens=2)
    while eng.has_work():
        eng.step()
    assert eng.cancel(u_done) == "finished"
    assert eng.cancel(u_done) is None and eng.cancel(999) is None
    assert eng.get_outputs() == [] and eng.cancels == 4
    audit = eng.audit_kv_sharing()
    assert audit["free"] == audit["total"]
    assert eng.serving_stages()["requests"]["cancelled"] == 3


def test_stream_deltas_report_each_token_once(served):
    eng = port_engine(served["state"])
    uid = eng.put_request(_prompts([7], 8)[0], max_new_tokens=12)
    seen = []
    while eng.has_work():
        eng.step()
        for u, toks, total, done in eng.stream_deltas():
            assert u == uid
            seen.extend(toks)
            assert total == len(seen)
    ((_, out),) = eng.get_outputs()
    assert seen == out[7:].tolist()


# SLOs and tail sampling are ported (tests/test_torch_telemetry.py), and
# so is the control plane (tests/test_torch_control.py): the cases that
# asked for it now check that each route a request for it can take arms
# the controller (item None), with the config's settings; tensor
# parallelism (A7a) still raises.  The ids are kept
@pytest.mark.parametrize("kwargs,item", [
    pytest.param(dict(config={"v2": {"control": {"enabled": True}}}),
                 None, id="kwargs0-A10"),
    (dict(topology=object()), "A7a"),
    pytest.param(dict(control=True), None, id="kwargs2-A10"),
    pytest.param(dict(control={"interval": 4}), None, id="kwargs3-A10"),
    pytest.param(dict(config={"v2": {"control": {"enabled": True}}},
                      control=None, slo=["ttft_ms_p99 <= 150"],
                      trace_sample=4), None, id="kwargs4-A10"),
])
def test_deferred_features_raise(served, kwargs, item, monkeypatch):
    if item is not None:
        with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
            port_engine(served["state"], **kwargs)
        return
    monkeypatch.delenv("DSTPU_CONTROL", raising=False)
    eng = port_engine(served["state"], **kwargs)
    assert eng._controller is not None
    want = kwargs.get("control") or {}
    assert eng._control_cfg.interval == (
        want.get("interval", 8) if isinstance(want, dict) else 8)
    assert "control" in eng.serving_stages()
    monkeypatch.setenv("DSTPU_CONTROL", "0")       # the kill switch
    assert port_engine(served["state"], **kwargs)._controller is None


def test_config_defaults_and_unported_methods(served):
    # pipeline=None takes the config's default, on, as in the reference
    eng = port_engine(served["state"], config={"v2": {"async_depth": 3}},
                      pipeline=None)
    assert eng.pipeline is True
    # the handoff methods are ported (tests/test_torch_disagg.py): on an
    # idle engine there is nothing to export and nothing to install
    assert eng.export_handoff() == []
    assert eng.import_handoff([]) == []
    assert not eng.has_work()


def test_pool_sized_by_bytes(served):
    eng = port_engine(served["state"], kv_pool_bytes=1 << 20)
    page_bytes = 2 * 16 * 2 * 2 * 64 * 4        # layers*page*2Hkv*D*fp32
    assert eng.num_pages == (1 << 20) // page_bytes
    assert eng.cache_bytes() == eng.num_pages * page_bytes
    q8 = port_engine(served["state"], kv_pool_bytes=1 << 20,
                     kv_cache_dtype="int8")
    assert q8.num_pages == (1 << 20) // (2 * 16 * 2 * 2 * (64 + 4))


def test_refuses_to_start_without_gpu(served, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port_engine(served["state"], device=None)


def test_rejects_unschedulable_requests(served):
    eng = port_engine(served["state"], max_seq_len=64)
    with pytest.raises(ValueError, match="max_seq_len"):
        eng.put_request(np.ones(40, np.int32), max_new_tokens=30)
    with pytest.raises(ValueError, match="page_size"):
        port_engine(served["state"], page_size=8)


# -- sampling ----------------------------------------------------------------

def test_batched_filter_matches_jax():
    logits = np.random.default_rng(2).standard_normal(
        (5, 256), dtype=np.float32) * 3
    temp = np.asarray([1.0, 0.7, 0.8, 1.3, 0.5], np.float32)
    top_k = np.asarray([10, 0, 50, 5, 256], np.int32)
    top_p = np.asarray([1.0, 0.8, 0.9, 0.5, 0.3], np.float32)
    want = np.asarray(jax_filter(jnp.asarray(logits), jnp.asarray(temp),
                                 jnp.asarray(top_k), jnp.asarray(top_p)))
    got = sampling.filter_logits_batched(
        torch.from_numpy(logits), torch.from_numpy(temp),
        torch.from_numpy(top_k), torch.from_numpy(top_p)).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               atol=1e-6, rtol=0)


def _draw(logits, uids, positions, do_sample=True, t=0.8, k=50, p=0.9):
    S = logits.shape[0]
    keys = sampling.position_keys(5, torch.as_tensor(uids),
                                  torch.as_tensor(positions))
    return sampling.sample_logits_batched(
        logits, keys, torch.full((S,), do_sample),
        torch.full((S,), t), torch.full((S,), k), torch.full((S,), p))


def test_position_keyed_draw_ignores_co_batching():
    logits = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (6, 300), dtype=np.float32))
    together = _draw(logits, [4, 9, 2, 7, 1, 3], [10, 11, 12, 13, 14, 15])
    alone = [int(_draw(logits[i:i + 1], [u], [p]))
             for i, (u, p) in enumerate(zip([4, 9, 2, 7, 1, 3],
                                            [10, 11, 12, 13, 14, 15]))]
    assert together.tolist() == alone
    # greedy rows stay argmax
    greedy = _draw(logits, [0] * 6, list(range(6)), do_sample=False)
    assert greedy.tolist() == logits.argmax(-1).tolist()


def test_sampled_tokens_same_on_tick_and_block_paths(served):
    """The decode block and the fused tick draw the same token for the
    same (uid, position), so a sampled run's output does not depend on
    which path produced each token, nor on its co-batched requests."""
    prompts = _prompts([5, 9, 14], 9)
    kw = dict(max_new_tokens=12, do_sample=True, temperature=0.9, top_k=40,
              top_p=0.95)
    runs = []
    for block in (1, 8):
        eng = port_engine(served["state"], decode_block_size=block, seed=11)
        outs = eng.generate_all(prompts, **kw)
        runs.append([outs[u] for u in sorted(outs)])
    for a, b in zip(*runs):
        np.testing.assert_array_equal(a, b)
    solo = port_engine(served["state"], seed=11).generate_all(
        prompts[:1], **kw)
    np.testing.assert_array_equal(solo[0], runs[0][0])
    other = port_engine(served["state"], seed=12).generate_all(
        prompts[:1], **kw)
    assert not np.array_equal(other[0], runs[0][0])


def test_draw_frequencies_match_filtered_softmax():
    """24k draws over a 12-token vocabulary (distinct positions, so
    independent keys): a chi-square test at p = 0.001 against softmax of
    the filtered logits, and the filtered-out tokens never drawn."""
    n, V = 24000, 12
    base = torch.linspace(-1.5, 1.5, V)
    logits = base.expand(n, V).contiguous()
    toks = _draw(logits, [3] * n, list(range(n)), t=0.9, k=10, p=0.95)
    filt = sampling.filter_logits_batched(
        base[None], torch.tensor([0.9]), torch.tensor([10]),
        torch.tensor([0.95]))[0]
    probs = torch.softmax(filt, -1).double().numpy()
    counts = np.bincount(toks.numpy(), minlength=V)
    kept = probs > 0
    assert counts[~kept].sum() == 0
    expected = probs[kept] * n
    chi2 = float(((counts[kept] - expected) ** 2 / expected).sum())
    assert chi2 < scipy.stats.chi2.ppf(0.999, kept.sum() - 1), chi2


# -- request latency -----------------------------------------------------------

@pytest.mark.parametrize("q", [50, 90, 99, 100])
def test_percentile_matches_jax(q):
    vals = list(np.random.default_rng(q).random(37) * 100)
    assert requests.percentile(vals, q) == jax_requests.percentile(vals, q)
    assert requests.percentile([], q) is None


def test_latency_tracker_matches_jax():
    """One scripted lifecycle on an injected clock through both trackers
    (the JAX one with no metrics registry) gives equal summaries."""
    def script(tracker, clock):
        for uid in range(6):
            clock[0] += 1.0
            tracker.on_submit(uid)
        for uid in range(6):
            clock[0] += 0.5
            tracker.on_admit(uid)
            tracker.on_prefill_done(uid, 10 + uid)
            for n in range(1, 2 + uid):
                clock[0] += 0.25 * (uid + 1)
                tracker.on_tokens(uid, n)
            if uid == 4:
                tracker.on_cancel(uid)
            else:
                tracker.on_finish(uid)
        return tracker.summary(), tracker.completed()

    c1, c2 = [0.0], [0.0]
    got = script(requests.RequestLatencyTracker(clock=lambda: c1[0]), c1)
    want = script(jax_requests.RequestLatencyTracker(
        clock=lambda: c2[0], registry=None), c2)
    assert got == want
    assert got[0]["completed"] == 5 and got[0]["cancelled"] == 1
