"""The port's serving host path: the pipelined v2 decode loop, its
decode-block carry, the static buffers CUDA graphs replay, and v1's
static-shape decode step.

Mirrors ``tests/unit/test_serving_pipeline.py`` on the tiny fp32 Llama of
``test_torch_ragged_engine.py`` (head dim 64, GQA 2:1, flax params through
the weight bridge).  Inside the port, ``pipeline=True`` and
``pipeline=False`` give bit-identical (uid, tokens) for greedy traffic
with mid-run admissions, seeded sampled traffic, eviction backpressure
and an EOS early finish; the pipelined tokens equal the JAX engine's
pipelined ones, greedy; a pipelined steady state makes no per-block
upload or blocking fetch; ``sync()`` folds deferred tokens; ``cancel``
mid-pipeline frees the pages.  Every decode block runs over the static
buffers the graphs replay on the card (loads, carry chaining, the
harvest ring); ``enable_cuda_graph`` on the CPU, the ``static`` cases,
changes nothing there and is held to the same tokens.  The
bounded window is held against the JAX class on one script, the decode
block's returned carry against the JAX block's on the same inputs
(exact), and v1's static-shape step against the JAX v1 engine's greedy
tokens.  The card's captures and replays are
``test_torch_gpu_graphs.py``'s.
"""
import gc
import weakref

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.utils import async_stage as jax_async
import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from deepspeed_tpu_torch.utils import async_stage
import torch_cpu  # noqa: F401  (one torch thread a process)

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
BASE = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, page_size=16,
            decode_block_size=8)
# the reference test's engine: 3 slots, 4-tick blocks, a harvest every 3
PIPE = dict(max_seqs=3, prefill_chunk=8, decode_block_size=4,
            harvest_interval=3)
GRAPH = {"enable_cuda_graph": True}


def _prompts(sizes, seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, 256, size=(s,), dtype=np.int32) for s in sizes]


def _jax_cfg(**kw):
    return jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32, remat=False,
                                 scan_layers=False,
                                 use_flash_attention=False, **kw)


@pytest.fixture(scope="module")
def weights():
    params = jax_llama.LlamaForCausalLM(_jax_cfg()).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(np.asarray, params)
    return dict(params=params, state=flax_to_state_dict(params))


def port_engine(state, pipeline, **kw):
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(
            llama.LlamaConfig(**TINY, dtype=torch.float32))
    return RaggedInferenceEngineV2(model, params=state, device="cpu",
                                   pipeline=pipeline, **{**BASE, **kw})


def serve(engine, prompts, mid=None, **req_kw):
    """Run to completion; ``mid`` maps a step index to prompts submitted
    then (the same order in every mode, so the same uids).  Returns
    {uid: tokens}."""
    for p in prompts:
        engine.put_request(p, **req_kw)
    mid = dict(mid or {})
    outs, step = {}, 0
    while engine.has_work() or mid:
        for p in mid.pop(step, []):
            engine.put_request(p, **req_kw)
        if engine.has_work():
            engine.step()
            outs.update(engine.get_outputs())
        step += 1
    outs.update(engine.get_outputs())
    audit = engine.audit_kv_sharing()
    assert audit["free"] == audit["total"] == engine.num_pages - 1
    return outs


def assert_same(a, b):
    assert sorted(a) == sorted(b)
    for uid in a:
        np.testing.assert_array_equal(a[uid], b[uid], err_msg=f"uid {uid}")


# -- pipeline on == pipeline off, inside the port ----------------------------

MIXED = dict(prompts=_prompts([5, 11, 3], 3),
             mid={4: _prompts([7], 9), 9: _prompts([13], 10)})
SAMPLED = dict(max_new_tokens=9, do_sample=True, temperature=0.8, top_k=8,
               top_p=0.9)


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "static"])
def test_greedy_with_midrun_admissions(weights, graph):
    cfg = GRAPH if graph else None
    on_eng = port_engine(weights["state"], True, config=cfg, **PIPE)
    on = serve(on_eng, **MIXED, max_new_tokens=10)
    off_eng = port_engine(weights["state"], False, **PIPE)
    off = serve(off_eng, **MIXED, max_new_tokens=10)
    assert len(on) == 5
    assert_same(on, off)
    # the pipelined run must defer: fewer blocking fetches
    assert on_eng.host_stats.blocking_gets < off_eng.host_stats.blocking_gets


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "static"])
def test_seeded_sampling_mixed(weights, graph):
    cfg = GRAPH if graph else None
    prompts, mid = _prompts([4, 12, 3], 3), {5: _prompts([6], 8)}
    on = serve(port_engine(weights["state"], True, config=cfg, seed=11,
                           **PIPE), prompts, mid, **SAMPLED)
    off = serve(port_engine(weights["state"], False, seed=11, **PIPE),
                prompts, mid, **SAMPLED)
    assert_same(on, off)


@pytest.mark.parametrize("sample", [False, True], ids=["greedy", "sampled"])
def test_eviction_backpressure(weights, sample):
    """A 6-page pool: growth stalls force eviction and requeue; the
    pipeline reconciles at exactly the same blocks."""
    kw = dict(max_new_tokens=12)
    if sample:
        kw.update(do_sample=True, temperature=0.9, top_k=12)
    prompts = _prompts([5, 9, 23, 40, 3, 17], 0)
    engines = [port_engine(weights["state"], p, num_pages=6,
                           decode_block_size=4) for p in (True, False)]
    on, off = [serve(e, prompts, **kw) for e in engines]
    assert engines[0].evictions == engines[1].evictions > 0
    assert_same(on, off)


def test_eos_early_finish(weights):
    """EOS-bearing sequences force a harvest every block (the device
    decides the finish); outputs still match."""
    prompts = _prompts([5, 9], 6)
    probe = port_engine(weights["state"], False).generate_all(
        prompts[:1], max_new_tokens=3)
    eos = int(next(iter(probe.values()))[-1])     # the probe's third token
    kw = dict(max_new_tokens=30, eos_token_id=eos)
    on = serve(port_engine(weights["state"], True, decode_block_size=4),
               prompts, **kw)
    off = serve(port_engine(weights["state"], False, decode_block_size=4),
                prompts, **kw)
    assert_same(on, off)
    assert any(t[-1] == eos and t.size < 5 + 30 for t in on.values())


# -- the port's pipelined tokens against the JAX engine's -------------------

@pytest.fixture(scope="module")
def jax_pipelined(weights):
    eng = JaxEngine(jax_llama.LlamaForCausalLM(_jax_cfg()),
                    params=weights["params"], pipeline=True,
                    **{**BASE, **PIPE})
    outs = eng.generate_all(_prompts([5, 11, 3, 7, 20], 4),
                            max_new_tokens=10)
    return [outs[u] for u in sorted(outs)]


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "static"])
def test_pipelined_greedy_matches_jax_pipelined(weights, jax_pipelined,
                                                graph):
    eng = port_engine(weights["state"], True,
                      config=GRAPH if graph else None, **PIPE)
    outs = eng.generate_all(_prompts([5, 11, 3, 7, 20], 4),
                            max_new_tokens=10)
    got = [outs[u] for u in sorted(outs)]
    assert len(got) == len(jax_pipelined) == 5
    for g, w in zip(got, jax_pipelined):
        np.testing.assert_array_equal(g, w)
    assert eng.host_stats.harvests < eng.host_stats.dispatches


# -- the steady state is sync-free --------------------------------------------

def _decode_phase(state, pipeline, graph):
    eng = port_engine(state, pipeline, config=GRAPH if graph else None,
                      max_seqs=2, decode_block_size=4, harvest_interval=4,
                      kv_reserve="worst_case")
    for p in _prompts([4, 6], 5):
        eng.put_request(p, max_new_tokens=24)
    # through the prefill; the stats then cover ONLY the decode loop
    eng.step()
    while any(s is not None and s.prefill_done < s.ctx_len
              for s in eng.slots):
        eng.step()
    eng.host_stats.reset()
    while eng.has_work():
        eng.step()
    return eng.host_stats


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "static"])
def test_pipelined_decode_has_no_per_block_sync(weights, graph):
    st = _decode_phase(weights["state"], True, graph)
    # 23 tokens left a sequence after the prefill: 6 blocks of 4
    assert st.dispatches >= 5
    # 11 arrays once at the pipeline's entry; worst_case never grows
    assert st.meta_uploads <= 11, st.meta_uploads
    # one harvest at harvest_interval, one at the projected finish
    assert st.blocking_gets <= 3, st.blocking_gets
    assert st.blocking_gets < st.dispatches
    assert st.harvests == st.blocking_gets


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "static"])
def test_unpipelined_decode_syncs_per_block(weights, graph):
    st = _decode_phase(weights["state"], False, graph)
    assert st.blocking_gets == st.dispatches
    assert st.meta_uploads == 11 * st.dispatches


def test_sync_flushes_deferred_tokens(weights):
    eng = port_engine(weights["state"], True, max_seqs=2,
                      decode_block_size=4, harvest_interval=8,
                      kv_reserve="worst_case")
    eng.put_request(_prompts([4], 6)[0], max_new_tokens=20)
    eng.step()
    while any(s is not None and s.prefill_done < s.ctx_len
              for s in eng.slots):
        eng.step()
    before = len(eng.slots[0].generated)
    assert eng.step() == 0                # one pipelined block, deferred
    assert len(eng.slots[0].generated) == before
    assert eng.sync() == 4
    assert len(eng.slots[0].generated) == before + 4
    assert eng.sync() == 0                # the carry is still live
    stages = eng.serving_stages()
    for key in ("plan_ms", "upload_ms", "dispatch_ms", "device_ms",
                "harvest_ms", "host_bound_fraction"):
        assert key in stages
    assert stages["pipeline_window"]["submitted"] == 1


def test_cancel_mid_pipeline_frees_pages(weights):
    eng = port_engine(weights["state"], True, decode_block_size=4,
                      harvest_interval=8)
    uids = [eng.put_request(p, max_new_tokens=40)
            for p in _prompts([6, 9, 4], 7)]
    while eng._dev is None:
        eng.step()
    eng.step()                            # a deferred block in flight
    assert eng.cancel(uids[1]) == "decode"
    assert eng._dev is None               # the carry was folded first
    eng.audit_kv_sharing()
    outs = {}
    while eng.has_work():
        eng.step()
        outs.update(eng.get_outputs())
    assert sorted(outs) == [uids[0], uids[2]]
    assert eng.allocator.free_pages == eng.num_pages - 1
    # the survivors' tokens are an uncancelled run's
    ref = port_engine(weights["state"], False, decode_block_size=4)
    want = ref.generate_all(_prompts([6, 9, 4], 7), max_new_tokens=40)
    np.testing.assert_array_equal(outs[uids[0]], want[0])
    np.testing.assert_array_equal(outs[uids[2]], want[2])


def test_a_dropped_engine_frees_without_a_gc_pass(weights):
    """Its graphs hold the engine weakly: dropping the last reference
    frees the KV pools at once, not at the next gc pass."""
    eng = port_engine(weights["state"], True, config=GRAPH)
    eng.generate_all(_prompts([6], 11), max_new_tokens=12)
    ref = weakref.ref(eng)
    gc.disable()
    try:
        del eng
        assert ref() is None
    finally:
        gc.enable()


def test_pipeline_knobs_come_from_the_config(weights):
    eng = port_engine(weights["state"], None, config={
        "v2": {"async_depth": 3, "harvest_interval": 5}})
    assert (eng.pipeline, eng.async_depth, eng.harvest_interval) == \
        (True, 3, 5)
    eng = port_engine(weights["state"], None, harvest_interval=2,
                      config={"v2": {"pipeline": False,
                                     "harvest_interval": 5}})
    assert (eng.pipeline, eng.async_depth, eng.harvest_interval) == \
        (False, 2, 2)
    assert port_engine(weights["state"], None).pipeline is True


# -- the bounded window against the JAX class ---------------------------------

def _window_script(module, depth):
    """One script of submits, a selective pop and a drain; returns what
    the waiter and ``on_done`` saw, in order, and the counters."""
    log, in_flight = [], []

    def waiter(op):
        log.append(("join", op))
        return op * 10

    stage = module.BoundedAsyncStage(waiter=waiter, depth=depth)
    for key in range(6):
        stage.submit(key, key, on_done=lambda r: log.append(("done", r)))
        in_flight.append(stage.in_flight)
    log.append(("pop", stage.pop(5)))
    stage.submit(7, 7, on_done=lambda r: log.append(("done", r)))
    log.append(("drain", stage.drain()))
    return log, in_flight, stage.timers.counters


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_bounded_window_matches_jax(depth):
    got = _window_script(async_stage, depth)
    assert got == _window_script(jax_async, depth)
    log, in_flight, counters = got
    assert max(in_flight) == depth
    # back-pressure joins the oldest first; pop(5) joins 5 alone; the
    # drain joins the rest in submission order
    joined = [op for kind, op in log if kind == "join"]
    drained = list(range(6 - depth, 5)) + [7]
    assert joined == list(range(6 - depth)) + [5] + drained
    # on_done sees each join's result, in join order, and its return
    # value is what pop and drain hand back
    assert [r for kind, r in log if kind == "done"] == \
        [10 * op for op in joined]
    assert log[-1] == ("drain", [None] * len(drained))
    assert counters == {"submitted": 7, "completed": 7}


def test_drain_reaps_every_op_before_raising():
    seen = []

    def waiter(op):
        seen.append(op)
        if op == 1:
            raise RuntimeError("op 1 failed")
        return op

    stage = async_stage.BoundedAsyncStage(waiter=waiter, depth=4)
    for key in range(3):
        stage.submit(key, key)
    with pytest.raises(RuntimeError, match="op 1"):
        stage.drain()
    assert seen == [0, 1, 2] and stage.in_flight == 0


# -- the decode block's carry against the JAX block ---------------------------

def test_decode_block_carry_matches_jax(weights):
    """One greedy block over the same inputs on fresh pools: a slot whose
    budget runs out mid-block, one that runs through, an inactive one, and
    one that reaches ``max_seq_len``.  The whole returned carry, the
    tokens and the produced mask are equal."""
    S, K, L = 4, 8, BASE["max_seq_len"]
    jeng = JaxEngine(jax_llama.LlamaForCausalLM(_jax_cfg()),
                     params=weights["params"], pipeline=False, **BASE)
    eng = port_engine(weights["state"], False)
    pp = eng.pages_per_seq
    table = (1 + np.arange(S * pp, dtype=np.int32)).reshape(S, pp)
    inputs = dict(
        last_tok=np.asarray([17, 99, 0, 203]),
        pos=np.asarray([5, 30, 0, L - 4]),
        active=np.asarray([True, True, False, True]),
        remaining=np.asarray([3, 40, 0, 50]),
        page_table=table,
        eos_ids=np.full(S, -1),
        do_sample=np.zeros(S, bool),
        temperature=np.ones(S, np.float32),
        top_k=np.zeros(S),
        top_p=np.ones(S, np.float32),
        seeds=np.arange(S))
    order = ("last_tok", "pos", "active", "remaining", "page_table",
             "eos_ids", "do_sample", "temperature", "top_k", "top_p",
             "seeds")
    jargs = [jnp.asarray(inputs[n].astype(np.int32)
                         if inputs[n].dtype.kind == "i" else inputs[n])
             for n in order]
    out = jeng._decode_block_fn(False)(jeng.params, jeng.cache, *jargs,
                                       jax.random.PRNGKey(0))
    want = [np.asarray(x) for x in out[1:]]
    targs = [torch.from_numpy(np.asarray(inputs[n], dtype={
        "page_table": np.int32, "active": bool, "do_sample": bool,
        "temperature": np.float32, "top_p": np.float32}.get(n, np.int64)))
        for n in order]
    got = [t.numpy() for t in eng._decode_block(False, *targs)]
    names = ("last_tok", "pos", "active", "remaining", "toks", "mask")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g, w.astype(g.dtype), err_msg=name)
    assert got[5].shape == (K, S)
    assert not got[2][0] and got[2][1] and not got[2][3]


# -- v1's static-shape decode step ---------------------------------------------

V1_TINY = dict(TINY, max_position_embeddings=64)
V1_CONFIG = {"dtype": "float32", "max_out_tokens": 32}


@pytest.fixture(scope="module")
def v1_served():
    jcfg = jax_llama.LlamaConfig(**V1_TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32, remat=False)
    jmodel = jax_llama.LlamaForCausalLM(jcfg)
    prompts = np.random.default_rng(4).integers(0, 256, size=(3, 9),
                                                dtype=np.int32)
    params = jmodel.init(jax.random.PRNGKey(5), jnp.asarray(prompts))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    eng = deepspeed_tpu.init_inference(jmodel, config=dict(V1_CONFIG),
                                       params=params)
    greedy = np.asarray(eng.generate(prompts, max_new_tokens=12))
    eos = int(greedy[1, 9 + 3])
    padded = np.asarray(eng.generate(prompts, max_new_tokens=12,
                                     eos_token_id=eos))
    return dict(state=flax_to_state_dict(params), prompts=prompts,
                greedy=greedy, eos=eos, padded=padded)


@pytest.mark.parametrize("graph", [False, True], ids=["eager", "static"])
def test_v1_static_step_matches_jax_greedy(v1_served, graph):
    """The static-shape step (K/V at a device-side position, attention
    over the whole cache) gives the JAX v1 engine's greedy tokens, and
    its EOS padding; on the CPU ``enable_cuda_graph`` runs it eagerly."""
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(llama.LlamaConfig(**V1_TINY))
    eng = deepspeed_tpu_torch.init_inference(
        model, config={**V1_CONFIG, "enable_cuda_graph": graph},
        params=v1_served["state"], device="cpu")
    out = eng.generate(v1_served["prompts"], max_new_tokens=12)
    np.testing.assert_array_equal(out.numpy(), v1_served["greedy"])
    out = eng.generate(v1_served["prompts"], max_new_tokens=12,
                       eos_token_id=v1_served["eos"])
    np.testing.assert_array_equal(out.numpy(), v1_served["padded"])
    st = eng.serving_stages()
    assert ("graph_replays" in st) == graph
    if graph:
        assert st["graph_captures"] == st["graph_replays"] == 0
