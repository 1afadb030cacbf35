"""CUDA-graph decode on the card: the v2 decode blocks and v1's decode step
replayed from graphs give the eager engines' tokens.

Every test here is marked ``gpu`` and skips without a CUDA GPU: a CUDA
graph has no CPU mode.  The file imports only torch, numpy and the port,
so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_graphs.py

A tiny bf16 Llama (head dim 64, GQA 2:1) with random seeded weights.
v2: greedy and sampled traffic with mid-run admissions, through graphs
with the pipeline on and off, give the eager unpipelined engine's tokens
exactly (the same kernels at the same shapes); the paged kernel's Python
counter ticks at warm-ups and captures only, so it equals the layers x
(eager ticks + 2 K x captures).  Capturing both graphs mid-run leaves
every live page byte-identical (warm-up and capture write the trash page
only).  With KV tiering over a tight pool, sequences spilled and restored
between replayed blocks read back their spilled page bytes (the restore
writes the pool the graphs replay over in place), and the tokens equal
the same traffic's eager unpipelined run's.  v1: the captured step gives
the eager step's tokens, greedy, with
EOS (held in a buffer: no new capture) and at a second prompt length
(one decode state kept), and sampled (where torch can register a
generator with a graph; elsewhere a sampled graph raises).
Speculation (n-gram and a draft model of head dim 64, k 3): greedy and
sampled traffic through the captured speculative blocks, pipeline on
and off, gives the eager unpipelined engine's tokens, with the paged
kernel's Python count equal to what the ticks, captures and draft
catch-ups launch; capturing both speculative graphs mid-run leaves
every live page of the target's and the draft's pools byte-identical.
Long context (KV tiering with ``long_context``): a request 4x over a
tight pool beside a normal one that outlives it, graphs and the pipeline
on, gives the eager unpipelined engine's tokens; no decode block starts
while the long-context request is live, and replayed blocks resume
after it finishes.  Quantized weights: a w8a8 block (the W8A8 GEMM once
a Linear) and an fp6 block (K2 a weight) replayed from graphs give the
eager unpipelined engine's tokens.  Sparse MoE: a tiny bf16 Qwen2-MoE
(routed experts and the shared expert, head dim 64) through captured and
replayed blocks, pipeline on and off, gives the eager unpipelined
engine's tokens bit for bit, with the paged kernel once a layer a tick;
and with int8 and fp6 expert banks (each expanded whole a tick) the same.
The control plane's offline knob: ``decode_block_size`` set after a
capture drops the graphs, captures again and serves the eager tokens at
the new block length.
"""
import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama, qwen2_moe
from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa
from deepspeed_tpu_torch.resilience import sdc

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=512,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
V2 = dict(max_seqs=4, max_seq_len=256, prefill_chunk=32, page_size=16,
          decode_block_size=4, harvest_interval=3)


@pytest.fixture
def cuda():
    # decided inside the test run, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: CUDA graphs have no CPU mode")
    return torch.device("cuda")


def _model(cuda):
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(llama.LlamaConfig(**TINY))
    return model


def _v2(cuda, module=None, **kw):
    gen = torch.Generator(device=cuda).manual_seed(0)
    return RaggedInferenceEngineV2(
        module if module is not None else _model(cuda), generator=gen,
        device=cuda, **{**V2, **kw})


def _serve(engine, sampled):
    """Five requests, two admitted mid-run; with ``sampled`` every other
    one samples."""
    r = np.random.default_rng(1)
    prompts = [r.integers(0, 256, size=n) for n in (5, 40, 17, 9, 33)]
    kws = [dict(max_new_tokens=40 + 3 * i) for i in range(5)]
    if sampled:
        for kw in kws[::2]:
            kw.update(do_sample=True, temperature=0.8, top_k=20, top_p=0.9)
    for p, kw in zip(prompts[:3], kws):
        engine.put_request(p, **kw)
    outs, step = {}, 0
    while engine.has_work() or step < 6:
        if step == 5:                       # mid-run admissions
            for p, kw in zip(prompts[3:], kws[3:]):
                engine.put_request(p, **kw)
        if engine.has_work():
            engine.step()
            outs.update(engine.get_outputs())
        step += 1
    engine.audit_kv_sharing()
    assert engine.allocator.free_pages == engine.num_pages - 1
    return [outs[u] for u in sorted(outs)]


@pytest.mark.gpu
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_v2_graphs_give_the_eager_tokens(cuda, sampled):
    eager = _v2(cuda, pipeline=False)
    want = _serve(eager, sampled)
    L, K = TINY["num_hidden_layers"], V2["decode_block_size"]
    for pipeline in (False, True):
        eng = _v2(cuda, module=eager.module, pipeline=pipeline,
                  config={"enable_cuda_graph": True})
        before = rpa.ragged_paged_attention.launches
        got = _serve(eng, sampled)
        st = eng.serving_stages()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        # one graph per sampled flag a block ran with: in the sampled
        # traffic a sampling request outlives every greedy one admitted
        # with it, so every block has a sampled row and only the sampled
        # graph is captured
        assert st["graph_captures"] == 1
        assert st["graph_replays"] > 0
        ticks = eng.host_stats.ticks
        eager_ticks = ticks - K * st["graph_replays"]
        assert rpa.ragged_paged_attention.launches - before == L * (
            eager_ticks + 2 * K * st["graph_captures"])
        if pipeline:
            assert eng.host_stats.blocking_gets < eng.host_stats.dispatches


@pytest.mark.gpu
def test_block_size_change_captures_again(cuda):
    """``decode_block_size`` set through the knob registry after a capture
    (the offline path): the graphs are dropped, the next block captures
    again (``graph_captures`` + 1), runs the new length (each replay K'
    ticks, the harvest ring K' rows) and serves the eager tokens."""
    eager = _v2(cuda, pipeline=False)
    want = _serve(eager, False)
    eng = _v2(cuda, module=eager.module, pipeline=True,
              config={"enable_cuda_graph": True})
    for g, w in zip(_serve(eng, False), want):
        np.testing.assert_array_equal(g, w)
    st = eng.serving_stages()
    assert st["graph_captures"] == 1
    eng.knob_registry().set("engine.decode_block_size", 2,
                            allow_recompile=True)
    assert not eng._graphs.graphs and not eng._rings
    ticks, replays = eng.host_stats.ticks, st["graph_replays"]
    for g, w in zip(_serve(eng, False), want):
        np.testing.assert_array_equal(g, w)
    st = eng.serving_stages()
    assert st["graph_captures"] == 2
    assert {r[0].shape[1] for r in eng._rings.values()} == {2}
    assert eng._graphs.outputs[(False, False)][4].shape[0] == 2
    assert st["graph_replays"] > replays
    assert eng.host_stats.ticks > ticks


@pytest.mark.gpu
def test_moe_graphs_give_the_eager_tokens(cuda):
    """Routing (top-k, cumsum, stable argsort, row gathers) and the
    expert bmms inside the captured block: the eager engine's tokens."""
    cfg = qwen2_moe.get_config("tinyqwen2moe", vocab_size=256,
                               hidden_size=256, num_attention_heads=4,
                               num_key_value_heads=4,
                               max_position_embeddings=256)
    with torch.device("meta"):
        model = qwen2_moe.Qwen2MoeForCausalLM(cfg)
    eager = _v2(cuda, module=model, pipeline=False)
    want = _serve(eager, sampled=False)
    L, K = cfg.num_hidden_layers, V2["decode_block_size"]
    for pipeline in (False, True):
        eng = _v2(cuda, module=eager.module, pipeline=pipeline,
                  config={"enable_cuda_graph": True})
        before = rpa.ragged_paged_attention.launches
        got = _serve(eng, sampled=False)
        st = eng.serving_stages()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert st["graph_captures"] == 1 and st["graph_replays"] > 0
        eager_ticks = eng.host_stats.ticks - K * st["graph_replays"]
        assert rpa.ragged_paged_attention.launches - before == L * (
            eager_ticks + 2 * K * st["graph_captures"])


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp6"])
def test_quantized_moe_graphs_give_the_eager_tokens(cuda, fmt):
    """A tiny bf16 Qwen2-MoE with quantized expert banks (each expanded
    whole once a layer a tick, #7 or K2) through captured and replayed
    blocks, pipeline on, gives the eager unpipelined engine's tokens; the
    dequant's Python counter ticks at warm-ups and captures only."""
    from deepspeed_tpu_torch.inference import quantization as iq
    from deepspeed_tpu_torch.ops import quantization as qz

    cfg = qwen2_moe.get_config("tinyqwen2moe", vocab_size=256,
                               hidden_size=256, num_attention_heads=4,
                               num_key_value_heads=4,
                               max_position_embeddings=256)
    with torch.device("meta"):
        model = qwen2_moe.Qwen2MoeForCausalLM(cfg)
    eager = _v2(cuda, module=model, pipeline=False, quantize_weights=fmt)
    per = sum(isinstance(m, iq._Quantized) for m in eager.module.modules())
    assert sum(isinstance(m, iq.QuantizedBank)
               for m in eager.module.modules()) == 3 * cfg.num_hidden_layers
    want = _serve(eager, sampled=True)
    counter = qz.dequantize if fmt == "int8" else qz.dequantize_fp6
    K = V2["decode_block_size"]
    graphed = _v2(cuda, module=eager.module, pipeline=True,
                  config={"enable_cuda_graph": True})
    before = counter.launches
    got = _serve(graphed, sampled=True)
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(a, b)
    st = graphed.serving_stages()
    assert st["graph_captures"] >= 1 and st["graph_replays"] >= 1
    eager_ticks = graphed.host_stats.ticks - K * st["graph_replays"]
    assert counter.launches - before == per * (
        eager_ticks + 2 * K * st["graph_captures"])


@pytest.mark.gpu
def test_capture_leaves_live_pages_untouched(cuda):
    eng = _v2(cuda, config={"enable_cuda_graph": True}, pipeline=False)
    r = np.random.default_rng(2)
    for n in (30, 21, 7):
        eng.put_request(r.integers(0, 256, size=n), max_new_tokens=20)
    while any(s is None or s.prefill_done < s.ctx_len
              for s in eng.slots[:3]):
        eng.step()
    assert eng.host_stats.graph_captures == 0
    torch.cuda.synchronize()
    before = [p.pages[1:].clone() for p in eng.cache]
    eng._graphs.ensure(False)
    eng._graphs.ensure(True)
    torch.cuda.synchronize()
    assert eng.host_stats.graph_captures == 2
    for b, p in zip(before, eng.cache):
        assert torch.equal(b.view(torch.uint8),
                           p.pages[1:].view(torch.uint8))
    while eng.has_work():
        eng.step()
    eng.audit_kv_sharing()


def _watch_restores(eng):
    """Wrap ``eng._restore``: every restored page's bytes, read back from
    the pool, equal its spill-time digest.  Returns the list of the
    engine's replay counts at each checked restore."""
    seen = []
    restore = eng._restore

    def checked(req):
        n, jn = req.spilled["n_pages"], len(req.spilled["shared_pages"])
        want = eng.tiering.spill_digests(req.uid) if n else None
        restore(req)
        if want is None or req.slot < 0:
            return
        pages = [int(p) for p in eng.page_table[req.slot, jn:jn + n]]
        got = eng._gather_pages(pages).reshape(n, -1)
        assert [sdc.digest(b) for b in got] == want
        seen.append(eng.host_stats.graph_replays)

    eng._restore = checked
    return seen


@pytest.mark.gpu
@pytest.mark.parametrize("pipeline", [False, True], ids=["unpiped", "piped"])
def test_v2_spill_restore_between_replayed_blocks(cuda, pipeline):
    tight = dict(num_pages=14, kv_tiering={"host_pages": 64})
    eager = _v2(cuda, pipeline=False, **tight)
    want = _serve(eager, False)
    assert eager.spills > 0 and eager.evictions == 0
    eng = _v2(cuda, module=eager.module, pipeline=pipeline,
              config={"enable_cuda_graph": True}, **tight)
    restores = _watch_restores(eng)
    got = _serve(eng, False)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    replays = eng.host_stats.graph_replays
    assert any(0 < r < replays for r in restores), (
        "no restore landed between two replayed blocks")
    st = eng.serving_stages()["kv_tiering"]
    assert st["pages_verified"] == st["pages_restored"] > 0
    assert (eng.spills, eng.restores) == (eager.spills, eager.restores)
    eng.close()
    eager.close()


def _v1(cuda, module, graph):
    return deepspeed_tpu_torch.init_inference(
        module, config={"dtype": "bfloat16", "max_out_tokens": 128,
                        "enable_cuda_graph": graph}, device=cuda)


@pytest.mark.gpu
def test_v1_graph_step_gives_the_eager_tokens(cuda):
    gen = torch.Generator(device=cuda).manual_seed(0)
    eager = deepspeed_tpu_torch.init_inference(
        _model(cuda), config={"dtype": "bfloat16", "max_out_tokens": 128},
        generator=gen, device=cuda)
    graphed = _v1(cuda, eager.module, True)
    prompts = torch.from_numpy(
        np.random.default_rng(3).integers(0, 256, size=(3, 20)))
    want = eager.generate(prompts, max_new_tokens=24)
    for _ in range(2):                      # capture, then reuse
        got = graphed.generate(prompts, max_new_tokens=24)
        assert torch.equal(got, want)
    st = graphed.serving_stages()
    assert st["graph_captures"] == 1 and st["graph_replays"] == 2 * 23
    eos = int(want[0, 20 + 2])
    assert torch.equal(
        graphed.generate(prompts, max_new_tokens=24, eos_token_id=eos),
        eager.generate(prompts, max_new_tokens=24, eos_token_id=eos))
    # the EOS id is a buffer of the captured step, not a key
    assert graphed.serving_stages()["graph_captures"] == 1
    # another prompt length: the one decode state is replaced
    assert torch.equal(graphed.generate(prompts[:, :12], max_new_tokens=24),
                       eager.generate(prompts[:, :12], max_new_tokens=24))
    assert graphed.serving_stages()["graph_captures"] == 2
    assert graphed._graphed.key == (3, 12 + 24)
    kw = dict(max_new_tokens=24, do_sample=True, temperature=0.8, top_k=40,
              top_p=0.9)

    def sampled(engine):
        gen = torch.Generator(device=cuda).manual_seed(5)
        return engine.generate(prompts, generator=gen, **kw), gen

    if not hasattr(torch.cuda.CUDAGraph, "register_generator_state"):
        with pytest.raises(NotImplementedError, match="A8b"):
            sampled(graphed)
        return
    want, want_gen = sampled(eager)
    got, got_gen = sampled(graphed)
    assert torch.equal(got, want)
    # every replay advanced the caller's generator as an eager step does:
    # no replay drew a frozen sample
    assert torch.equal(got_gen.get_state(), want_gen.get_state())


# -- speculative blocks (v2 speculation) --------------------------------------

DRAFT = dict(TINY, hidden_size=128, intermediate_size=256,
             num_hidden_layers=1, num_attention_heads=2,
             num_key_value_heads=1)


def _spec(cuda, mode, module=None, draft=None, **kw):
    """A speculative engine; draft mode gets DRAFT's model (head dim 64),
    random seeded weights unless ``draft`` passes a built one."""
    if mode == "draft":
        if draft is None:
            with torch.device("meta"):
                draft = llama.LlamaForCausalLM(llama.LlamaConfig(**DRAFT))
        kw["draft_model"] = draft
    return _v2(cuda, module=module, speculation={"mode": mode, "k": 3},
               **kw)


def _spec_captures(eng):
    """Captured speculative graphs (the keys are (spec, sampled))."""
    return sum(spec for spec, _ in eng._graphs.graphs)


def _spec_launches(eng, L, Ld, k):
    """The paged kernel's Python count over ``eng``'s life: a fused or
    plain decode tick launches it L times, a speculative tick L + k x Ld
    (k draft steps), a draft catch-up chunk Ld; each counts at eager
    ticks and at a capture's warm-up and capture, never at a replay (a
    capturing engine replays every block it dispatches)."""
    st, g, K = eng.host_stats, eng._graphs, eng.decode_block_size
    spec_cap = _spec_captures(eng)
    spec_rep = st.spec_dispatches if g.capturing else 0
    spec_eager = K * (st.spec_dispatches - spec_rep)
    plain_eager = (st.ticks - K * st.spec_dispatches -
                   K * (st.graph_replays - spec_rep))
    return (L * (plain_eager + 2 * K * (len(g.graphs) - spec_cap)) +
            (L + k * Ld) * (spec_eager + 2 * K * spec_cap) +
            Ld * eng.draft_catchup_chunks)


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_spec_graphs_give_the_eager_tokens(cuda, mode, sampled):
    """A captured speculative block replays to the eager block's tokens,
    pipeline on and off; the paged kernel's count follows the ticks."""
    eager = _spec(cuda, mode, pipeline=False)
    want = _serve(eager, sampled)
    assert eager.host_stats.spec_dispatches > 0
    L = TINY["num_hidden_layers"]
    Ld = DRAFT["num_hidden_layers"] if mode == "draft" else 0
    for pipeline in (False, True):
        eng = _spec(cuda, mode, module=eager.module,
                    draft=eager._draft_module, pipeline=pipeline,
                    config={"enable_cuda_graph": True})
        before = rpa.ragged_paged_attention.launches
        got = _serve(eng, sampled)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert _spec_captures(eng) >= 1
        assert eng.host_stats.spec_dispatches > 0
        assert rpa.ragged_paged_attention.launches - before == \
            _spec_launches(eng, L, Ld, 3)
        if pipeline:
            assert eng.host_stats.blocking_gets < eng.host_stats.dispatches


@pytest.mark.gpu
@pytest.mark.parametrize("mode", ["ngram", "draft"])
def test_spec_capture_leaves_live_pages_untouched(cuda, mode):
    """Capturing both speculative graphs mid-run writes only the trash
    page of the target's pools and of the draft's."""
    eng = _spec(cuda, mode, config={"enable_cuda_graph": True},
                pipeline=False)
    r = np.random.default_rng(2)
    for n in (30, 21, 7):
        eng.put_request(r.integers(0, 256, size=n), max_new_tokens=20)
    while any(s is None or s.prefill_done < s.ctx_len
              for s in eng.slots[:3]):
        eng.step()
    eng._draft_catchup([s for s in eng.slots if s is not None])
    assert eng.host_stats.graph_captures == 0
    pools = eng.cache + eng._draft_cache
    torch.cuda.synchronize()
    before = [p.pages[1:].clone() for p in pools]
    for sampled in (False, True):
        eng._graphs.ensure(sampled, spec=True)
    torch.cuda.synchronize()
    assert _spec_captures(eng) == 2
    for b, p in zip(before, pools):
        assert torch.equal(b.view(torch.uint8),
                           p.pages[1:].view(torch.uint8))
    while eng.has_work():
        eng.step()
    eng.audit_kv_sharing()


@pytest.mark.gpu
def test_lc_graphs_resume_after_the_long_request(cuda, tmp_path):
    """A 180 + 40 request (14 pages) on a 14-page pool under partial
    residency beside a 20 + 100 request: its eager chunked-scan ticks
    and the other's fused ticks while it is live, then replayed decode
    blocks; the same tokens as the eager unpipelined engine."""
    tier = {"host_pages": 16, "nvme_pages": 16, "nvme_dir": str(tmp_path),
            "long_context": True, "sink_pages": 1, "window_pages": 2,
            "chunk_pages": 2}
    r = np.random.default_rng(3)
    reqs = [(r.integers(0, 256, size=180), 40),
            (r.integers(0, 256, size=20), 100)]
    outs, module = [], None
    for graphs in (False, True):
        eng = _v2(cuda, module=module, num_pages=14, kv_tiering=tier,
                  pipeline=graphs, config={"enable_cuda_graph": graphs})
        module = eng.module
        during = []
        start = eng._pipeline_start if graphs else eng._step_block

        def started(*a, _start=start, _eng=eng, **k):
            during.append(any(s is not None and s.lc and not s.done
                              for s in _eng.slots))
            return _start(*a, **k)

        if graphs:
            eng._pipeline_start = started
        else:
            eng._step_block = started
        uids = [eng.put_request(p, max_new_tokens=n) for p, n in reqs]
        assert eng.waiting[0].lc and not eng.waiting[1].lc
        got = {}
        while eng.has_work():
            eng.step()
            got.update(eng.get_outputs())
            eng.audit_kv_sharing()
        st = eng.serving_stages()
        assert eng._lc.ticks > 0 and st["kv_tiering"]["pageins"] > 0
        assert during and not any(during), during
        if graphs:
            assert st["graph_replays"] > 0
        outs.append([got[u] for u in uids])
        eng.close()
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["w8a8", "fp6"])
def test_v2_graphs_with_quantized_weights(cuda, fmt):
    """A v2 block over w8a8 weights (the W8A8 GEMM once a Linear) and
    over fp6 weights (K2 a weight), replayed from graphs with the pipeline
    on, gives the eager unpipelined engine's tokens, greedy and sampled;
    the kernels' Python counters tick at warm-ups and captures only."""
    from deepspeed_tpu_torch.ops import quantization as qz

    eager = _v2(cuda, quantize_weights=fmt, pipeline=False)
    module = eager.module
    want = _serve(eager, sampled=True)
    counter = qz.w8a8_gemm if fmt == "w8a8" else qz.dequantize_fp6
    per = 7 * TINY["num_hidden_layers"] + (1 if fmt == "w8a8" else 2)
    graphed = _v2(cuda, module, pipeline=True,
                  config={"enable_cuda_graph": True})
    before = counter.launches
    got = _serve(graphed, sampled=True)
    for a, b in zip(want, got, strict=True):
        np.testing.assert_array_equal(a, b)
    st = graphed.serving_stages()
    K = V2["decode_block_size"]
    assert st["graph_captures"] >= 1 and st["graph_replays"] >= 1
    eager_ticks = graphed.host_stats.ticks - K * st["graph_replays"]
    assert counter.launches - before == per * (
        eager_ticks + 2 * K * st["graph_captures"])


@pytest.mark.gpu
def test_two_engines_capture_and_replay_from_two_threads(cuda):
    """Two engines over one module on one card, each stepped from its own
    thread as the scale-out replicas are: each captures its graphs while
    the other runs (allocations, pinned staging, syncs), replays them,
    and gives the tokens it gives when run alone.  Captures run in
    ``thread_local`` mode under a process-wide lock (``capture_graph``),
    so neither thread's work breaks the other's capture."""
    import threading

    alone = _v2(cuda, pipeline=False)
    module = alone.module
    want = {s: _serve(_v2(cuda, module, pipeline=False), s)
            for s in (False, True)}
    engines = {s: _v2(cuda, module, pipeline=True,
                      kv_tiering={"host_pages": 64},
                      config={"enable_cuda_graph": True})
               for s in (False, True)}
    got, errors = {}, []
    start = threading.Barrier(2)

    def run(sampled):
        try:
            start.wait()
            got[sampled] = _serve(engines[sampled], sampled)
        except BaseException as e:          # re-raised on the main thread
            errors.append(e)

    threads = [threading.Thread(target=run, args=(s,)) for s in (False, True)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    for s in (False, True):
        for a, b in zip(got[s], want[s], strict=True):
            np.testing.assert_array_equal(a, b)
        st = engines[s].serving_stages()
        assert st["graph_captures"] >= 1 and st["graph_replays"] > 0
        engines[s].close()
