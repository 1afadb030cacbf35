"""The port's sparse MoE (``moe/``, ``models/mixtral.py``,
``models/qwen2_moe.py``, the bridge's MoE families, MoE serving in v1 and
v2) against the JAX package's, on the CPU in fp32.

- Gating (``topkgating`` at k 1, 2 and 4, ``normalize_weights`` on and
  off, a capacity factor low enough that copies drop), ``routing_plan``
  and the sorted, einsum and gather dispatch/combine against the JAX
  functions on seeded numpy inputs: experts, slots, the drop pattern,
  ``exp_counts`` and the routing plan equal; weights, ``l_aux`` and the
  dense combine tensor within 1e-6; dispatched and combined rows within
  1e-5.
- The ``MoE`` layer against the flax layer (swiglu and gelu, every
  dispatch, drops forced): output within 1e-5, ``l_aux`` within 1e-6.
- ``tinymixtral`` and ``tinyqwen2moe``: flax params through the bridge
  (scan-stacked and unrolled), logits within 1e-5 and aux within 1e-6,
  and back to the same flax tree.
- v1 greedy tokens against the JAX v1 engine's; v2 greedy tokens against
  the JAX v2 engine's on the JAX breadth tests' schedule, once at the
  family's capacity factor and once at 0.5 with capacity 1 allowed, where
  copies drop inside the fused tick and inside the decode block (counted
  from the port's gating); v2 with n-gram speculation, the prefix cache
  and KV tiering against the JAX engine with the same.
- The refusals, each naming its ROADMAP item: ``alltoall``, ``Jitter``,
  an MoE draft model, long context; and native w8a8 on MoE, which no
  engine serves (``ValueError``).

The JAX engines run once a module, in fixtures.
"""
import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import mixtral as jax_mixtral
from deepspeed_tpu.models import qwen2_moe as jax_qwen
from deepspeed_tpu.moe import layer as jax_layer
from deepspeed_tpu.moe import sharded_moe as jsm
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama, mixtral, qwen2_moe
from deepspeed_tpu_torch.module_inject.flax_bridge import (
    flax_to_state_dict, state_dict_to_flax)
from deepspeed_tpu_torch.moe import layer as port_layer
from deepspeed_tpu_torch.moe import sharded_moe as psm
import torch_cpu  # noqa: F401  (one torch thread a process)

FAMILIES = {
    "mixtral": (jax_mixtral, mixtral, "tinymixtral", "MixtralForCausalLM"),
    "qwen2_moe": (jax_qwen, qwen2_moe, "tinyqwen2moe",
                  "Qwen2MoeForCausalLM"),
}
SMALL = dict(vocab_size=64, max_position_embeddings=64)
# the JAX breadth tests' v2 schedule (tests/unit/inference/
# test_ragged_engine.py, _serve_matches_v1)
V2 = dict(max_seqs=3, max_seq_len=64, prefill_chunk=8, page_size=16,
          decode_block_size=4)
V2_NEW = 6
# low capacity: the fused tick (T = 11 rows, C = 3) and the decode block
# (3 rows, C = 1) both drop copies
LOW_CAP = dict(capacity_factor=0.5, min_capacity=1)


def _prompts(sizes, seed):
    r = np.random.default_rng(seed)
    return [r.integers(1, 64, size=(s,), dtype=np.int32) for s in sizes]


def _jax_cfg(family, scan_layers=False, **kw):
    """The flax config; ``dispatch_impl="sorted"``, what ``"auto"`` gives
    on one device in both packages, pinned: the JAX layer resolves
    ``"auto"`` against the mesh installed in the process, which an
    earlier test of the same worker may have left behind."""
    jmod, _, preset, _ = FAMILIES[family]
    return jmod.get_config(preset, **SMALL, dtype=jnp.float32,
                           param_dtype=jnp.float32, scan_layers=scan_layers,
                           remat=False, use_flash_attention=False,
                           dispatch_impl="sorted", **kw)


def _jax_model(family, **kw):
    jmod, _, _, cls = FAMILIES[family]
    return getattr(jmod, cls)(_jax_cfg(family, **kw))


def _port_model(family, **kw):
    _, pmod, preset, cls = FAMILIES[family]
    with torch.device("meta"):
        return getattr(pmod, cls)(pmod.get_config(
            preset, **SMALL, dtype=torch.float32, **kw))


def _init(model, seed, unbox=True):
    """The flax params as numpy arrays; the expert banks boxed in their
    partitioning metadata unless ``unbox``."""
    params = jax.jit(model.init)(jax.random.PRNGKey(seed),
                                 np.zeros((1, 8), np.int32))
    if unbox:
        params = fnn.meta.unbox(params)
    return jax.tree_util.tree_map(np.asarray, params)


# -- gating and dispatch ------------------------------------------------

G, E, M = 24, 6, 8


@pytest.mark.parametrize("k", [1, 2, 4])
@pytest.mark.parametrize("normalize", [True, False])
def test_gating_and_dispatch_match_jax(k, normalize):
    r = np.random.default_rng(10 * k + normalize)
    logits = r.standard_normal((G, E)).astype(np.float32)
    x = r.standard_normal((G, M)).astype(np.float32)
    out = r.standard_normal((E, 1, M)).astype(np.float32)
    kw = dict(k=k, capacity_factor=0.5, min_capacity=1,
              normalize_weights=normalize)
    jg = jsm.topkgating(jnp.asarray(logits), **kw)
    pg = psm.topkgating(torch.from_numpy(logits), **kw)
    C = jg.combine.shape[-1]
    assert pg.capacity == C
    for f in ("experts", "positions", "exp_counts"):
        np.testing.assert_array_equal(getattr(pg, f).numpy(),
                                      np.asarray(getattr(jg, f)), f)
    np.testing.assert_array_equal(pg.weights.numpy() > 0,
                                  np.asarray(jg.weights) > 0)
    assert (np.asarray(jg.weights) == 0).any(), "no copy dropped"
    np.testing.assert_allclose(pg.weights.numpy(), jg.weights, atol=1e-6)
    np.testing.assert_allclose(float(pg.l_aux), float(jg.l_aux), atol=1e-6)
    np.testing.assert_allclose(pg.combine.numpy(), jg.combine, atol=1e-6)
    np.testing.assert_array_equal(pg.dispatch.numpy(), jg.dispatch)

    jp, pp = jsm.routing_plan(jg, E), psm.routing_plan(pg)
    np.testing.assert_array_equal(pp.slot_token.numpy(), jp.slot_token)
    np.testing.assert_array_equal(pp.slot_of_copy.numpy(), jp.slot_of_copy)

    xt, jx = torch.from_numpy(x), jnp.asarray(x)
    out = np.broadcast_to(out, (E, C, M)) * (1 + np.arange(C))[:, None]
    ot, jo = torch.from_numpy(np.ascontiguousarray(out)), jnp.asarray(out)
    disp = {"sorted": psm.sorted_dispatch(xt, pp.slot_token),
            "einsum": psm.moe_dispatch(xt, pg.dispatch),
            "gather": psm.moe_dispatch_gather(xt, pg)}
    want = jsm.moe_dispatch(jx, jg.dispatch)
    comb = {"sorted": psm.sorted_combine(ot, pg.weights, pp.slot_of_copy),
            "einsum": psm.moe_combine(ot, pg.combine),
            "gather": psm.moe_combine_gather(ot, pg)}
    want_y = jsm.moe_combine(jo, jg.combine)
    for impl in disp:
        np.testing.assert_allclose(disp[impl].numpy(), want, atol=1e-5,
                                   err_msg=impl)
        np.testing.assert_allclose(comb[impl].numpy(), want_y, atol=1e-5,
                                   err_msg=impl)


def test_capacity_and_top1_top2_match_jax():
    for args in [(24, 6, 0.5, 1, 2), (3, 60, 1.25, 4, 4), (528, 60, 1.25,
                                                         4, 4)]:
        assert psm.capacity(*args) == jsm.capacity(*args)
    logits = np.random.default_rng(1).standard_normal((8, 4)).astype(
        np.float32)
    for fn in ("top1gating", "top2gating"):
        pg = getattr(psm, fn)(torch.from_numpy(logits))
        jg = getattr(jsm, fn)(jnp.asarray(logits))
        np.testing.assert_array_equal(pg.experts.numpy(), jg.experts)
        np.testing.assert_allclose(pg.weights.numpy(), jg.weights, atol=1e-6)


@pytest.mark.parametrize("activation", ["swiglu", "gelu"])
@pytest.mark.parametrize("normalize", [True, False])
def test_moe_layer_matches_flax(activation, normalize):
    kw = dict(hidden_size=16, num_experts=4, intermediate_size=24, k=2,
              capacity_factor=0.5, min_capacity=1, activation=activation,
              normalize_weights=normalize)
    jl = jax_layer.MoE(**kw, dtype=jnp.float32, dispatch_impl="einsum")
    x = np.random.default_rng(2).standard_normal((2, 10, 16)).astype(
        np.float32)
    params = jax.tree_util.tree_map(np.asarray, fnn.meta.unbox(
        jl.init(jax.random.PRNGKey(4), x)))
    y, aux = jl.apply(params, x)
    pl = port_layer.MoE(**kw)
    pl.load_state_dict({k: torch.tensor(v)
                        for k, v in params["params"].items()})
    with torch.no_grad():
        py, paux = pl(torch.from_numpy(x))
    assert pl.gating(torch.from_numpy(x).reshape(-1, 16)).weights.eq(
        0).any(), "no copy dropped"
    np.testing.assert_allclose(py.numpy(), y, atol=1e-5)
    np.testing.assert_allclose(float(paux), float(aux), atol=1e-6)


# -- the model families through the bridge ------------------------------

@pytest.mark.parametrize("family,scan", [("mixtral", True),
                                         ("qwen2_moe", False)])
def test_bridged_logits_and_aux_match_flax(family, scan):
    jmodel = _jax_model(family, scan_layers=scan)
    boxed = _init(jmodel, seed=1, unbox=False)
    params = fnn.meta.unbox(boxed)
    ids = np.random.default_rng(0).integers(0, 64, (2, 9), dtype=np.int32)
    jlogits, jaux = jax.jit(jmodel.apply)(params, ids)
    model = _port_model(family)
    model.to_empty(device="cpu")
    # the tree as init returns it: the banks in partitioning boxes
    model.load_state_dict(flax_to_state_dict(boxed), strict=True)
    with torch.no_grad():
        logits, aux = model(torch.from_numpy(ids).long())
    np.testing.assert_allclose(logits.numpy(), jlogits, atol=1e-5)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6)
    # and back: the same flax tree, and through the other layout the
    # same state_dict
    sd = model.state_dict()
    back = state_dict_to_flax(sd, scan_layers=scan)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params["params"])
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params["params"])):
        np.testing.assert_array_equal(a, b)
    other = flax_to_state_dict(state_dict_to_flax(sd, scan_layers=not scan))
    assert other.keys() == sd.keys()
    for name, t in sd.items():
        assert torch.equal(other[name], t), name


def test_bridge_tells_the_families_apart():
    """An MoE ``mlp`` (raw ``w1``) is not Llama's dense ``mlp``; a tree
    of neither family is refused."""
    moe_mlp = {"model": {"layers_0": {"mlp": {
        "gate": np.zeros((4, 2), np.float32),
        "w1": np.zeros((2, 4, 3), np.float32)}}}}
    sd = flax_to_state_dict(moe_mlp)
    assert set(sd) == {"model.layers.0.mlp.gate", "model.layers.0.mlp.w1"}
    assert sd["model.layers.0.mlp.gate"].shape == (4, 2)   # not transposed
    dense = {"model": {"layers_0": {"mlp": {"gate_proj": {
        "kernel": np.zeros((4, 3), np.float32)}}}}}
    assert set(flax_to_state_dict(dense)) == {
        "model.layers.0.mlp.gate_proj.weight"}
    with pytest.raises(KeyError):
        flax_to_state_dict({"model": {"layers_0": {
            "block_sparse_moe": {"w9": np.zeros((2, 2))}}}})
    with pytest.raises(KeyError):
        flax_to_state_dict({"model": {"layers_0": {
            "mlp": {"router": np.zeros((2, 2))}}}})


def test_presets_count_params_and_flops_match_jax():
    for jmod, pmod, _, _ in FAMILIES.values():
        assert pmod.PRESETS == jmod.PRESETS
        for preset in pmod.PRESETS:
            jcfg, pcfg = jmod.get_config(preset), pmod.get_config(preset)
            for s in (None, 512):
                assert pmod.flops_per_token(pcfg, s) == \
                    jmod.flops_per_token(jcfg, s)
    # Qwen1.5-MoE-A2.7B at full size: 14.3 B parameters
    with torch.device("meta"):
        m = qwen2_moe.Qwen2MoeForCausalLM(
            qwen2_moe.get_config("qwen1.5-moe-a2.7b"))
    assert 14.2e9 < qwen2_moe.count_params(m) < 14.4e9


# -- serving ---------------------------------------------------------------

def _count_drops(module):
    """Wrap every MoE layer's gating to log (rows, copies dropped) per
    call; returns the log."""
    log = []
    for mod in module.modules():
        if isinstance(mod, port_layer.MoE):
            inner = mod.gating

            def gating(x, *a, _inner=inner, **kw):
                gr = _inner(x, *a, **kw)
                log.append((x.shape[0], int((gr.weights == 0).sum())))
                return gr
            mod.gating = gating
    return log


_SHARED = _prompts([16], seed=30)[0]
# case: (config fields, engine settings, prompts, new tokens)
CASES = {
    "base": ({}, {}, _prompts([5, 11, 3], seed=22), V2_NEW),
    "low_capacity": (LOW_CAP, {}, _prompts([5, 11, 3], seed=22), V2_NEW),
    # the last request shares the first one's 16-token page, and the
    # 4-page pool spills
    "spec_prefix_tiering": ({}, dict(
        speculation="ngram", prefix_cache=True, num_pages=4,
        kv_tiering={"host_pages": 32}),
        [np.concatenate([_SHARED, _prompts([3], 23)[0]])] +
        _prompts([9, 20], 24) +
        [np.concatenate([_SHARED, _prompts([5], 25)[0]])], 16),
}


@pytest.fixture(scope="module")
def v2_served():
    """The JAX v2 engine's greedy outputs and the bridged weights, per
    case (qwen2_moe)."""
    out = {}
    for case, (cfg_kw, eng_kw, prompts, new) in CASES.items():
        jmodel = _jax_model("qwen2_moe", **cfg_kw)
        params = _init(jmodel, seed=22)
        eng = JaxEngine(jmodel, params=params, pipeline=False,
                        **{**V2, **eng_kw})
        out[case] = (flax_to_state_dict(params),
                     eng.generate_all(prompts, max_new_tokens=new))
        eng.close()
    return out


@pytest.mark.parametrize("case", list(CASES))
def test_v2_greedy_matches_jax_engine(v2_served, case):
    cfg_kw, eng_kw, prompts, new = CASES[case]
    state, want = v2_served[case]
    eng = RaggedInferenceEngineV2(_port_model("qwen2_moe", **cfg_kw),
                                  params=state, device="cpu",
                                  pipeline=False, **{**V2, **eng_kw})
    log = _count_drops(eng.module)
    got = eng.generate_all(prompts, max_new_tokens=new)
    eng.audit_kv_sharing()
    stages = eng.serving_stages()
    spills = eng.spills
    eng.close()
    assert sorted(got) == sorted(want)
    for uid in want:
        np.testing.assert_array_equal(got[uid], want[uid], err_msg=case)
    if case == "low_capacity":
        # the fused tick routes all T rows, the block one row a slot
        tick = sum(d for g, d in log if g == V2["max_seqs"] +
                   V2["prefill_chunk"])
        block = sum(d for g, d in log if g == V2["max_seqs"])
        assert tick > 0 and block > 0, log
    if case == "spec_prefix_tiering":
        hits = stages["prefix_cache"]["hit_requests"]
        assert spills > 0 and hits > 0, (spills, hits)
        assert stages["speculation"]["spec_dispatches"] > 0


@pytest.fixture(scope="module")
def v1_served():
    jmodel = _jax_model("mixtral")
    params = _init(jmodel, seed=5)
    prompts = np.random.default_rng(5).integers(0, 64, (2, 6),
                                                dtype=np.int32)
    eng = deepspeed_tpu.init_inference(
        jmodel, config={"dtype": "float32", "max_out_tokens": 32},
        params=params["params"])
    return (flax_to_state_dict(params), prompts,
            np.asarray(eng.generate(prompts, max_new_tokens=8)))


@pytest.mark.parametrize("graphed", [False, True])
def test_v1_greedy_matches_jax_engine(v1_served, graphed):
    state, prompts, want = v1_served
    eng = deepspeed_tpu_torch.init_inference(
        _port_model("mixtral"), params=state, device="cpu",
        config={"dtype": "float32", "max_out_tokens": 32,
                "enable_cuda_graph": graphed})
    got = eng.generate(prompts, max_new_tokens=8).numpy()
    np.testing.assert_array_equal(got, want)


def test_v2_keeps_the_router_fp32():
    """v2 casts every weight to the serving dtype but the router, as the
    JAX v2 engine (which casts nothing) leaves it; v1 casts it too, as
    the JAX v1 engine does."""
    cfg = qwen2_moe.get_config("tinyqwen2moe", **SMALL)
    with torch.device("meta"):
        model = qwen2_moe.Qwen2MoeForCausalLM(cfg)
    eng = RaggedInferenceEngineV2(model, device="cpu", **V2)
    moe = eng.module.model.layers[0].mlp
    assert moe.gate.dtype == torch.float32
    assert moe.w1.dtype == torch.bfloat16
    with torch.device("meta"):
        model = qwen2_moe.Qwen2MoeForCausalLM(cfg)
    v1 = deepspeed_tpu_torch.init_inference(model, device="cpu",
                                            config={"dtype": "bfloat16"})
    assert v1.module.model.layers[0].mlp.gate.dtype == torch.bfloat16


# -- refusals ----------------------------------------------------------------

def _tiny_llama():
    with torch.device("meta"):
        return llama.LlamaForCausalLM(llama.LlamaConfig(
            **SMALL, hidden_size=32, intermediate_size=64,
            num_hidden_layers=1, num_attention_heads=4,
            num_key_value_heads=2, dtype=torch.float32))


@pytest.mark.parametrize("make,item", [
    (lambda: port_layer.MoE(8, 2, 8, dispatch_impl="alltoall"), "A11"),
    (lambda: port_layer.MoE(8, 2, 8, noisy_gate_policy="Jitter"), "A11"),
    (lambda: _port_model("mixtral", dispatch_impl="alltoall"), "A11"),
    # an MoE draft is ported (A12c, tests/test_torch_moe_draft.py): the
    # case now checks that the engine takes one (item None); the id is
    # kept
    pytest.param(lambda: RaggedInferenceEngineV2(
        _tiny_llama(), device="cpu", speculation="draft",
        draft_model=_port_model("mixtral"), **V2), None, id="make3-A12c"),
])
def test_unported_moe_cases_raise(make, item):
    if item is None:
        assert make()._draft_moe
        return
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        make()


@pytest.mark.parametrize("make", [
    lambda: RaggedInferenceEngineV2(_port_model("qwen2_moe"), device="cpu",
                                    quantize_weights="w8a8", **V2),
    lambda: _port_model("mixtral", weight_quant="w8a8")],
    ids=["v2_quantize_weights", "model_config"])
def test_native_w8a8_moe_refused(make):
    """No engine serves an MoE model's expert banks through the native
    W8A8 product (the JAX v2 engine asserts its model is all w8a8-native
    Dense layers): v2's ``quantize_weights="w8a8"`` and a model config's
    ``weight_quant="w8a8"`` raise ``ValueError`` saying so.  The quantized
    banks the engines do serve are ``tests/test_torch_moe_quant.py``'s."""
    with pytest.raises(ValueError, match="expert banks are no Linear"):
        make()


@pytest.mark.parametrize("impl", ["einsum", "gather"])
def test_layer_serves_sorted_only(impl):
    """The einsum and gather dispatches are the oracles above, not serving
    paths: the layer and the model configs refuse them."""
    with pytest.raises(ValueError, match="parity oracle"):
        port_layer.MoE(8, 2, 8, dispatch_impl=impl)
    with pytest.raises(ValueError, match="parity oracle"):
        _port_model("qwen2_moe", dispatch_impl=impl)


def test_long_context_refuses_moe_like_jax():
    """The JAX long-context path takes ``LlamaForCausalLM`` only
    (``inference/v2/long_context.py:106``); so does the port's."""
    with pytest.raises(NotImplementedError, match="Llama-family"):
        RaggedInferenceEngineV2(
            _port_model("qwen2_moe"), device="cpu", num_pages=8,
            kv_tiering={"host_pages": 64, "long_context": True}, **V2)
