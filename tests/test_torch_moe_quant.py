"""The port's quantized expert banks (``QuantizedBank``, ``quantize_model_``
on an ``MoE`` layer, the module-at-a-time quantized build, the bridge's
quantized banks, MoE serving with ``quantize_weights`` / ``quant``)
against the JAX package's, on the CPU in fp32 at tiny sizes
(``tinymixtral``, ``tinyqwen2moe``).

- ``quantize_model_`` against ``quantize_param_tree`` for both families
  and every format: the same leaves quantized (the router ``gate`` not,
  banks group-wise int8 under w8a8), ``(bytes_before, bytes_after)``
  equal, and the JAX payloads carried by the bridge byte-equal to the
  port's own.
- The bridge over a scan-stacked and an unrolled quantized tree: every
  bank dequantized by the port bit-equal to ``dequantize_param_tree``'s.
- The module-at-a-time build (``normalize_params(..., quantize=...)`` on a
  meta model) gives buffers bit-identical to the whole model drawn and
  then quantized, in both engines' casts.
- v2 greedy tokens equal the JAX v2 engine's with int8, fp8 and fp6 banks
  for both families, at a capacity low enough that copies drop, and with
  n-gram speculation, the prefix cache and KV tiering over int8 banks;
  a 1P1D router's handoff over int8 banks gives a fused engine's tokens;
  ``quantize_weights="w8a8"`` on MoE is refused as the JAX v2 engine
  refuses it.
- v1 greedy tokens equal ``deepspeed_tpu.init_inference``'s with
  ``quant.qtype`` int8, fp8, fp6 and w8a8 for both families.
"""
import functools
import weakref

import flax.linen as fnn
import jax
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import quantization as jax_iq
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu_torch.inference import quantization as iq
from deepspeed_tpu_torch.inference.common import normalize_params
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from deepspeed_tpu_torch.moe.layer import MoE
from test_torch_moe import (CASES, FAMILIES, V2, V2_NEW, _count_drops,
                            _jax_model, _port_model, _prompts)
import torch_cpu  # noqa: F401  (one torch thread a process)

FORMATS = ["int8", "fp8", "fp6"]
BANK = {"mixtral": "block_sparse_moe", "qwen2_moe": "mlp"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_leaves(qtree):
    """``{path: QuantizedWeight}`` of a quantized tree."""
    out = {}

    def visit(path, leaf):
        if isinstance(leaf, jax_iq.QuantizedWeight):
            out["/".join(str(getattr(k, "key", k)) for k in path)] = leaf
    jax.tree_util.tree_map_with_path(
        visit, qtree,
        is_leaf=lambda x: isinstance(x, jax_iq.QuantizedWeight))
    return out


def _bits(t):
    return t.contiguous().reshape(-1).view(torch.uint8)


def _loaded(family, state, **kw):
    model = _port_model(family, **kw)
    model.to_empty(device="cpu")
    model.load_state_dict(state)
    return model


# -- the quantized weights against quantize_param_tree ----------------------

@functools.lru_cache(maxsize=None)
def _jit_init(family, scan):
    """The family's ``model.init`` jitted once: every seed reuses its
    compile."""
    return jax.jit(_jax_model(family, scan_layers=scan).init)


@functools.lru_cache(maxsize=None)
def _params(family, seed, scan=False):
    """The flax params of the family's tiny model, initialised once, as
    ``test_torch_moe._init`` makes them."""
    params = _jit_init(family, scan)(jax.random.PRNGKey(seed),
                                     np.zeros((1, 8), np.int32))
    return _np(fnn.meta.unbox(params))


@pytest.mark.parametrize("fmt", FORMATS + ["w8a8"])
@pytest.mark.parametrize("family,min_size", [("mixtral", 1024),
                                             ("qwen2_moe", 32)])
def test_quantize_model_matches_quantize_param_tree(family, min_size, fmt):
    """Qwen2-MoE at ``min_size`` 32: its shared-expert gate ([32, 1] here,
    [2048, 1] at the preset's width, over the engines' 1024) is quantized,
    as JAX quantizes it; the router never is."""
    params = _params(family, 7)["params"]
    qtree, jb0, jb1 = jax_iq.quantize_param_tree(params, fmt,
                                                 min_size=min_size)
    model = _loaded(family, flax_to_state_dict(params))
    assert iq.quantize_model_(model, fmt, min_size=min_size) == (jb0, jb1)
    quantized = {n: m for n, m in model.named_modules()
                 if isinstance(m, iq._Quantized)}
    leaves = _jax_leaves(qtree)
    assert len(quantized) == len(leaves)
    banks = {n for n, m in quantized.items()
             if isinstance(m, iq.QuantizedBank)}
    assert len(banks) == 3 * 2 == sum(
        n.rsplit("/", 1)[1] in ("w1", "w2", "w3") for n in leaves)
    for n, m in quantized.items():  # w8a8 sends banks to group-wise int8
        jl = leaves[n.replace(".layers.", "/layers_").replace(".", "/") +
                    ("" if n in banks else "/kernel" if isinstance(
                        m, iq.QuantizedLinear) else "/embedding")]
        assert m.fmt == jl.fmt and m.group_size == jl.group_size or (
            m.fmt == "int8" and jl.group_size == 0), n
        if n in banks:
            assert m.fmt == ("int8" if fmt == "w8a8" else fmt)
    for mod in model.modules():
        if isinstance(mod, MoE):
            assert isinstance(mod.gate, torch.nn.Parameter)     # the router
            assert mod.gate.dtype == torch.float32
    if family == "qwen2_moe":
        assert isinstance(model.model.layers[0].shared_expert_gate,
                          iq.QuantizedLinear)
    # JAX's own payloads, carried across the bridge, equal the port's
    bridged = flax_to_state_dict(_np(qtree))
    state = model.state_dict()
    assert bridged.keys() == state.keys()
    for k, t in state.items():
        assert t.dtype == bridged[k].dtype and t.shape == bridged[k].shape, k
        assert torch.equal(_bits(t), _bits(bridged[k])), k


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("scan", [True, False], ids=["stacked", "unrolled"])
def test_bridge_carries_quantized_banks(scan, fmt):
    """Every bank of a JAX-quantized tree, dequantized by the port after
    the bridge, equals ``dequantize_param_tree``'s bit for bit; a stacked
    fp8 bank takes its layer's payload slice and the one scale."""
    params = _params("mixtral", 8, scan)["params"]
    qtree, _, _ = jax_iq.quantize_param_tree(params, fmt)
    want = _np(jax_iq.dequantize_param_tree(qtree))
    model = _port_model("mixtral")
    model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    iq.quantize_model_(model, fmt)
    model.load_state_dict(flax_to_state_dict(_np(qtree)), strict=True)
    n = 0
    for i, layer in enumerate(model.model.layers):
        moe = layer.block_sparse_moe
        for name in moe.banks:
            got = getattr(moe, name).dequantized()
            ref = (want["model"]["layers"]["block"]["block_sparse_moe"]
                   [name][i] if scan else
                   want["model"][f"layers_{i}"]["block_sparse_moe"][name])
            np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
            n += 1
    assert n == 6


# -- the module-at-a-time build -----------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS + ["w8a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_module_at_a_time_build_is_bit_identical(family, fmt):
    """A meta model materialised, drawn and quantized one module at a
    time holds the buffers and parameters of the same model drawn whole
    and quantized afterwards, in v2's cast (router fp32) and v1's."""
    for keep_fp32, dtype in ((True, torch.bfloat16), (False, torch.float16)):
        kw = dict(dtype=dtype, device=torch.device("cpu"),
                  keep_fp32=keep_fp32)
        gen = torch.Generator().manual_seed(3)
        streamed = normalize_params(_port_model(family), generator=gen,
                                    quantize=dict(fmt=fmt), **kw)
        gen = torch.Generator().manual_seed(3)
        whole = normalize_params(_port_model(family), generator=gen, **kw)
        # a second pass over the streamed build finds nothing to quantize
        resident = iq.quantize_model_(whole, fmt)[1]
        assert iq.quantize_model_(streamed, fmt)[1] == resident
        a, b = streamed.state_dict(), whole.state_dict()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and not a[k].is_meta, k
            assert torch.equal(_bits(a[k]), _bits(b[k])), k
        moe = streamed.model.layers[0]
        moe = getattr(moe, BANK[family])
        assert isinstance(moe.w2, iq.QuantizedBank)
        assert moe.gate.dtype == (torch.float32 if keep_fp32 else dtype)


@pytest.mark.parametrize("fmt", ["int8", "w8a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_module_at_a_time_build_frees_each_weight(family, fmt):
    """When a module is drawn, no weight already quantized is alive: the
    full-precision weights in memory are the drawn module's own and those
    that stay full precision (norms, the router), never the model's."""
    model = _port_model(family)
    draw_module = model.init_module_weights
    drawn, live = [], []       # weakrefs to the drawn weights; alive ones

    def spy(mod, generator):
        live.append({i for i, r in enumerate(drawn) if r() is not None})
        draw_module(mod, generator)
        drawn.extend(weakref.ref(p) for p in mod.parameters(recurse=False))

    model.init_module_weights = spy
    normalize_params(model, dtype=torch.bfloat16, device=torch.device("cpu"),
                     generator=torch.Generator().manual_seed(3),
                     keep_fp32=True, quantize=dict(fmt=fmt))
    kept = {id(p) for p in model.parameters()}
    replaced = {i for i, r in enumerate(drawn)
                if r() is None or id(r()) not in kept}
    assert len(replaced) >= sum(isinstance(m, iq._Quantized)
                                for m in model.modules()) > 0
    for i, alive in enumerate(live):
        assert not alive & replaced, (
            f"draw {i}: {len(alive & replaced)} replaced weights alive")


# -- v2 against the JAX v2 engine ---------------------------------------------

V2_CASES = [(fam, fmt, "base") for fam in FAMILIES for fmt in FORMATS] + [
    ("qwen2_moe", "int8", "low_capacity"),
    ("qwen2_moe", "int8", "spec_prefix_tiering")]


V1_FORMATS = FORMATS + ["w8a8"]
V1_CASES = [(family, fmt) for family in FAMILIES for fmt in V1_FORMATS]
V1_PROMPTS = np.random.default_rng(6).integers(0, 64, (2, 6), dtype=np.int32)


def _v1_config(fmt):
    return {"dtype": "float32", "max_out_tokens": 32,
            "quant": {"enabled": True, "qtype": fmt}}


@pytest.fixture(scope="module")
def jax_served():
    """The JAX engines' greedy outputs with quantized weights, and the
    bridged (unquantized) weights they served, per v2 case (``"v2"``,
    family, format, case) and per v1 case (``"v1"``, family, format).
    Their compiles are most of this file's time."""
    v2_params = {family: _params(family, 23) for family in FAMILIES}
    v1_params = {family: _params(family, 6) for family in FAMILIES}

    def serve(engine, family, fmt, case=None):
        if engine == "v1":
            eng = deepspeed_tpu.init_inference(
                _jax_model(family), config=_v1_config(fmt),
                params=v1_params[family]["params"])
            return flax_to_state_dict(v1_params[family]), np.asarray(
                eng.generate(V1_PROMPTS, max_new_tokens=V2_NEW))
        cfg_kw, eng_kw, prompts, new = CASES[case]
        eng = JaxEngine(_jax_model(family, **cfg_kw),
                        params=v2_params[family],  # capacity: no parameter
                        pipeline=False, quantize_weights=fmt,
                        **{**V2, **eng_kw})
        out = eng.generate_all(prompts, max_new_tokens=new)
        eng.close()
        return flax_to_state_dict(v2_params[family]), out

    cases = [("v2", *c) for c in V2_CASES] + [("v1", *c) for c in V1_CASES]
    return {c: serve(*c) for c in cases}


@pytest.mark.parametrize("family,fmt,case", V2_CASES,
                         ids=["-".join(c) for c in V2_CASES])
def test_v2_greedy_matches_jax_engine(jax_served, family, fmt, case):
    cfg_kw, eng_kw, prompts, new = CASES[case]
    state, want = jax_served["v2", family, fmt, case]
    eng = RaggedInferenceEngineV2(_port_model(family, **cfg_kw),
                                  params=state, device="cpu",
                                  pipeline=False, quantize_weights=fmt,
                                  **{**V2, **eng_kw})
    assert all(isinstance(getattr(m, b), iq.QuantizedBank)
               for m in eng.module.modules() if isinstance(m, MoE)
               for b in m.banks)
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
        T = V2["max_seqs"] + V2["prefill_chunk"]
        assert sum(d for g, d in log if g == T) > 0, log
        assert sum(d for g, d in log if g == V2["max_seqs"]) > 0, log
    if case == "spec_prefix_tiering":
        assert spills > 0 and stages["prefix_cache"]["hit_requests"] > 0
        assert stages["speculation"]["spec_dispatches"] > 0


def test_handoff_over_quantized_banks():
    """A 1P1D router (a prefill and a decode replica over one module with
    int8 banks, each with its own pool and host tier) gives a fused
    engine's greedy tokens over the same module; every long request hands
    its KV off.  ``drop_tokens`` is off: with a capacity, a row's experts
    depend on the rows it shares a tick with, which differ between a
    fused engine and the two replicas."""
    from deepspeed_tpu_torch.serving import ReplicaSet, Router

    state = flax_to_state_dict(_params("qwen2_moe", 23))
    tiers = {"host_pages": 64}
    fused = RaggedInferenceEngineV2(_port_model("qwen2_moe",
                                                drop_tokens=False),
                                    params=state,
                                    device="cpu", quantize_weights="int8",
                                    kv_tiering=tiers, **V2)
    module = fused.module
    prompts = _prompts([24, 5, 40, 7, 33, 6], seed=31)
    want = fused.generate_all(prompts, max_new_tokens=8)
    fused.close()
    rs = ReplicaSet(lambda i: RaggedInferenceEngineV2(
        module, device="cpu", kv_tiering=tiers, **V2), 2)
    router = Router(rs, policy="least_tokens")
    router.set_roles({"r0": "prefill", "r1": "decode"})
    rids = [router.submit(p, max_new_tokens=8) for p in prompts]
    outs = router.drain()
    stats = router.stats()
    rs.close()
    for rid, uid in zip(rids, sorted(want), strict=True):
        np.testing.assert_array_equal(outs[rid], want[uid])
    n_long = sum(p.size >= V2["page_size"] for p in prompts)
    assert stats["handoffs"] == stats["handoff_kv"] == n_long == 3


def test_v2_refuses_w8a8_on_moe_like_jax():
    """The JAX v2 engine asserts its model's Dense layers all consume
    w8a8 natively; an MoE model's do not.  The port refuses it with
    ``ValueError``."""
    with pytest.raises(AssertionError, match="w8a8"):
        JaxEngine(_jax_model("qwen2_moe"), params=_params("qwen2_moe", 23),
                  pipeline=False, quantize_weights="w8a8", **V2)
    for family in FAMILIES:
        with pytest.raises(ValueError, match="expert banks are no Linear"):
            RaggedInferenceEngineV2(_port_model(family), device="cpu",
                                    quantize_weights="w8a8", **V2)


# -- v1 against the JAX v1 engine ---------------------------------------------

@pytest.mark.parametrize("fmt", V1_FORMATS)
@pytest.mark.parametrize("family", list(FAMILIES))
def test_v1_greedy_matches_jax_engine(jax_served, family, fmt):
    state, want = jax_served["v1", family, fmt]
    eng = deepspeed_tpu_torch.init_inference(
        _port_model(family), params=state, device="cpu",
        config=_v1_config(fmt))
    banks = [getattr(m, b) for m in eng.module.modules()
             if isinstance(m, MoE) for b in m.banks]
    assert banks and all(
        isinstance(b, iq.QuantizedBank) and b.group_size in (0, 128)
        for b in banks)
    got = eng.generate(V1_PROMPTS, max_new_tokens=V2_NEW).numpy()
    np.testing.assert_array_equal(got, want)
