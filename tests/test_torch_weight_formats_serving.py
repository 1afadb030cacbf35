"""The engines with fp8, fp6 and w8a8 weights against the JAX engines, on
the tiny fp32 Llama of ``test_torch_quantization.py`` (unrolled layers).

- v1 (``quant.qtype``, groups of 128): forward logits within 1e-5
  relative of the JAX v1 engine's, inside the reference's error envelope
  against the unquantized serve (``1e-6 < rel < tol``: fp8 0.2, fp6 0.35,
  from ``tests/unit/inference/test_serving_quant.py``; w8a8, which v1
  dequantizes one scale an output channel, int8's 0.06), greedy tokens
  equal, eager and with the static-shape step.
- v2 (``quantize_weights``, groups of 2048): fp8 and fp6 greedy tokens
  equal to the JAX v2 engine's, pipelined and not.  w8a8 runs natively
  (``W8A8Linear``: activations quantized per row), whose output is not
  continuous in its input: a one-ulp difference in an activation (the
  two frameworks' RMSNorm, attention and reductions round differently)
  can move a quotient across a rounding boundary and one product by a
  quantization step.  So its tokens must equal the JAX engine's up to the
  first generated position where such a flip shows: the port's and the
  JAX model's w8a8 forwards over the JAX engine's tokens differ there by
  more than fp32 noise (1e-5 relative), or the JAX engine's token is not
  its own model's argmax.  Pipeline on and off (and the decode block's
  static buffers) give the same tokens exactly.
- A module class without ``w8a8_native`` is refused with "w8a8".
- Buffer dtypes after each engine's build (payload float8_e4m3fn, uint8
  or int8, scales fp32), kept by a second engine over the quantized
  module.
- Trees the JAX package quantized, carried by the bridge: buffers equal
  the port's own quantization's, and an engine over the bridged buffers
  serves the JAX engine's tokens; a scan-stacked fp8 leaf gives every
  layer its payload slice and the one scale; stacked fp6 groups that span
  layers and a stacked w8a8 leaf are refused.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference import quantization as jax_iq
from deepspeed_tpu.inference.v2 import RaggedInferenceEngineV2 as JaxEngine
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference import quantization as iq
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
import torch_cpu  # noqa: F401  (one torch thread a process)

FORMATS = ["fp8", "fp6", "w8a8"]
# head dim 64: every leaf a multiple of 2048 elements
TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)
V1 = {"dtype": "float32", "max_out_tokens": 32}
V2 = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, page_size=16,
          decode_block_size=8)
ENVELOPE = {"fp8": 0.2, "fp6": 0.35, "w8a8": 0.06}
PAYLOAD = {"fp8": torch.float8_e4m3fn, "fp6": torch.uint8,
           "w8a8": torch.int8}


def _flax_params(scan_layers=False, seed=3):
    cfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                param_dtype=jnp.float32, remat=False,
                                scan_layers=scan_layers,
                                use_flash_attention=False)
    params = jax_llama.LlamaForCausalLM(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _quant(fmt):
    return dict(V1, quant={"enabled": True, "qtype": fmt})


@pytest.fixture(scope="module")
def served():
    """Unrolled flax params of the tiny Llama, its bridged state, and the
    JAX engines' outputs per format (v1 logits and greedy tokens, v2
    greedy tokens; for w8a8 the JAX model's native forward over them)."""
    jcfg, params = _flax_params()
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, size=(2, 6), dtype=np.int32)
    v2_prompts = [rng.integers(1, 256, size=(s,), dtype=np.int32)
                  for s in (5, 9, 23, 40, 3, 17)]
    out = dict(jcfg=jcfg, params=params, state=flax_to_state_dict(params),
               prompts=prompts, v2_prompts=v2_prompts)
    eng = deepspeed_tpu.init_inference(jax_llama.LlamaForCausalLM(jcfg),
                                       config=V1, params=params)
    out["logits_plain"] = np.asarray(eng.forward(prompts))
    for fmt in FORMATS:
        eng = deepspeed_tpu.init_inference(
            jax_llama.LlamaForCausalLM(jcfg), config=_quant(fmt),
            params=params)
        out[f"logits_{fmt}"] = np.asarray(eng.forward(prompts))
        out[f"greedy_{fmt}"] = np.asarray(eng.generate(prompts,
                                                       max_new_tokens=8))
        eng = JaxEngine(jax_llama.LlamaForCausalLM(jcfg), params=params,
                        pipeline=False, quantize_weights=fmt, **V2)
        outs = eng.generate_all(v2_prompts, max_new_tokens=12)
        out[f"v2_{fmt}"] = [outs[u] for u in sorted(outs)]
    qtree, _, _ = jax_iq.quantize_param_tree(params, "w8a8")
    native = jax_iq.dequantize_param_tree(qtree, native_w8a8=True)
    model = jax_llama.LlamaForCausalLM(
        dataclasses.replace(jcfg, weight_quant="w8a8"))
    out["w8a8_forward"] = [
        np.asarray(model.apply({"params": native},
                               jnp.asarray(toks[None, :-1])))[0]
        for toks in out["v2_w8a8"]]
    return out


def _meta_model(cls=None):
    with torch.device("meta"):
        return (cls or llama.LlamaForCausalLM)(llama.LlamaConfig(
            **TINY, dtype=torch.float32))


def _v2(served, fmt, **kw):
    eng = RaggedInferenceEngineV2(_meta_model(), params=served["state"],
                                  device="cpu", quantize_weights=fmt,
                                  **{**V2, **kw})
    outs = eng.generate_all(served["v2_prompts"], max_new_tokens=12)
    return eng, [outs[u] for u in sorted(outs)]


def _check_buffers(module, fmt):
    quantized = [m for m in module.modules() if isinstance(m, iq._Quantized)]
    assert quantized
    for m in quantized:
        want = PAYLOAD[m.fmt] if m.fmt in PAYLOAD else torch.int8
        assert m.values.dtype == want, (m.fmt, m.values.dtype)
        assert m.scale.dtype == torch.float32
        assert m.fmt == fmt or (fmt == "w8a8" and m.fmt == "int8" and
                                isinstance(m, iq.QuantizedEmbedding))


# --------------------------------------------------------------------------
# v1
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_v1_matches_jax_engine(served, fmt):
    eng = deepspeed_tpu_torch.init_inference(
        _meta_model(), config=_quant(fmt), params=served["state"],
        device="cpu")
    _check_buffers(eng.module, fmt)
    if fmt == "fp6":
        assert eng.module.lm_head.group_size == 128
    logits = eng.forward(served["prompts"]).numpy()
    want = served[f"logits_{fmt}"]
    rel = np.abs(logits - want).max() / np.abs(want).max()
    assert rel < 1e-5, rel
    # the quantization engaged, inside the format's envelope
    ref = served["logits_plain"]
    rel = np.abs(logits - ref).max() / np.abs(ref).max()
    assert 1e-6 < rel < ENVELOPE[fmt], rel
    out = eng.generate(served["prompts"], max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), served[f"greedy_{fmt}"])
    # the static-shape decode step (CUDA graphs on the card) as well
    graphed = deepspeed_tpu_torch.init_inference(
        eng.module, config=dict(_quant(fmt), quant={"enabled": False},
                                enable_cuda_graph=True), device="cpu")
    out = graphed.generate(served["prompts"], max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), served[f"greedy_{fmt}"])


# --------------------------------------------------------------------------
# v2
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", ["fp8", "fp6"])
def test_v2_matches_jax_engine(served, fmt):
    for pipeline in (False, True):
        eng, got = _v2(served, fmt, pipeline=pipeline)
        for g, w in zip(got, served[f"v2_{fmt}"], strict=True):
            np.testing.assert_array_equal(g, w)
    _check_buffers(eng.module, fmt)
    audit = eng.audit_kv_sharing()
    assert audit["free"] == audit["total"] == eng.num_pages - 1


def test_v2_w8a8_matches_jax_engine(served):
    eng, got = _v2(served, "w8a8", pipeline=False)
    assert {type(m) for m in eng.module.modules()} >= {
        iq.W8A8Linear, iq.QuantizedEmbedding}
    assert eng.cfg.weight_quant == eng.module.config.weight_quant == "w8a8"
    exact = 0
    for p, g, w, jl in zip(served["v2_prompts"], got, served["v2_w8a8"],
                           served["w8a8_forward"], strict=True):
        P = len(p)
        with torch.no_grad():
            tl = eng.module(torch.from_numpy(w[None, :-1].astype(np.int64))
                            )[0].numpy()[P - 1:]
        jl = jl[P - 1:]
        # fp32 noise at every generated position without a rounding flip
        rel = np.abs(tl - jl).max(-1) / np.abs(jl).max(-1)
        flips = list(np.nonzero(rel > 1e-5)[0][:1])
        flips += list(np.nonzero(jl.argmax(-1) != w[P:])[0][:1])
        first_flip = min(flips, default=len(w) - P)
        diff = np.nonzero(g[P:] != w[P:])[0]
        first_diff = int(diff[0]) if diff.size else len(w) - P
        assert first_diff >= first_flip, (
            f"prompt {P}: token {first_diff} differs from the JAX engine's "
            f"before any rounding flip (first at {first_flip})")
        exact += first_flip == len(w) - P
    assert exact >= 1, "every request flipped: the comparison saw nothing"


def test_v2_w8a8_pipeline_on_and_off_equal(served):
    _, off = _v2(served, "w8a8", pipeline=False)
    eng, on = _v2(served, "w8a8", pipeline=True,
                  config={"enable_cuda_graph": True})
    for a, b in zip(off, on, strict=True):
        np.testing.assert_array_equal(a, b)
    _check_buffers(eng.module, "w8a8")
    # a second engine over the quantized module keeps its buffers' dtypes
    # (only parameters take the serving dtype) and its tokens
    again = RaggedInferenceEngineV2(eng.module, device="cpu", **V2)
    _check_buffers(again.module, "w8a8")
    outs = again.generate_all(served["v2_prompts"], max_new_tokens=12)
    for a, b in zip(off, [outs[u] for u in sorted(outs)], strict=True):
        np.testing.assert_array_equal(a, b)


def test_w8a8_needs_a_native_module():
    class NotNative(llama.LlamaForCausalLM):
        w8a8_native = False

    with pytest.raises(ValueError, match="w8a8"):
        RaggedInferenceEngineV2(_meta_model(NotNative), device="cpu",
                                quantize_weights="w8a8", **V2)
    # weight-only formats do not need the flag
    RaggedInferenceEngineV2(_meta_model(NotNative), device="cpu",
                            quantize_weights="fp8", **V2)


# --------------------------------------------------------------------------
# The bridge
# --------------------------------------------------------------------------

@pytest.mark.parametrize("fmt", FORMATS)
def test_bridged_tree_equals_port_quantization(served, fmt):
    """quantize_param_tree's tree (groups of 2048, as the JAX v2 engine
    quantizes), across the bridge, equals the port's own quantization
    byte for byte, and an engine over it serves the JAX engine's tokens
    (w8a8 over the same buffers as the port's own: see the rule above)."""
    qtree, jb0, jb1 = jax_iq.quantize_param_tree(served["params"], fmt)
    bridged = flax_to_state_dict(_np(qtree))
    model = llama.LlamaForCausalLM(llama.LlamaConfig(**TINY,
                                                     dtype=torch.float32))
    model.load_state_dict(served["state"])
    assert iq.quantize_model_(model, fmt, native_w8a8=True) == (jb0, jb1)
    state = model.state_dict()
    assert state.keys() == bridged.keys()
    for k, t in state.items():
        assert t.dtype == bridged[k].dtype and t.shape == bridged[k].shape
        assert torch.equal(t.reshape(-1).view(torch.uint8),
                           bridged[k].reshape(-1).view(torch.uint8)), k
    # a model quantized from other weights takes the bridged buffers whole
    other = llama.LlamaForCausalLM(llama.LlamaConfig(**TINY,
                                                     dtype=torch.float32))
    iq.quantize_model_(other, fmt, native_w8a8=True)
    other.load_state_dict(bridged, strict=True)
    eng = RaggedInferenceEngineV2(other, device="cpu", pipeline=False, **V2)
    _check_buffers(eng.module, fmt)
    outs = eng.generate_all(served["v2_prompts"], max_new_tokens=12)
    _, own = _v2(served, fmt, pipeline=False)
    for g, w in zip([outs[u] for u in sorted(outs)],
                    own if fmt == "w8a8" else served[f"v2_{fmt}"],
                    strict=True):
        np.testing.assert_array_equal(g, w)


def test_stacked_fp8_leaf_scale_on_every_layer():
    _, params = _flax_params(scan_layers=True)
    qtree, _, _ = jax_iq.quantize_param_tree(params, "fp8")
    leaf = qtree["model"]["layers"]["block"]["mlp"]["gate_proj"]["kernel"]
    values, scale = (np.asarray(a) for a in leaf.arrays)
    state = flax_to_state_dict(_np(qtree))
    for layer in range(TINY["num_hidden_layers"]):
        pre = f"model.layers.{layer}.mlp.gate_proj"
        assert state[f"{pre}.scale"].shape == ()
        assert state[f"{pre}.scale"].item() == float(scale)
        assert torch.equal(state[f"{pre}.values"].view(torch.uint8),
                           torch.from_numpy(values[layer].view(np.uint8)))
    # the port's fp8 modules (one scale a layer of their own) take it
    model = llama.LlamaForCausalLM(llama.LlamaConfig(**TINY,
                                                     dtype=torch.float32))
    iq.quantize_model_(model, "fp8")
    model.load_state_dict(state, strict=True)
    _check_buffers(model, "fp8")


def _stacked(leaf):
    return {"model": {"layers": {"block": {"mlp": {"gate_proj": {
        "kernel": leaf}}}}}}


def test_stacked_leaves_the_port_cannot_split_are_refused():
    # fp6 groups of 40 over a [2, 6, 10] leaf: a group spans both layers
    t = jax_iq.quantize_fp6(jnp.ones((2, 6, 10)), group_size=40)
    assert t.group_size == 40
    leaf = jax_iq.QuantizedWeight("fp6", (t.values, t.scale), t.shape,
                                  t.dtype, t.group_size)
    with pytest.raises(ValueError, match="span the layers"):
        flax_to_state_dict(_np(_stacked(leaf)))
    # groups of 20 split by layer: 3 groups each
    t = jax_iq.quantize_fp6(jnp.arange(120.0).reshape(2, 6, 10),
                            group_size=20)
    leaf = jax_iq.QuantizedWeight("fp6", (t.values, t.scale), t.shape,
                                  t.dtype, t.group_size)
    state = flax_to_state_dict(_np(_stacked(leaf)))
    for layer in (0, 1):
        pre = f"model.layers.{layer}.mlp.gate_proj"
        np.testing.assert_array_equal(
            state[f"{pre}.values"].numpy(),
            np.asarray(t.values)[3 * layer:3 * layer + 3])
    leaf = jax_iq.QuantizedWeight(
        "w8a8", (np.zeros((2, 256, 256), np.int8), np.ones(256, np.float32)),
        (2, 256, 256), jnp.float32)
    with pytest.raises(ValueError, match="2-D kernel"):
        flax_to_state_dict(_stacked(leaf))
