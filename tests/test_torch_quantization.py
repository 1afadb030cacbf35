"""The port's int8 weight-only serving against the JAX package's.

- The plain ``quantize``/``dequantize`` (what a CPU tensor runs) against
  the JAX functions' jnp branch, which the JAX engines run off the TPU:
  bit-exact payload, scale, offset and dequantized output, symmetric and
  asymmetric, 8 and 4 bits, groups of 128 and 2048 and a shape with a
  tail group and groups of 32, bf16, fp16 and fp32 inputs.  Under
  ``jax.jit`` the dequant is bit-exact too, except fp32 and fp16
  asymmetric, where XLA's CPU backend contracts ``v * s + o`` into one
  FMA (one rounding, not two): there it is held within 1 ulp.
- The same against the Pallas kernels in interpret mode, which are not
  bit-exact with their own jnp branch: scale within 1 ulp, payload within
  one step, dequant within one scale step.
- ``quantize_model_`` on a bridged tiny Llama against
  ``quantize_param_tree`` on the same flax tree: the same quantized leaves
  (``k_proj`` at 512 elements stays under ``min_size``), byte-identical
  buffers through the bridge, equal bytes before and after; also a
  scan-stacked tree whose layers are multiples of the group size.
- v1 (``quant.enabled``, groups of 128) fp32 forward logits within 1e-4
  of the JAX v1 engine's and greedy tokens equal to its; v2
  (``quantize_weights="int8"``, groups of 2048) greedy tokens equal to the
  JAX v2 engine's with ``pipeline=False``.
- fp8, fp6 and w8a8 build in both engines and refuse long context; the
  launch counters stay 0 on the CPU; a tensor off the CPU never takes
  the plain path.
"""
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
from deepspeed_tpu.ops import quantization as jax_q
from deepspeed_tpu_torch.inference import quantization as iq
from deepspeed_tpu_torch.inference.v2 import RaggedInferenceEngineV2
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from deepspeed_tpu_torch.ops import quantization as q
import torch_cpu  # noqa: F401  (one torch thread a process)

# (shape, group size): whole groups of 128 and 2048, a tail group, and
# groups of 32 (the kernel's lane split of two lanes a group)
CASES = {"gs128": ((48, 256), 128), "gs2048": ((32, 256), 2048),
         "tail": ((37, 53), 128), "gs32": ((40, 96), 32)}
_BITS = {torch.bfloat16: np.uint16, torch.float16: np.uint16,
         torch.float32: np.uint32}


def _inputs(shape, dtype, seed=0):
    """The same values as a JAX array and a torch tensor: rows of mixed
    magnitude, made in numpy fp32 and rounded to ``dtype`` by JAX."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) *
         rng.uniform(0.01, 3.0, size=(shape[0], 1))).astype(np.float32)
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    tx = torch.from_numpy(np.asarray(jx).view(_BITS[getattr(torch, dtype)])
                          .copy()).view(getattr(torch, dtype))
    return jx, tx


def _bits(a):
    """Raw bits of a float array or tensor, for bit-exact comparison."""
    if isinstance(a, torch.Tensor):
        return a.contiguous().view(
            torch.int16 if a.element_size() == 2 else torch.int32).numpy()
    a = np.asarray(a)
    return a.view(np.int16 if a.dtype.itemsize == 2 else np.int32)


def _jit_dequant(qt):
    fn = jax.jit(lambda v, s, o: jax_q.dequantize(
        jax_q.QuantizedTensor(v, s, o, qt.shape, qt.dtype)))
    return fn(qt.values, qt.scale, qt.offset)


@pytest.mark.parametrize("case", list(CASES))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
def test_plain_matches_jnp_branch_bit_exact(case, dtype, bits, symmetric):
    shape, gs = CASES[case]
    jx, tx = _inputs(shape, dtype)
    want = jax_q.quantize(jx, num_bits=bits, group_size=gs,
                          symmetric=symmetric)
    got = q.quantize(tx, num_bits=bits, group_size=gs, symmetric=symmetric)
    assert got.values.dtype == torch.int8 and got.shape == shape
    np.testing.assert_array_equal(got.values.numpy(), np.asarray(want.values))
    np.testing.assert_array_equal(_bits(got.scale), _bits(want.scale))
    np.testing.assert_array_equal(_bits(got.offset), _bits(want.offset))
    if case == "tail":      # the padding took part and was quantized
        assert got.values.numel() > tx.numel()
    x = q.dequantize(got)
    assert x.dtype == tx.dtype and x.shape == tx.shape
    np.testing.assert_array_equal(_bits(x), _bits(jax_q.dequantize(want)))
    jitted = _jit_dequant(want)
    if dtype != "bfloat16" and not symmetric:
        # one FMA under jit against a multiply then an add: 1 ulp of fp32,
        # which an fp16 output keeps now and then (bf16 rounds it away)
        ulps = np.abs(_bits(x).astype(np.int64) - _bits(jitted))
        assert ulps.max() <= 1
    else:
        np.testing.assert_array_equal(_bits(x), _bits(jitted))


@pytest.mark.parametrize("case", ["gs128", "tail"])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("symmetric", [True, False])
def test_plain_matches_interpret_kernels(case, bits, symmetric):
    shape, gs = CASES[case]
    jx, tx = _inputs(shape, "float32", seed=1)
    want = jax_q.quantize(jx, num_bits=bits, group_size=gs,
                          symmetric=symmetric, interpret=True)
    got = q.quantize(tx, num_bits=bits, group_size=gs, symmetric=symmetric)
    ulps = np.abs(_bits(got.scale).astype(np.int64) - _bits(want.scale))
    assert ulps.max() <= 1
    np.testing.assert_array_equal(_bits(got.offset), _bits(want.offset))
    steps = np.abs(got.values.numpy().astype(np.int32) -
                   np.asarray(want.values, np.int32))
    assert steps.max() <= 1
    x = q.dequantize(got).numpy()
    jx_back = np.asarray(jax_q.dequantize(want, interpret=True))
    step = np.repeat(got.scale.numpy()[:, 0], gs)[:x.size].reshape(shape)
    assert (np.abs(x - jx_back) <= step * (1 + 1e-6)).all()


def test_dequantize_into_out():
    _, tx = _inputs((37, 53), "bfloat16")
    qt = q.quantize(tx, group_size=128)
    out = torch.empty(37, 53, dtype=torch.bfloat16)
    assert q.dequantize(qt, out=out) is out
    np.testing.assert_array_equal(_bits(out), _bits(q.dequantize(qt)))
    with pytest.raises(ValueError, match="out must be"):
        q.dequantize(qt, out=torch.empty(53, 37, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="contiguous"):
        q.quantize(tx.t())


# --------------------------------------------------------------------------
# quantize_model_ against quantize_param_tree
# --------------------------------------------------------------------------

# the JAX serving-quant tests' tiny Llama: k_proj is 32 x 16 = 512
# elements, under min_size, while q_proj (1024) is quantized
SMALL = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=2, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=128)
# head dim 64: every leaf a multiple of 2048 elements
TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=256)


def _flax_params(dims, scan_layers=False, seed=3):
    cfg = jax_llama.LlamaConfig(**dims, dtype=jnp.float32,
                                param_dtype=jnp.float32, remat=False,
                                scan_layers=scan_layers,
                                use_flash_attention=False)
    params = jax_llama.LlamaForCausalLM(cfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return cfg, jax.tree_util.tree_map(np.asarray, params)


def _quantized_leaf_names(qtree):
    names = []

    def visit(path, leaf):
        if isinstance(leaf, jax_iq.QuantizedWeight):
            names.append("/".join(str(getattr(k, "key", k)) for k in path))
    jax.tree_util.tree_map_with_path(
        visit, qtree, is_leaf=lambda x: isinstance(x, jax_iq.QuantizedWeight))
    return names


def _port_model(dims, state, dtype):
    model = llama.LlamaForCausalLM(llama.LlamaConfig(**dims, dtype=dtype))
    model.load_state_dict(state)
    return model.to(dtype)


@pytest.mark.parametrize("dims,gs,scan", [
    (SMALL, 128, False), (SMALL, 2048, False), (TINY, 2048, True)],
    ids=["small_gs128", "small_gs2048", "tiny_stacked_gs2048"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_model_matches_quantize_param_tree(dims, gs, scan, dtype):
    _, params = _flax_params(dims, scan_layers=scan)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jdt), params)
    qtree, jb0, jb1 = jax_iq.quantize_param_tree(params, "int8",
                                                 group_size=gs)
    plain = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32),
                                   params)
    model = _port_model(dims, flax_to_state_dict(plain), getattr(torch, dtype))
    b0, b1 = iq.quantize_model_(model, "int8", group_size=gs)
    assert (b0, b1) == (jb0, jb1)
    # the same leaves, each flax kernel/embedding now a quantized module
    quantized = {n for n, m in model.named_modules()
                 if isinstance(m, (iq.QuantizedLinear,
                                   iq.QuantizedEmbedding))}
    names = _quantized_leaf_names(qtree)
    stacked = sum("/block/" in n for n in names)
    assert len(quantized) == len(names) + stacked * (
        dims["num_hidden_layers"] - 1)
    if dims is SMALL:
        assert not any("k_proj" in n for n in quantized)
        assert "model.layers.0.self_attn.q_proj" in quantized
        assert type(model.model.layers[0].self_attn.k_proj) is torch.nn.Linear
    # JAX's own payload, carried across the bridge, equals the port's
    bridged = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, qtree))
    state = model.state_dict()
    buffers = {k for k in state if k.rsplit(".", 1)[1] in
               ("values", "scale", "offset")}
    assert buffers == {k for k in bridged if k in buffers} and \
        len(buffers) == 3 * len(quantized)
    for k in buffers:
        np.testing.assert_array_equal(_bits(state[k]) if state[k].is_floating_point()
                                      else state[k].numpy(),
                                      _bits(bridged[k]) if bridged[k].is_floating_point()
                                      else bridged[k].numpy(), err_msg=k)
    model.load_state_dict(bridged, strict=True)
    for m in model.modules():
        if isinstance(m, iq.QuantizedLinear):
            assert m.values.dtype == torch.int8
            assert m.scale.dtype == m.offset.dtype == torch.float32


def test_stacked_groups_across_layers_refused():
    _, params = _flax_params(SMALL, scan_layers=True)
    qtree, _, _ = jax_iq.quantize_param_tree(params, "int8", group_size=3000)
    with pytest.raises(ValueError, match="span the layers"):
        flax_to_state_dict(jax.tree_util.tree_map(np.asarray, qtree))


# --------------------------------------------------------------------------
# The engines against the JAX engines
# --------------------------------------------------------------------------

QUANT = {"enabled": True, "qtype": "int8"}
V1 = {"dtype": "float32", "max_out_tokens": 32}
V2 = dict(max_seqs=4, max_seq_len=128, prefill_chunk=16, page_size=16,
          decode_block_size=8)


@pytest.fixture(scope="module")
def served():
    """Unrolled flax params of the tiny Llama, its bridged state, and the
    JAX engines' int8 outputs (v1 logits and greedy tokens, v2 greedy
    tokens)."""
    jcfg, params = _flax_params(TINY)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, 256, size=(2, 6), dtype=np.int32)
    v2_prompts = [rng.integers(1, 256, size=(s,), dtype=np.int32)
                  for s in (5, 9, 23, 40, 3, 17)]
    out = dict(state=flax_to_state_dict(params), prompts=prompts,
               v2_prompts=v2_prompts)
    for name, quant in (("plain", None), ("int8", QUANT)):
        cfg = dict(V1) if quant is None else dict(V1, quant=quant)
        eng = deepspeed_tpu.init_inference(
            jax_llama.LlamaForCausalLM(jcfg), config=cfg, params=params)
        out[f"logits_{name}"] = np.asarray(eng.forward(prompts))
        out[f"greedy_{name}"] = np.asarray(eng.generate(prompts,
                                                        max_new_tokens=8))
    eng = JaxEngine(jax_llama.LlamaForCausalLM(jcfg), params=params,
                    pipeline=False, quantize_weights="int8", **V2)
    outs = eng.generate_all(v2_prompts, max_new_tokens=12)
    out["v2"] = [outs[u] for u in sorted(outs)]
    return out


def _meta_model():
    with torch.device("meta"):
        return llama.LlamaForCausalLM(llama.LlamaConfig(
            **TINY, dtype=torch.float32))


def test_v1_int8_matches_jax_engine(served):
    eng = deepspeed_tpu_torch.init_inference(
        _meta_model(), config=dict(V1, quant=QUANT), params=served["state"],
        device="cpu")
    assert {type(m).__name__ for m in eng.module.modules()} >= {
        "QuantizedLinear", "QuantizedEmbedding"}
    assert eng.module.lm_head.group_size == 128
    logits = eng.forward(served["prompts"]).numpy()
    np.testing.assert_allclose(logits, served["logits_int8"], atol=1e-4,
                               rtol=0)
    # the quantization engaged: logits moved off the unquantized serve's
    ref = served["logits_plain"]
    rel = np.abs(logits - ref).max() / np.abs(ref).max()
    assert 1e-6 < rel < 0.06, rel
    out = eng.generate(served["prompts"], max_new_tokens=8)
    np.testing.assert_array_equal(out.numpy(), served["greedy_int8"])


def test_v2_int8_matches_jax_engine(served):
    eng = RaggedInferenceEngineV2(_meta_model(), params=served["state"],
                                  device="cpu", quantize_weights="int8",
                                  **V2)
    assert eng.module.model.embed_tokens.group_size == 2048
    outs = eng.generate_all(served["v2_prompts"], max_new_tokens=12)
    got = [outs[u] for u in sorted(outs)]
    assert len(got) == len(served["v2"])
    for g, w in zip(got, served["v2"]):
        np.testing.assert_array_equal(g, w)
    audit = eng.audit_kv_sharing()
    assert audit["free"] == audit["total"] == eng.num_pages - 1
    # a second engine over the already-quantized module keeps its fp32
    # scales (only parameters take the serving dtype) and its tokens
    again = RaggedInferenceEngineV2(eng.module, device="cpu", **V2)
    assert again.module.lm_head.scale.dtype == torch.float32
    outs = again.generate_all(served["v2_prompts"], max_new_tokens=12)
    for g, w in zip([outs[u] for u in sorted(outs)], served["v2"]):
        np.testing.assert_array_equal(g, w)


def test_launch_counters_stay_zero_on_cpu(served):
    before = (q.quantize.launches, q.dequantize.launches)
    eng = deepspeed_tpu_torch.init_inference(
        _meta_model(), config=dict(V1, quant=QUANT),
        generator=torch.Generator().manual_seed(0), device="cpu")
    eng.generate(served["prompts"], max_new_tokens=2)
    assert (q.quantize.launches, q.dequantize.launches) == before == (0, 0)


@pytest.mark.parametrize("fmt", ["fp8", "fp6", "w8a8"])
def test_unported_formats_raise(fmt):
    """The reference's other weight formats now build in both engines and
    in ``quantize_model_`` (their serving against the JAX engines is
    ``test_torch_weight_formats_serving.py``); what still refuses them is
    long-context partial residency, in both packages.  The name is kept
    from when all three raised, so the case stays the same test."""
    eng = deepspeed_tpu_torch.init_inference(
        _meta_model(), config=dict(V1, quant={"enabled": True,
                                              "qtype": fmt}),
        device="cpu")
    assert {m.fmt for m in eng.module.modules()
            if isinstance(m, iq._Quantized)} >= {fmt}
    eng = RaggedInferenceEngineV2(_meta_model(), device="cpu",
                                  quantize_weights=fmt, **V2)
    out = eng.generate_all([np.arange(1, 9, dtype=np.int32)],
                           max_new_tokens=2)
    assert len(next(iter(out.values()))) == 10
    seq = torch.nn.Sequential(torch.nn.Linear(64, 64))
    iq.quantize_model_(seq, fmt)
    assert isinstance(seq[0], iq.QuantizedLinear) and seq[0].fmt == fmt
    with pytest.raises(NotImplementedError, match="quantize_weights"):
        RaggedInferenceEngineV2(_meta_model(), device="cpu",
                                quantize_weights=fmt,
                                kv_tiering={"host_pages": 64,
                                            "long_context": True}, **V2)


def test_unknown_format_rejected():
    with pytest.raises(ValueError, match="expected one of"):
        RaggedInferenceEngineV2(_meta_model(), device="cpu",
                                quantize_weights="int3", **V2)


@pytest.mark.parametrize("wrapper", ["quantize", "dequantize"])
def test_wrappers_never_take_the_plain_path_off_the_cpu(wrapper,
                                                        monkeypatch):
    """A tensor that is not on the CPU (here the meta device, which needs
    no GPU) makes the wrapper launch its kernel or raise, never run the
    plain version."""
    def plain(*a, **k):
        raise AssertionError("took the plain path")

    monkeypatch.setattr(q, "quantize_reference", plain)
    monkeypatch.setattr(q, "dequantize_reference", plain)
    x = torch.empty(8, 256, device="meta")
    qt = q.QuantizedTensor(torch.empty(2, 1024, dtype=torch.int8,
                                       device="meta"),
                           torch.empty(2, 1, device="meta"),
                           torch.empty(2, 1, device="meta"), (8, 256),
                           torch.float32)
    with pytest.raises(ValueError, match="cuda or cpu"):
        q.quantize(x) if wrapper == "quantize" else q.dequantize(qt)
