"""The port's Llama against the flax Llama, through the weight bridge.

One set of flax params (from ``model.init`` with a seed) goes through
``flax_to_state_dict`` into the port's model; token ids come from numpy.
Logits are compared in fp32 with atol 1e-4 (two layers of fp32 matmuls
summed in another order).  The config is tinyllama-sized but with a head
dim of 64, the smallest the flash kernel takes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
import torch_cpu  # noqa: F401  (one torch thread a process)

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
ATOL = 1e-4


def make_pair(seed=0, **kw):
    """(flax model, flax params as numpy, port model loaded through the
    bridge) for one config."""
    kw = {**TINY, **kw}
    jcfg = jax_llama.LlamaConfig(dtype=jnp.float32, param_dtype=jnp.float32,
                                 remat=False, **kw)
    tcfg = llama.LlamaConfig(dtype=torch.float32, param_dtype=torch.float32,
                             remat=False, **kw)
    jmodel = jax_llama.LlamaForCausalLM(jcfg)
    params = jmodel.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    params = jax.tree_util.tree_map(np.asarray, params)
    model = llama.LlamaForCausalLM(tcfg)
    model.load_state_dict(flax_to_state_dict({"params": params}))
    return jmodel, params, model


CASES = {
    "scan_stacked": dict(scan_layers=True),
    "unrolled": dict(scan_layers=False),
    "sliding_window": dict(sliding_window=5),
    "partial_rotary": dict(partial_rotary_factor=0.5),
    "biases": dict(attention_bias=True, attention_out_bias=True),
    "no_flash": dict(use_flash_attention=False),
    # D = 96 (the phi3-mini and gpt-neox-20b head dim): the CUDA kernels
    # do not take it, the CPU path takes the plain versions at any D
    "head_dim_96": dict(hidden_size=192, num_attention_heads=2,
                        num_key_value_heads=1),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bridged_logits_match_flax(case):
    jmodel, params, model = make_pair(**CASES[case])
    ids = np.random.default_rng(1).integers(0, 256, size=(2, 12))
    want = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("batched", [False, True])
def test_rotary_embedding_matches_flax(batched):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 3, 7, 16), dtype=np.float32)
    pos = (rng.integers(0, 50, size=(2, 7)) if batched
           else np.arange(3, 10))
    want = jax_llama.rotary_embedding(jnp.asarray(x), jnp.asarray(pos),
                                      10000.0)
    got = llama.rotary_embedding(torch.from_numpy(x), torch.from_numpy(pos),
                                 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_bridge_unstacks_scan_layers():
    _, params, _ = make_pair(scan_layers=True)
    sd = flax_to_state_dict(params)
    q = params["model"]["layers"]["block"]["self_attn"]["q_proj"]["kernel"]
    assert q.shape[0] == 2
    for i in range(2):
        np.testing.assert_array_equal(
            sd[f"model.layers.{i}.self_attn.q_proj.weight"].numpy(), q[i].T)
    assert set(sd) == set(llama.LlamaForCausalLM(
        llama.LlamaConfig(**TINY)).state_dict())


@pytest.mark.parametrize("tree", [
    {"model": {"embed_tokens": {"table": np.zeros((4, 4))}}},
    {"model": {"encoder": {"kernel": np.zeros((4, 4))}}},
    {"model": {"layers_0": {"self_attn": {"qkv_proj": {
        "kernel": np.zeros((4, 4))}}}}},
])
def test_bridge_raises_on_unmapped_names(tree):
    with pytest.raises(KeyError):
        flax_to_state_dict(tree)


@pytest.mark.parametrize("field,value", [
    ("sequence_parallel", "ring"), ("pipeline_stages", 2),
    ("ragged_decode", True), ("tensor_parallel", True)])
def test_unported_config_fields_raise(field, value):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        llama.LlamaConfig(**{field: value})


def test_weight_quant_w8a8_accepted():
    """``weight_quant="w8a8"`` (once refused here) marks a model whose
    Linears consume w8a8 weights natively: native w8a8 quantization sets
    it, and a forward with no such Linear is refused instead of serving
    float weights; ``LlamaForCausalLM`` carries the reference's
    ``w8a8_native`` flag; another value is refused."""
    from deepspeed_tpu_torch.inference import quantization as iq

    cfg = llama.LlamaConfig(**{**TINY, "num_hidden_layers": 1},
                            weight_quant="w8a8", dtype=torch.float32)
    assert llama.LlamaForCausalLM.w8a8_native
    torch.manual_seed(0)
    ids = torch.randint(0, TINY["vocab_size"], (1, 5))
    model = llama.LlamaForCausalLM(cfg)
    with pytest.raises(ValueError, match="w8a8"):
        model(ids)
    model = llama.LlamaForCausalLM(dataclasses.replace(cfg,
                                                       weight_quant="none"))
    iq.quantize_model_(model, "w8a8", native_w8a8=True)
    assert model.config.weight_quant == "w8a8"
    assert model(ids).shape == (1, 5, TINY["vocab_size"])
    with pytest.raises(ValueError, match="weight_quant"):
        llama.LlamaConfig(weight_quant="int4")


@pytest.mark.parametrize("kv_cache_dtype", ["none", "int8", "fp8",
                                            "fp8_e4m3"])
def test_paged_config_fields_are_accepted(kv_cache_dtype):
    cfg = llama.LlamaConfig(paged_decode=True, kv_num_pages=9,
                            kv_page_size=16, kv_cache_dtype=kv_cache_dtype)
    assert (cfg.paged_decode, cfg.kv_num_pages, cfg.kv_page_size,
            cfg.kv_cache_dtype) == (True, 9, 16, kv_cache_dtype)
    with pytest.raises(ValueError, match="kv_cache_dtype"):
        llama.LlamaConfig(paged_decode=True, kv_cache_dtype="fp16")


def test_presets_match_flax():
    assert set(llama.PRESETS) == set(jax_llama.PRESETS)
    for name in llama.PRESETS:
        assert llama.PRESETS[name] == jax_llama.PRESETS[name]
        assert (llama.get_config(name).head_dim ==
                jax_llama.get_config(name).head_dim)
