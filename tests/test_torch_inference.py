"""The port's v1 serving path against the JAX v1 engine.

A tiny fp32 Llama (head dim 64, GQA 2:1, scan-stacked flax params passed
through the weight bridge) serves through both packages'
``init_inference(...).generate`` on the same numpy prompts: greedy tokens
must be equal, token for token, and so must EOS padding.  The port's
cached decode is held against its own full forward (fp32, atol 1e-5), and
its sampling filters against the JAX filters on fixed logits (fp32,
atol 1e-6).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu_torch
from deepspeed_tpu.inference.sampling import (filter_logits_batched,
                                              sample_logits as jax_sample)
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.inference.kv_cache import init_cache
from deepspeed_tpu_torch.inference.sampling import (filter_logits,
                                                    sample_logits)
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
CONFIG = {"dtype": "float32", "max_out_tokens": 32}
NEW = 8


@pytest.fixture(scope="module")
def served():
    """Flax params, the bridged state_dict, prompts, and the JAX v1
    engine's greedy and EOS-padded outputs (computed once)."""
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32, remat=False)
    jmodel = jax_llama.LlamaForCausalLM(jcfg)
    prompts = np.random.default_rng(0).integers(0, 256, size=(2, 6),
                                                dtype=np.int32)
    params = jmodel.init(jax.random.PRNGKey(3), jnp.asarray(prompts))
    params = jax.tree_util.tree_map(np.asarray, params["params"])
    eng = deepspeed_tpu.init_inference(jmodel, config=dict(CONFIG),
                                       params=params)
    greedy = np.asarray(eng.generate(prompts, max_new_tokens=NEW))
    eos = int(greedy[0, 6 + 2])        # row 0 hits it at its third token
    padded = np.asarray(eng.generate(prompts, max_new_tokens=NEW,
                                     eos_token_id=eos))
    return dict(state=flax_to_state_dict(params), prompts=prompts,
                greedy=greedy, eos=eos, padded=padded,
                stage_keys=set(eng.serving_stages()))


def port_engine(state):
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(llama.LlamaConfig(**TINY))
    return deepspeed_tpu_torch.init_inference(model, config=dict(CONFIG),
                                              params=state, device="cpu")


def built_engine(state):
    """A model built with real weights and loaded by the caller: served
    with its own weights (no params= to init_inference)."""
    model = llama.LlamaForCausalLM(llama.LlamaConfig(**TINY))
    model.load_state_dict(state)
    return deepspeed_tpu_torch.init_inference(model, config=dict(CONFIG),
                                              device="cpu")


@pytest.mark.parametrize("make", [port_engine, built_engine],
                         ids=["meta_model", "built_model"])
def test_greedy_generate_matches_jax_engine(served, make):
    eng = make(served["state"])
    out = eng.generate(served["prompts"], max_new_tokens=NEW)
    assert out.shape == (2, 6 + NEW)
    np.testing.assert_array_equal(out.numpy(), served["greedy"])
    assert set(eng.serving_stages()) == served["stage_keys"]
    st = eng.serving_stages()
    assert st["dispatches"] == 1 and st["ticks"] == NEW
    assert st["blocking_gets"] == 1 and st["harvests"] == 1


def test_eos_padding_matches_jax_engine(served):
    eng = port_engine(served["state"])
    out = eng.generate(served["prompts"], max_new_tokens=NEW,
                       eos_token_id=served["eos"])
    np.testing.assert_array_equal(out.numpy(), served["padded"])
    assert (out[0, 6 + 2:] == served["eos"]).all()


def test_generate_async_defers_harvest(served):
    eng = port_engine(served["state"])
    pending = eng.generate_async(served["prompts"], max_new_tokens=NEW)
    assert pending.ready()                  # CPU work is synchronous
    assert eng.host_stats.blocking_gets == 0
    np.testing.assert_array_equal(pending.device_array().numpy(),
                                  served["greedy"])
    np.testing.assert_array_equal(pending.result().numpy(),
                                  served["greedy"])
    assert eng.host_stats.blocking_gets == 1
    assert pending.result() is pending.result()


def test_cached_decode_matches_full_forward(served):
    eng = port_engine(served["state"])
    model, cfg = eng.module, eng.module.config
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, size=(2, 12)))
    with torch.no_grad():
        full = model(ids)
        cache = init_cache(cfg.num_hidden_layers, 16, 2,
                           cfg.num_key_value_heads, cfg.head_dim,
                           torch.float32, torch.device("cpu"))
        P = 8
        out = model(ids[:, :P], positions=torch.arange(P), kv_cache=cache)
        torch.testing.assert_close(out, full[:, :P], atol=1e-5, rtol=0)
        for t in range(P, 12):
            out = model(ids[:, t:t + 1], positions=torch.tensor([t]),
                        kv_cache=cache)
            torch.testing.assert_close(out[:, 0], full[:, t], atol=1e-5,
                                       rtol=0)
    assert cache[0].index == 12


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (1.0, 10, 1.0), (0.7, 0, 0.8), (0.8, 50, 0.9), (1.3, 5, 0.5)])
def test_sampling_filters_match_jax(temperature, top_k, top_p):
    logits = np.random.default_rng(2).standard_normal((4, 256),
                                                      dtype=np.float32) * 3
    want = np.asarray(filter_logits_batched(
        jnp.asarray(logits), jnp.full((4,), temperature, jnp.float32),
        jnp.full((4,), top_k, jnp.int32), jnp.full((4,), top_p,
                                                   jnp.float32)))
    got = filter_logits(torch.from_numpy(logits), temperature, top_k,
                        top_p).numpy()
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    np.testing.assert_allclose(got[~np.isinf(got)], want[~np.isinf(want)],
                               atol=1e-6, rtol=0)
    # every token the JAX sampler draws is one the port's filter keeps
    keys = jax.random.split(jax.random.PRNGKey(0), 64)
    drawn = np.stack([np.asarray(jax_sample(
        jnp.asarray(logits), key, do_sample=True, temperature=temperature,
        top_k=top_k, top_p=top_p)) for key in keys[:8]])
    assert np.isfinite(got[np.arange(4)[None, :], drawn]).all()
    port = sample_logits(torch.from_numpy(logits),
                         torch.Generator().manual_seed(0), do_sample=True,
                         temperature=temperature, top_k=top_k, top_p=top_p)
    assert np.isfinite(got[np.arange(4), port.numpy()]).all()


def test_greedy_sampling_matches_jax():
    logits = np.random.default_rng(3).standard_normal((5, 100),
                                                      dtype=np.float32)
    want = np.asarray(jax_sample(jnp.asarray(logits), None))
    np.testing.assert_array_equal(
        sample_logits(torch.from_numpy(logits)).numpy(), want)


def test_top_k_one_sampling_equals_greedy(served):
    eng = port_engine(served["state"])
    out = eng.generate(served["prompts"], max_new_tokens=NEW, do_sample=True,
                       top_k=1, temperature=0.7,
                       generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(out.numpy(), served["greedy"])


def test_seeded_sampling_is_reproducible(served):
    eng = port_engine(served["state"])
    kw = dict(max_new_tokens=NEW, do_sample=True, temperature=0.8, top_k=50,
              top_p=0.9)
    a = eng.generate(served["prompts"],
                     generator=torch.Generator().manual_seed(7), **kw)
    b = eng.generate(served["prompts"],
                     generator=torch.Generator().manual_seed(7), **kw)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert ((a[:, 6:] >= 0) & (a[:, 6:] < 256)).all()


@pytest.mark.parametrize("config,match", [
    ({"tensor_parallel": {"tp_size": 2}}, "ROADMAP A7"),
    ({"quant": {"enabled": True}}, "ROADMAP A9")])
def test_unported_engine_options_raise(served, config, match):
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(llama.LlamaConfig(**TINY))
    with pytest.raises(NotImplementedError, match=match):
        deepspeed_tpu_torch.init_inference(model, config=config,
                                           device="cpu")


def test_generate_rejects_bad_requests(served):
    eng = port_engine(served["state"])
    with pytest.raises(ValueError, match="max_cache_len"):
        eng.generate(served["prompts"], max_new_tokens=40)
    with pytest.raises(ValueError, match="batch, prompt_len"):
        eng.generate(served["prompts"][0], max_new_tokens=2)
