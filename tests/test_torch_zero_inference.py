"""NVMe weight streaming (``inference/zero_inference.py``) against the
port's resident v1 engine and the JAX ``NvmeWeightStreamingEngine``.

The JAX test's tiny fp32 Llama (3 layers), its weights from one flax init
bridged to a ``state_dict``, and seeded prompts.  Held: streamed greedy
tokens equal the port's v1 tokens and the JAX streaming engine's, token
for token; the weights on the card are at most the resident tree plus two
layer slots, and every layer has its file on disk; a meta model drawn
from a generator streams the weights v1 draws from it; EOS stops the
stream early; a model that is not a Llama is refused.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference.zero_inference import \
    NvmeWeightStreamingEngine as JaxStreamingEngine
from deepspeed_tpu.models.llama import LlamaForCausalLM as JaxLlama
from deepspeed_tpu.models.llama import get_config as jax_config
from deepspeed_tpu_torch.inference.engine import init_inference
from deepspeed_tpu_torch.inference.zero_inference import \
    NvmeWeightStreamingEngine
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
import torch_cpu  # noqa: F401  (one torch thread a process)

SHAPE = dict(vocab_size=64, hidden_size=32, intermediate_size=64,
             num_hidden_layers=3, num_attention_heads=4,
             num_key_value_heads=2, max_position_embeddings=64)


def _port_model():
    with torch.device("meta"):
        return llama.LlamaForCausalLM(llama.get_config(
            "tinyllama", **SHAPE, dtype=torch.float32,
            param_dtype=torch.float32))


@pytest.fixture(scope="module")
def setup():
    cfg = jax_config("tinyllama", **SHAPE, dtype=jnp.float32,
                     param_dtype=jnp.float32, scan_layers=True, remat=False,
                     use_flash_attention=False)
    params = jax.jit(JaxLlama(cfg).init)(jax.random.PRNGKey(3),
                                         np.zeros((1, 8), np.int32))
    prompts = np.random.default_rng(1).integers(1, 64, size=(2, 7))
    return cfg, params, prompts


def test_streamed_generate_matches_v1_and_jax(setup, tmp_path):
    cfg, params, prompts = setup
    jeng = JaxStreamingEngine(JaxLlama(cfg), params, str(tmp_path / "jax"),
                              max_batch_size=2, max_out_tokens=64)
    want_jax = np.asarray(jeng.generate(prompts, max_new_tokens=6))
    state = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, params))
    v1 = init_inference(_port_model(), params=state, dtype="float32",
                        max_out_tokens=64, device="cpu")
    want = v1.generate(prompts, max_new_tokens=6)
    eng = NvmeWeightStreamingEngine(_port_model(), state,
                                    str(tmp_path / "port"),
                                    max_batch_size=2, max_out_tokens=64,
                                    device="cpu")
    got = eng.generate(prompts, max_new_tokens=6)
    assert torch.equal(got, want)
    np.testing.assert_array_equal(got.numpy(), want_jax)
    # the resident tree and two layer slots on the card, nothing more
    tree = sum(v.numel() * 4 for k, v in state.items()
               if ".layers." not in k)
    layer = eng.store.layer_bytes
    assert eng.resident_bytes() <= tree + 2 * layer
    assert eng.resident_bytes() < sum(v.numel() * 4 for v in state.values())
    files = sorted((tmp_path / "port").glob("layer_*.bin"))
    assert len(files) == SHAPE["num_hidden_layers"]
    assert all(f.stat().st_size == layer for f in files)
    # one sweep of every layer a forward: the prefill and 5 decode steps
    assert eng.stats["sweeps"] == 6
    assert eng.stats["bytes_read"] == 6 * 3 * layer
    eng.close()


def test_drawn_meta_model_streams_v1s_weights(setup, tmp_path):
    _, _, prompts = setup
    v1 = init_inference(_port_model(), dtype="float32", max_out_tokens=64,
                        device="cpu",
                        generator=torch.Generator().manual_seed(5))
    want = v1.generate(prompts, max_new_tokens=5)
    model = _port_model()
    eng = NvmeWeightStreamingEngine(
        model, None, str(tmp_path / "w"), max_batch_size=2,
        max_out_tokens=64, device="cpu",
        generator=torch.Generator().manual_seed(5))
    assert all(p.is_meta for p in model.model.layers.parameters())
    assert torch.equal(eng.generate(prompts, max_new_tokens=5), want)
    # the layer slots' prefetch carries over from one generate to the next
    assert torch.equal(eng.generate(prompts, max_new_tokens=5), want)
    full = eng.generate(prompts[:1], max_new_tokens=8)
    eos = int(full[0, 9])
    got = eng.generate(prompts[:1], max_new_tokens=8, eos_token_id=eos)
    assert got.shape[1] <= full.shape[1] and int(got[0, -1]) == eos
    torch.testing.assert_close(got, full[:, :got.shape[1]], rtol=0, atol=0)
    eng.close()


def test_refuses_what_it_cannot_stream(tmp_path):
    from deepspeed_tpu_torch.models import gpt2

    with torch.device("meta"):
        model = gpt2.GPT2Model(gpt2.get_config("gpt2-125m"))
    with pytest.raises(TypeError, match="Llama family"):
        NvmeWeightStreamingEngine(model, None, str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="nvme_path"):
        NvmeWeightStreamingEngine(_port_model(), None, "", device="cpu")
