"""The port's GPT-2 against the flax GPT-2 and the JAX engines.

One tiny configuration (vocab 128, ``n_positions`` 64, ``n_embd`` 128, 2
layers, 2 heads: head dim 64, the smallest the flash kernels take, with
one KV head per query head) in fp32.  Weights come from one flax init
with a seed and cross through the weight bridge; token ids and batches
come from numpy.  What is held, and to what tolerance:

- logits against flax, atol 1e-4 (two layers of fp32 matmuls summed in
  another order; ``tests/test_torch_llama.py``'s limit), scan-stacked and
  unrolled trees, tied and untied heads, the plain attention and flash
  (the plain versions on both sides);
- v1 greedy tokens against the JAX v1 engine, token for token, eager and
  through the static-step path (``enable_cuda_graph`` on the CPU runs the
  captured step's buffers eagerly), with EOS padding and
  ``generate_async``; and served in bf16, plain and int8 weights;
- int8: ``quantize_model_`` on the bridged model against
  ``quantize_param_tree`` (the same 10 leaves, byte-identical payload,
  equal byte counts), the dequantizations per forward (each linear once,
  the tied table twice: its lookup and the head), tokens against the JAX
  int8 engine;
- training: the engine's losses against the JAX engine's over 3 steps,
  rtol 1e-5 (``test_torch_training.py``'s limit), at ZeRO 0 in one
  process (AdamW), and at ZeRO 2 and 3 at world 2 over gloo against the
  JAX engine at ``dp=2`` (FusedAdam), ``bench.py``'s names; the stage-2
  partitioned checkpoint resumes bit-identically;
- every remat policy name gives no-remat's loss and gradients exactly,
  and the dot policies keep what they name (no ``addmm`` recomputed);
- the bridge both ways, the presets, ``count_params`` and
  ``flops_per_token`` against the JAX functions, the unported knobs,
  the ``n_positions`` clamp, dropout held in distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import deepspeed_tpu
import deepspeed_tpu.comm as dist
from deepspeed_tpu.inference import quantization as jax_iq
from deepspeed_tpu.models import gpt2 as jax_gpt2
import deepspeed_tpu_torch
from deepspeed_tpu_torch.inference import quantization as iq
from deepspeed_tpu_torch.models import gpt2, llama
from deepspeed_tpu_torch.module_inject.flax_bridge import (
    flax_to_state_dict, state_dict_to_flax)
from torch_dist_workers import (GPT2_TINY, gpt2_zero_worker, spawn,
                                tiny_gpt2)
import torch_cpu  # noqa: F401  (one torch thread a process)

ATOL = 1e-4
V1 = {"dtype": "float32", "max_out_tokens": 32}
NEW = 8


def jax_config(**kw):
    kw = {"remat": False, **kw}
    return jax_gpt2.GPT2Config(**GPT2_TINY, dtype=jnp.float32,
                               param_dtype=jnp.float32, **kw)


def port_config(**kw):
    kw = {"remat": False, **kw}
    return gpt2.GPT2Config(**GPT2_TINY, dtype=torch.float32, **kw)


def flax_params(module, seed=0):
    params = module.init(jax.random.PRNGKey(seed),
                         jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree_util.tree_map(np.asarray, params)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------

CASES = {
    "scan_tied": dict(scan_layers=True),
    "unrolled_tied": dict(scan_layers=False),
    "scan_untied": dict(scan_layers=True, tie_word_embeddings=False),
    "unrolled_untied": dict(scan_layers=False, tie_word_embeddings=False),
    "flash": dict(use_flash_attention=True),
}


@pytest.mark.parametrize("case", list(CASES))
def test_bridged_logits_match_flax(case):
    kw = CASES[case]
    jmodel = jax_gpt2.GPT2Model(jax_config(**kw))
    params = flax_params(jmodel)
    assert ("h" in params) == kw.get("scan_layers", True)
    model = gpt2.GPT2Model(port_config(**kw))
    model.load_state_dict(flax_to_state_dict({"params": params}))
    ids = np.random.default_rng(1).integers(0, 128, size=(2, 12))
    want = jmodel.apply({"params": params}, jnp.asarray(ids, jnp.int32))
    with torch.no_grad():
        got = model(torch.from_numpy(ids))
    assert got.shape == (2, 12, 128)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("scan_layers", [True, False])
@pytest.mark.parametrize("tied", [True, False])
def test_bridge_round_trip(scan_layers, tied):
    params = flax_params(jax_gpt2.GPT2LMLoss(jax_config(
        scan_layers=scan_layers, tie_word_embeddings=tied)))
    sd = flax_to_state_dict(params)
    assert set(sd) == set(gpt2.GPT2LMLoss(port_config(
        tie_word_embeddings=tied)).state_dict())
    assert ("transformer.lm_head.weight" in sd) == (not tied)
    back = state_dict_to_flax(sd, scan_layers=scan_layers)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(params)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("tree", [
    {"transformer": {"wte": {"table": np.zeros((4, 4))}}},
    {"transformer": {"encoder": {"kernel": np.zeros((4, 4))}}},
    {"transformer": {"h_0": {"attn": {"qkv": {"kernel": np.zeros((4, 4))}}}}},
    # names of both families in one tree
    {"transformer": {"wte": {"embedding": np.zeros((4, 4))}},
     "model": {"embed_tokens": {"embedding": np.zeros((4, 4))}}},
])
def test_bridge_raises_on_unmapped_names(tree):
    with pytest.raises(KeyError):
        flax_to_state_dict(tree)


def test_presets_count_params_and_flops_match_jax():
    assert gpt2.PRESETS == jax_gpt2.PRESETS
    for preset in gpt2.PRESETS:
        jcfg, tcfg = jax_gpt2.get_config(preset), gpt2.get_config(preset)
        for f in ("vocab_size", "n_positions", "n_embd", "n_layer",
                  "n_head", "head_dim"):
            assert getattr(jcfg, f) == getattr(tcfg, f), (preset, f)
        for s in (None, 128, 1024):
            assert gpt2.flops_per_token(tcfg, s) == \
                jax_gpt2.flops_per_token(jcfg, s)
    params = flax_params(jax_gpt2.GPT2LMLoss(jax_config()))
    model = gpt2.GPT2LMLoss(port_config())
    assert gpt2.count_params(model) == jax_gpt2.count_params(params) == \
        gpt2.count_params(model.state_dict())
    with torch.device("meta"):
        big = gpt2.GPT2LMLoss(gpt2.get_config("gpt2-125m"))
    assert 124e6 < gpt2.count_params(big) < 125e6


@pytest.mark.parametrize("field,value,item", [
    ("tensor_parallel", True, "A7a"), ("pipeline_stages", 2, "A11")])
def test_unported_config_fields_raise(field, value, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        gpt2.GPT2Config(**{field: value})


def test_config_fields_and_defaults_match_flax():
    import dataclasses

    jf = {f.name: f.default for f in dataclasses.fields(jax_gpt2.GPT2Config)}
    tf = {f.name: f.default for f in dataclasses.fields(gpt2.GPT2Config)}
    assert list(jf) == list(tf)
    assert {k: v for k, v in jf.items() if k not in ("dtype", "param_dtype")
            } == {k: v for k, v in tf.items()
                  if k not in ("dtype", "param_dtype")}
    assert tf["use_flash_attention"] is False
    gpt2.GPT2Config(scan_layers=False, decode=True, max_cache_len=16)
    with pytest.raises(ValueError, match="unknown remat policy"):
        gpt2.GPT2Config(remat_policy="dots_everything")


def test_dropout_in_distribution():
    """The mask's keep rate and scaling against flax ``nn.Dropout``'s
    (threefry draws cannot be reproduced, so the two are held in
    distribution: keep rates within 0.005 of 0.9 over 10^6 draws)."""
    import flax.linen as nn

    x = np.ones((1000, 1000), np.float32)
    want = np.asarray(nn.Dropout(0.1).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(0)}))
    got = gpt2._dropout(torch.from_numpy(x), 0.1,
                        torch.Generator().manual_seed(0)).numpy()
    for out in (got, want):
        vals = np.unique(out)
        assert vals.size == 2 and vals[0] == 0.0
        assert abs(vals[1] - 1 / 0.9) < 1e-6
        assert abs((out > 0).mean() - 0.9) < 0.005
    model = gpt2.GPT2LMLoss(port_config(dropout=0.1))
    model.init_weights(torch.Generator().manual_seed(0))
    ids = torch.from_numpy(np.random.default_rng(2).integers(
        0, 128, size=(2, 16)))
    model.transformer.generator = torch.Generator().manual_seed(4)
    a = model(ids)
    model.transformer.generator = torch.Generator().manual_seed(4)
    assert torch.equal(model(ids), a)
    assert not torch.equal(model(ids), a)       # the generator advanced
    model.eval()
    with torch.no_grad():
        assert torch.equal(model(ids), model(ids))
    with pytest.raises(AssertionError, match="no attention-probability"):
        gpt2.GPT2LMLoss(port_config(dropout=0.1, use_flash_attention=True))(
            ids)


# ---------------------------------------------------------------------------
# Remat policies
# ---------------------------------------------------------------------------

class _CountOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.counts[func] = self.counts.get(func, 0) + 1
        return func(*args, **(kwargs or {}))


POLICIES = ["full", "dots", "dots_saveable", "checkpoint_dots",
            "nothing_saveable"]


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_remat_policies_give_no_remat_gradients(flash):
    params = flax_params(jax_gpt2.GPT2LMLoss(jax_config()))
    state = flax_to_state_dict(params)
    ids = torch.from_numpy(np.random.default_rng(5).integers(
        0, 128, size=(2, 16)))
    out = {}
    for policy in ["none"] + POLICIES:
        model = gpt2.GPT2LMLoss(port_config(
            remat=True, remat_policy=policy, use_flash_attention=flash))
        model.load_state_dict(state)
        loss = model(ids)
        with _CountOps() as ops:
            loss.backward()
        out[policy] = (loss, [p.grad for p in model.parameters()],
                       ops.counts)
    aten = torch.ops.aten
    for policy in POLICIES:
        loss, grads, counts = out[policy]
        assert torch.equal(loss, out["none"][0]), policy
        for a, b in zip(grads, out["none"][1]):
            assert torch.equal(a, b), policy
        # the forward's biased products run again only where not saved
        recomputed = counts.get(aten.addmm.default, 0)
        assert (recomputed > 0) == (policy in ("full", "nothing_saveable")), \
            (policy, recomputed)
    assert out["none"][2].get(aten.addmm.default, 0) == 0
    if not flash:
        # the attention's batched products: "dots" recomputes them,
        # "dots_saveable" keeps them
        bmm = {p: out[p][2].get(aten.bmm.default, 0) for p in POLICIES}
        assert bmm["dots"] > bmm["dots_saveable"] == \
            bmm["checkpoint_dots"] == out["none"][2][aten.bmm.default]


@pytest.mark.parametrize("policy", POLICIES)
def test_llama_takes_every_remat_policy(policy):
    tiny = dict(vocab_size=256, hidden_size=128, intermediate_size=128,
                num_hidden_layers=2, num_attention_heads=2,
                num_key_value_heads=1, max_position_embeddings=64)
    ids = torch.from_numpy(np.random.default_rng(6).integers(
        0, 256, size=(2, 16)))
    grads = []
    for remat in (False, True):
        torch.manual_seed(0)
        model = llama.LlamaLMLoss(llama.LlamaConfig(
            **tiny, dtype=torch.float32, remat=remat, remat_policy=policy))
        model(ids).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# v1 serving
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """Unrolled flax params of the tiny GPT-2 (flash on), the bridged
    state, and the JAX v1 engine's outputs: fp32 greedy, EOS-padded, int8
    greedy and logits, bf16 and bf16-int8 greedy, and the clamped cache
    length."""
    jcfg = jax_config(scan_layers=False, use_flash_attention=True)
    jmodel = jax_gpt2.GPT2Model(jcfg)
    params = flax_params(jmodel, seed=5)
    prompts = np.random.default_rng(0).integers(0, 128, size=(2, 6),
                                                dtype=np.int32)
    out = dict(params=params, state=flax_to_state_dict(params),
               prompts=prompts)
    eng = deepspeed_tpu.init_inference(jmodel, config=dict(V1),
                                       params=params)
    out["greedy"] = np.asarray(eng.generate(prompts, max_new_tokens=NEW))
    out["eos"] = int(out["greedy"][0, 6 + 2])
    out["padded"] = np.asarray(eng.generate(prompts, max_new_tokens=NEW,
                                            eos_token_id=out["eos"]))
    eng = deepspeed_tpu.init_inference(
        jmodel, config=dict(V1, quant={"enabled": True, "qtype": "int8"}),
        params=params)
    out["int8_logits"] = np.asarray(eng.forward(prompts))
    out["int8_greedy"] = np.asarray(eng.generate(prompts,
                                                 max_new_tokens=NEW))
    for name, quant in (("bf16", {}),
                        ("bf16_int8", {"quant": {"enabled": True,
                                                 "qtype": "int8"}})):
        eng = deepspeed_tpu.init_inference(
            jmodel, config=dict(V1, dtype="bfloat16", **quant),
            params=params)
        out[name] = np.asarray(eng.generate(prompts, max_new_tokens=NEW))
    eng = deepspeed_tpu.init_inference(
        jmodel, config=dict(V1, max_out_tokens=100), params=params)
    out["clamped"] = eng.max_cache_len
    return out


def port_engine(state, **config):
    with torch.device("meta"):
        model = gpt2.GPT2Model(port_config(use_flash_attention=True))
    return deepspeed_tpu_torch.init_inference(
        model, config={**V1, **config}, params=state, device="cpu")


@pytest.mark.parametrize("config", [{}, {"enable_cuda_graph": True}],
                         ids=["eager", "static_step"])
def test_greedy_generate_matches_jax_engine(served, config):
    eng = port_engine(served["state"], **config)
    out = eng.generate(served["prompts"], max_new_tokens=NEW)
    np.testing.assert_array_equal(out.numpy(), served["greedy"])
    out = eng.generate(served["prompts"], max_new_tokens=NEW,
                       eos_token_id=served["eos"])
    np.testing.assert_array_equal(out.numpy(), served["padded"])
    pending = eng.generate_async(served["prompts"], max_new_tokens=NEW)
    np.testing.assert_array_equal(pending.result().numpy(),
                                  served["greedy"])
    out = eng.generate(served["prompts"], max_new_tokens=NEW,
                       do_sample=True, top_k=1,
                       generator=torch.Generator().manual_seed(5))
    np.testing.assert_array_equal(out.numpy(), served["greedy"])


@pytest.mark.parametrize("weights", ["bf16", "bf16_int8"])
def test_bf16_greedy_matches_jax_engine(served, weights):
    """Serving in bf16 (int8 weights dequantized to bf16 too): the
    same tokens as the JAX v1 engine serving the same weights in bf16."""
    config = {"dtype": "bfloat16"}
    if weights == "bf16_int8":
        config["quant"] = {"enabled": True, "qtype": "int8"}
    eng = port_engine(served["state"], **config)
    out = eng.generate(served["prompts"], max_new_tokens=NEW)
    np.testing.assert_array_equal(out.numpy(), served[weights])


def test_n_positions_clamps_the_cache(served):
    eng = port_engine(served["state"], max_out_tokens=100)
    assert eng.max_cache_len == served["clamped"] == GPT2_TINY["n_positions"]
    P = served["prompts"].shape[1]
    out = eng.generate(served["prompts"], max_new_tokens=64 - P)
    assert out.shape == (2, 64)
    with pytest.raises(ValueError, match="max_cache_len"):
        eng.generate(served["prompts"], max_new_tokens=65 - P)


def test_int8_matches_quantize_param_tree_and_jax_engine(served,
                                                         monkeypatch):
    params = served["params"]
    qtree, jb0, jb1 = jax_iq.quantize_param_tree(params, "int8",
                                                 group_size=128)
    eng = port_engine(served["state"],
                      quant={"enabled": True, "qtype": "int8"})
    model = eng.module
    quantized = {n for n, m in model.named_modules()
                 if isinstance(m, (iq.QuantizedLinear,
                                   iq.QuantizedEmbedding))}
    assert len(quantized) == 4 * GPT2_TINY["n_layer"] + 2
    assert {"wte", "wpe"} <= quantized
    model2 = gpt2.GPT2Model(port_config())
    model2.load_state_dict(served["state"])
    assert iq.quantize_model_(model2, "int8", group_size=128) == (jb0, jb1)
    # the JAX payload across the bridge equals the port's, byte for byte
    bridged = flax_to_state_dict(jax.tree_util.tree_map(np.asarray, qtree))
    state = model.state_dict()
    buffers = [k for k in state if k.rsplit(".", 1)[1] in
               ("values", "scale", "offset")]
    assert len(buffers) == 3 * len(quantized)
    for k in buffers:
        assert torch.equal(state[k], bridged[k]), k
    # each quantized leaf dequantized once per forward, the tied table
    # twice (the lookup and the head)
    calls = []
    real = iq.dequantize
    monkeypatch.setattr(iq, "dequantize",
                        lambda qt: calls.append(qt.shape) or real(qt))
    logits = eng.forward(served["prompts"]).numpy()
    assert len(calls) == len(quantized) + 1
    # [128, 128]: the tied table twice and each layer's attention c_proj
    assert calls.count((128, 128)) == 2 + GPT2_TINY["n_layer"]
    np.testing.assert_allclose(logits, served["int8_logits"], atol=ATOL,
                               rtol=0)
    out = eng.generate(served["prompts"], max_new_tokens=NEW)
    np.testing.assert_array_equal(out.numpy(), served["int8_greedy"])


# ---------------------------------------------------------------------------
# Training
# ---------------------------------------------------------------------------

def _engine_config(stage, opt, lr=1e-3):
    return {"train_batch_size": 8, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "optimizer": {"type": opt, "params": {
                "lr": lr, "weight_decay": 0.1, "fused": True}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": lr,
                "warmup_num_steps": 5, "warmup_type": "linear"}},
            "zero_optimization": {"stage": stage,
                                  "stage3_param_persistence_threshold": 1000}}


# bench.py's optimizer names: AdamW at ZeRO 0 (config 1), FusedAdam at
# ZeRO 2 and 3 (config 2); fused kernels in both
OPTIMIZERS = {0: "AdamW", 2: "FusedAdam", 3: "FusedAdam"}


@pytest.fixture(scope="module")
def trained():
    """Flax GPT2LMLoss params (flash on), 3 batches, and the JAX engine's
    losses at dp=1, ZeRO 0 (AdamW), and at dp=2, ZeRO 2 (FusedAdam)."""
    jmodel = jax_gpt2.GPT2LMLoss(jax_config(use_flash_attention=True))
    params = flax_params(jmodel, seed=7)
    rng = np.random.default_rng(8)
    batches = [rng.integers(0, 128, size=(8, 16)) for _ in range(4)]
    out = dict(params=params, batches=batches)
    for stage, dp in ((0, 1), (2, 2)):
        topo = dist.initialize_mesh(dp=dp, devices=jax.devices()[:dp])
        jeng, *_ = deepspeed_tpu.initialize(
            model=jmodel, model_parameters={"params": params},
            config=_engine_config(stage, OPTIMIZERS[stage]), topology=topo,
            example_batch=jnp.asarray(batches[0][:4 // dp]))
        out[stage] = [float(jeng.train_batch(batch=b)) for b in batches[:3]]
    return out


def test_zero0_losses_match_jax_engine(trained):
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=tiny_gpt2(), model_parameters=flax_to_state_dict(
            trained["params"]), config=_engine_config(0, "AdamW"),
        device="cpu")
    got = [float(eng.train_batch(batch=b)) for b in trained["batches"][:3]]
    np.testing.assert_allclose(got, trained[0], rtol=1e-5)
    assert got[-1] < got[0]


def test_zero2_and_3_at_world2_match_jax_engine(trained, tmp_path):
    state = {k: v.numpy() for k, v in
             flax_to_state_dict(trained["params"]).items()}
    res = spawn(gpt2_zero_worker, 2, str(tmp_path), state=state,
                batches=trained["batches"][:3],
                configs={stage: _engine_config(stage, OPTIMIZERS[stage])
                         for stage in (2, 3)},
                ckpt_dir=str(tmp_path / "ckpt"))
    for stage in (2, 3):
        got = res[0][stage]
        assert res[1][stage]["losses"] == got["losses"]
        np.testing.assert_allclose(got["losses"], trained[2], rtol=1e-5)
        assert got["per_step"] == got["backend"] == got["want_per_step"]
    # the tied table and the position table share the first unit
    assert res[0][3]["units"][0] == "transformer.wte+transformer.wpe"
    for r in res:
        resume = r["resume"]
        assert resume["loaded"] and resume["bit_identical"]
        assert resume["again"] == resume["cont"]
