"""The port's training path against the JAX package's.

Inputs and weights come from numpy seeds (weights from one flax init,
bridged).  What is held, and to what tolerance:

- schedules: every LR schedule's first 50 values, exactly (the same pure
  Python);
- precision: ``update_loss_scale`` over a scripted overflow sequence,
  exactly; the global norm and clipping, fp32 rtol 1e-6;
- optimizers: ``build_optimizer`` against the optax chain or fused
  transform of ``deepspeed_tpu`` over 10 steps of ``p - lr * u``, fp32
  rtol 1e-5 and atol 1e-6 (Adam's first steps are sign-like on small
  gradients: u is ~1 either way);
- configs: the training JSON configs parse to equal values;
- the engine: a tiny fp32 Llama (hidden 256, 4 heads of 64, 2 layers)
  trained 10 steps (gas 2, clipping 1.0, WarmupLR) by both engines from
  the same weights and batches, under fused AdamW, non-fused AdamW and
  fused Lion.  Losses agree to rtol 1e-5.  The final params' moves from
  the initial weights agree within 1e-6 on all but a few elements (at
  most 5e-5 of them for Adam, whose direction is ~sign(g) where |g| is
  small, and 1e-3 for Lion, whose direction is a sign: a flip on a
  near-zero momentum moves a weight by 2 lr), no element apart by more
  than 1e-2 x lr x steps (Adam) or lr x steps (Lion), and the mean move
  equal to rtol 1e-3;
- the fp16 dynamic-scale skip, the dataloader and its resume, a
  checkpoint round trip (exact), quarantine with fallback, keep-last-k,
  and the bridge back to the flax layout (the JAX loss of the port's
  trained weights equals the port's loss, rtol 1e-5).
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as dist
import deepspeed_tpu_torch
from deepspeed_tpu.config import load_config as jax_load_config
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.ops.fused_adam import (scale_by_fused_adam,
                                          scale_by_fused_lion)
from deepspeed_tpu.runtime import lr_schedules as jax_sched
from deepspeed_tpu.runtime import precision as jax_prec
from deepspeed_tpu.runtime.optimizers import build_optimizer as jax_build
from deepspeed_tpu_torch.checkpoint import engine as ckpt
from deepspeed_tpu_torch.config.config import load_config
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import (
    flax_to_state_dict, state_dict_to_flax)
from deepspeed_tpu_torch.ops.fused_adam import step_scalars
from deepspeed_tpu_torch.runtime import lr_schedules as sched
from deepspeed_tpu_torch.runtime import precision as prec
from deepspeed_tpu_torch.runtime.dataloader import (DeepSpeedDataLoader,
                                                    RepeatingLoader)
from deepspeed_tpu_torch.runtime.optimizers import build_optimizer
import torch_cpu  # noqa: F401  (one torch thread a process)

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)


# ---------------------------------------------------------------------------
# Schedules, precision, optimizers, configs
# ---------------------------------------------------------------------------

SCHEDULES = {
    "LRRangeTest": {"lr_range_test_min_lr": 1e-4,
                    "lr_range_test_step_size": 7,
                    "lr_range_test_staircase": True},
    "OneCycle": {"cycle_min_lr": 1e-5, "cycle_max_lr": 1e-3,
                 "cycle_first_step_size": 10, "decay_step_size": 5,
                 "decay_lr_rate": 0.1},
    "WarmupLR": {"warmup_min_lr": 0.0, "warmup_max_lr": 1e-3,
                 "warmup_num_steps": 20},
    "WarmupDecayLR": {"total_num_steps": 40, "warmup_num_steps": 10,
                      "warmup_type": "linear"},
    "WarmupCosineLR": {"total_num_steps": 45, "warmup_num_steps": 8},
}


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(name):
    mine = sched.LRScheduler(sched.get_schedule_fn(name, SCHEDULES[name],
                                                   base_lr=3e-4))
    ref = jax_sched.LRScheduler(jax_sched.get_schedule_fn(
        name, SCHEDULES[name], base_lr=3e-4))
    got, want = [], []
    for _ in range(50):
        got.append(mine.get_lr()[0])
        want.append(ref.get_lr()[0])
        mine.step()
        ref.step()
    assert got == want
    assert mine.state_dict() == ref.state_dict()


@pytest.mark.parametrize("fp16", [
    {"enabled": True, "initial_scale_power": 4, "hysteresis": 1,
     "loss_scale_window": 2},
    {"enabled": True, "initial_scale_power": 8, "hysteresis": 2,
     "loss_scale_window": 3, "consecutive_hysteresis": True,
     "min_loss_scale": 64.0},
])
def test_loss_scale_updates_match_jax(fp16):
    cfg, jcfg = (load_config({"fp16": fp16}).fp16,
                 jax_load_config({"fp16": fp16}).fp16)
    st, jst = prec.init_loss_scale(cfg), jax_prec.init_loss_scale(jcfg)
    kw = dict(dynamic=True, loss_scale_window=cfg.loss_scale_window,
              min_loss_scale=cfg.min_loss_scale,
              consecutive_hysteresis=cfg.consecutive_hysteresis,
              init_hysteresis=cfg.hysteresis)
    for ovf in [True, False, False, False, True, True, False, True, True,
                True, False, False, False, False]:
        st = prec.update_loss_scale(st, torch.tensor(ovf), **kw)
        jst = jax_prec.update_loss_scale(jst, jnp.asarray(ovf), **kw)
        assert (float(st.loss_scale), int(st.good_steps),
                int(st.hysteresis)) == (float(jst.loss_scale),
                                        int(jst.good_steps),
                                        int(jst.hysteresis))


def test_norm_clipping_and_overflow_match_jax():
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((7, 5), dtype=np.float32),
            "b": [rng.standard_normal(11, dtype=np.float32) * 3]}
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": [torch.from_numpy(tree["b"][0])]}
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    np.testing.assert_allclose(float(prec.global_norm(ttree)),
                               float(jax_prec.global_norm(jtree)), rtol=1e-6)
    got, norm = prec.clip_by_global_norm(ttree, 1.0)
    want, _ = jax_prec.clip_by_global_norm(jtree, 1.0)
    for a, b in zip(got, jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    assert not bool(prec.has_inf_or_nan(ttree))
    ttree["a"][0, 0] = float("nan")
    assert bool(prec.has_inf_or_nan(ttree))


OPTIMIZERS = {
    "adam": ("Adam", {"lr": 1e-2, "weight_decay": 0.1}),
    "adamw": ("AdamW", {"lr": 1e-2, "weight_decay": 0.1,
                        "betas": [0.8, 0.95]}),
    "fusedadam_l2": ("FusedAdam", {"lr": 1e-2, "weight_decay": 0.1,
                                   "adam_w_mode": False, "fused": True}),
    "adamw_fused": ("AdamW", {"lr": 1e-2, "weight_decay": 0.1,
                              "fused": True}),
    "lion": ("Lion", {"lr": 1e-3, "weight_decay": 0.1}),
    "lion_fused": ("Lion", {"lr": 1e-3, "weight_decay": 0.1,
                            "fused": True}),
    "sgd": ("SGD", {"lr": 1e-2}),
    "sgd_momentum": ("SGD", {"lr": 1e-2, "momentum": 0.9,
                             "weight_decay": 0.01}),
    "sgd_nesterov": ("SGD", {"lr": 1e-2, "momentum": 0.9,
                             "nesterov": True}),
}


@pytest.mark.parametrize("case", list(OPTIMIZERS))
def test_optimizers_match_jax_over_ten_steps(case):
    name, params = OPTIMIZERS[case]
    rng = np.random.default_rng(len(case))
    p0 = rng.standard_normal(333, dtype=np.float32)
    grads = [rng.standard_normal(333, dtype=np.float32) * 0.1
             for _ in range(10)]
    if params.get("fused"):
        # the fused transforms in the Pallas interpreter, as the JAX
        # package's own tests run them on the CPU
        b = params.get("betas", (0.9, 0.999) if "adam" in name.lower()
                       else (0.9, 0.99))
        if "adam" in name.lower():
            tx = scale_by_fused_adam(
                b1=b[0], b2=b[1], weight_decay=params["weight_decay"],
                adam_w_mode=params.get("adam_w_mode", True), interpret=True)
        else:
            tx = scale_by_fused_lion(b1=b[0], b2=b[1],
                                     weight_decay=params["weight_decay"],
                                     interpret=True)
        lr = params["lr"]
    else:
        tx, lr = jax_build(name, params)
    jp = jnp.asarray(p0)
    jstate = tx.init(jp)
    opt, lr2 = build_optimizer(name, params)
    assert lr2 == lr and opt.fused == bool(params.get("fused"))
    p = torch.from_numpy(p0.copy())
    state = opt.init(p)
    sc = step_scalars(p.device)
    sc[0], sc[3] = lr, 1.0
    for g in grads:
        u, jstate = tx.update(jnp.asarray(g), jstate, jp)
        jp = jp - lr * u
        opt.step(p, torch.from_numpy(g), state, sc)
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), rtol=1e-5,
                               atol=1e-6)
    assert int(state["count"]) == 10


@pytest.mark.parametrize("name,item", [
    ("Lamb", "A3"), ("Adagrad", "A3"), ("MuAdamW", "A3"),
    ("OneBitAdam", "A11"), ("ZeroOneAdam", "A11"), ("OneBitLamb", "A11")])
def test_unported_optimizers_raise(name, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        build_optimizer(name, {})


TRAIN_CONFIGS = [
    {"train_micro_batch_size_per_gpu": 4, "gradient_accumulation_steps": 2,
     "bf16": {"enabled": True}, "gradient_clipping": 1.0,
     "optimizer": {"type": "AdamW", "params": {"lr": 3e-4, "fused": True,
                                               "weight_decay": 0.1}},
     "scheduler": {"type": "WarmupLR", "params": {"warmup_num_steps": 3}}},
    {"train_batch_size": 32, "train_micro_batch_size_per_gpu": 8,
     "fp16": {"enabled": True, "loss_scale_window": 50, "hysteresis": 3},
     "optimizer": {"type": "Lion", "params": {"fused": True}},
     "resilience": {"keep_last_k": 2, "verify_on_load": False},
     "zero_optimization": {"stage": 0, "reduce_bucket_size": 1000}},
    {"train_batch_size": 8, "steps_per_print": 5,
     "wall_clock_breakdown": True, "activation_checkpointing": {
         "policy": "nothing_saveable"}, "checkpoint": {"async_save": False}},
]


@pytest.mark.parametrize("config", TRAIN_CONFIGS)
def test_training_configs_parse_like_jax(config):
    got = load_config(dict(config), dp_world_size=1)
    want = jax_load_config(dict(config), dp_world_size=1)
    assert got.model_dump() == want.model_dump()
    assert got.precision_dtype == want.precision_dtype


# ---------------------------------------------------------------------------
# The engine against the JAX engine
# ---------------------------------------------------------------------------

def _flax_params(seed=0):
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32)
    model = jax_llama.LlamaLMLoss(jcfg)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((2, 16),
                                                            jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_model(**kw):
    with torch.device("meta"):
        return llama.LlamaLMLoss(llama.LlamaConfig(
            **TINY, dtype=torch.float32, param_dtype=torch.float32, **kw))


def _engine_config(opt, params, **kw):
    lr = params["lr"]
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "gradient_clipping": 1.0, "steps_per_print": 100,
           "optimizer": {"type": opt, "params": params},
           "scheduler": {"type": "WarmupLR", "params": {
               "warmup_min_lr": 0.0, "warmup_max_lr": lr,
               "warmup_num_steps": 5, "warmup_type": "linear"}}}
    cfg.update(kw)
    return cfg


# name, params, the largest gap as a share of lr x steps, the share of
# elements allowed a gap over FLIP_ATOL.  Measured on the CPU: Adam 1.5e-5
# at most and 4.4e-6 of the elements over 1e-6; Lion 6.0e-4 at most and
# 1.0e-4 of the elements over 1e-6 (sign flips), the rest within 1e-7.
ENGINE_CASES = {
    "fused_adamw": ("AdamW", {"lr": 1e-3, "weight_decay": 0.1,
                              "fused": True}, 1e-2, 5e-5),
    "adamw": ("AdamW", {"lr": 1e-3, "weight_decay": 0.1}, 1e-2, 5e-5),
    "fused_lion": ("Lion", {"lr": 1e-4, "weight_decay": 0.1,
                            "fused": True}, 1.0, 1e-3),
}
FLIP_ATOL = 1e-6


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_jax_engine(case):
    opt, params, param_tol, flip_share = ENGINE_CASES[case]
    cfg = _engine_config(opt, params)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, size=(4, 16)) for _ in range(10)]
    jmodel, fparams = _flax_params()
    topo = dist.initialize_mesh(dp=1, devices=jax.devices()[:1])
    jeng, *_ = deepspeed_tpu.initialize(
        model=jmodel, model_parameters=fparams, config=cfg, topology=topo,
        example_batch=jnp.asarray(batches[0][:2]))
    want = [float(jeng.train_batch(batch=b)) for b in batches]
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_port_model(), model_parameters=flax_to_state_dict(fparams),
        config=cfg, device="cpu")
    got = [float(eng.train_batch(batch=b)) for b in batches]
    np.testing.assert_allclose(got, want, rtol=1e-5)
    p0 = flax_to_state_dict(fparams)
    jp = flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jeng.state.params)))
    names = list(eng.module_state_dict())
    moved = {side: np.concatenate([(sd[n].numpy() - p0[n].numpy()).ravel()
                                   for n in names])
             for side, sd in (("port", eng.module_state_dict()), ("jax", jp))}
    gap = np.abs(moved["port"] - moved["jax"])
    assert gap.max() <= param_tol * params["lr"] * len(batches), gap.max()
    assert np.mean(gap > FLIP_ATOL) <= flip_share, np.mean(gap > FLIP_ATOL)
    # both engines moved the weights, by the same amount on average
    mean_moved = np.abs(moved["jax"]).mean()
    assert mean_moved > 0.1 * params["lr"]
    np.testing.assert_allclose(np.abs(moved["port"]).mean(), mean_moved,
                               rtol=1e-3)
    assert eng.global_steps == 10 and eng.get_global_grad_norm() > 0


def test_fp16_overflow_skips_the_step():
    """The counterpart of the JAX engine's test: a loss that overflows
    once scaled leaves params and moments untouched, counts a skipped
    step and lowers the scale (``use_flash_attention=False``-style: a
    loss function, no flash kernel)."""
    def loss_fn(params, batch, generator):
        # fp32 like the JAX test's promotion: w (fp16) times an fp32 batch
        return torch.sum(params["w"].float() * batch.float()) * 1e30

    cfg = {"train_batch_size": 8,
           "fp16": {"enabled": True, "initial_scale_power": 4,
                    "hysteresis": 1},
           "optimizer": {"type": "AdamW", "params": {"lr": 0.1,
                                                     "fused": True}}}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=loss_fn, model_parameters={"w": torch.ones(8, 8)},
        config=cfg, device="cpu")
    before = eng.state.params.clone()
    scale = eng.loss_scale
    eng.train_batch(batch=np.ones((8, 8), np.float32) * 1e8)
    assert torch.equal(eng.state.params, before)
    assert eng.skipped_steps == 1 and eng.loss_scale < scale
    assert int(eng.state.opt_state["count"]) == 0
    assert torch.equal(eng.state.opt_state["m"],
                       torch.zeros_like(eng.state.opt_state["m"]))
    # a finite step then goes through
    eng.train_batch(batch=np.ones((8, 8), np.float32) * 1e-40)
    assert int(eng.state.opt_state["count"]) == 1


def test_fp16_model_trains_with_dynamic_scale():
    """fp16 compute through a model without the flash kernels (they take
    bf16 and fp32 only): the fp16 working copy follows the fp32 master."""
    with torch.device("meta"):
        model = llama.LlamaLMLoss(llama.LlamaConfig(
            **TINY, use_flash_attention=False))
    cfg = {"train_batch_size": 4, "fp16": {"enabled": True},
           "optimizer": {"type": "AdamW", "params": {"lr": 1e-3,
                                                     "fused": True}}}
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=cfg, device="cpu",
        generator=torch.Generator().manual_seed(0))
    batch = np.random.default_rng(1).integers(0, 256, size=(4, 16))
    losses = [float(eng.train_batch(batch=batch)) for _ in range(4)]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    w = eng.module.lm.lm_head.weight
    assert w.dtype == torch.float16
    torch.testing.assert_close(w.reshape(-1).float(),
                               eng.module_state_dict()[
                                   "lm.lm_head.weight"].reshape(-1),
                               atol=1e-3, rtol=1e-3)


def test_remat_gives_the_same_gradients():
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(0, 256, size=(2, 16)))
    _, fparams = _flax_params()
    grads = []
    for remat in (True, False):
        model = llama.LlamaLMLoss(llama.LlamaConfig(
            **TINY, dtype=torch.float32, remat=remat))
        model.load_state_dict(flax_to_state_dict(fparams))
        model(ids).backward()
        grads.append([p.grad for p in model.parameters()])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_dataloader_path_and_resume_replay(tmp_path):
    data = [np.full(8, i, dtype=np.int64) for i in range(20)]
    cfg = {"train_batch_size": 4, "optimizer": {
        "type": "SGD", "params": {"lr": 0.1}}, "steps_per_print": 100}
    seen = []

    def loss_fn(params, batch, generator):
        seen.append(batch[:, 0].tolist())
        return (params["w"] * batch.float().mean()).sum()

    def make():
        return deepspeed_tpu_torch.initialize(
            model=loss_fn, model_parameters={"w": torch.ones(3)},
            training_data=data, config=cfg, device="cpu")[0]

    eng = make()
    assert isinstance(eng.training_dataloader, RepeatingLoader)
    for _ in range(3):
        eng.train_batch()
    eng.save_checkpoint(str(tmp_path))
    for _ in range(4):          # crosses the epoch boundary (5 batches)
        eng.train_batch()
    tail = seen[3:]
    seen.clear()
    fresh = make()
    fresh.load_checkpoint(str(tmp_path))
    for _ in range(4):
        fresh.train_batch()
    assert seen == tail
    loader = DeepSpeedDataLoader(data, batch_size=4, seed=3)
    first = [b[:, 0].tolist() for b in loader]
    assert sorted(sum(first, [])) == list(range(20))


def _tiny_engine(seed=0, **cfg_kw):
    cfg = _engine_config("AdamW", {"lr": 1e-3, "fused": True,
                                   "weight_decay": 0.1}, **cfg_kw)
    return deepspeed_tpu_torch.initialize(
        model=_port_model(), config=cfg, device="cpu",
        generator=torch.Generator().manual_seed(seed))[0]


def test_checkpoint_round_trip_resumes_exactly(tmp_path):
    rng = np.random.default_rng(2)
    batches = [rng.integers(0, 256, size=(4, 16)) for _ in range(5)]
    eng = _tiny_engine()
    for b in batches[:3]:
        eng.train_batch(batch=b)
    path = eng.save_checkpoint(str(tmp_path), client_state={"k": 7})
    assert os.path.basename(path) == "global_step3"
    assert open(tmp_path / "latest").read() == "global_step3"
    cont = [float(eng.train_batch(batch=b)) for b in batches[3:]]
    fresh = _tiny_engine(seed=1)          # other weights, overwritten
    got_path, client = fresh.load_checkpoint(str(tmp_path))
    assert got_path == path and client == {"k": 7}
    assert fresh.global_steps == 3 and fresh.get_lr() == eng.lr_scheduler \
        .__class__(eng.lr_scheduler.schedule_fn, 2).get_lr()
    again = [float(fresh.train_batch(batch=b)) for b in batches[3:]]
    assert again == cont
    assert torch.equal(fresh.state.params, eng.state.params)
    for k, v in eng.state.opt_state.items():
        assert torch.equal(fresh.state.opt_state[k], v)
    # the working copy follows the loaded master
    assert torch.equal(fresh._flat_w, fresh.state.params)


def test_corrupt_tag_is_quarantined_with_fallback(tmp_path):
    eng = _tiny_engine()
    batch = np.random.default_rng(3).integers(0, 256, size=(4, 16))
    eng.train_batch(batch=batch)
    eng.save_checkpoint(str(tmp_path))
    good = eng.state.params.clone()
    eng.train_batch(batch=batch)
    eng.save_checkpoint(str(tmp_path))
    blob = tmp_path / "global_step2" / "shards_p0.bin"
    raw = bytearray(blob.read_bytes())
    raw[100] ^= 0xFF
    blob.write_bytes(bytes(raw))
    fresh = _tiny_engine(seed=1)
    path, _ = fresh.load_checkpoint(str(tmp_path))
    assert os.path.basename(path) == "global_step1"
    assert torch.equal(fresh.state.params, good)
    assert (tmp_path / "global_step2.corrupt").is_dir()
    assert open(tmp_path / "latest").read() == "global_step1"
    with pytest.raises(RuntimeError, match="verification"):
        eng.save_checkpoint(str(tmp_path), tag="bad")
        raw = bytearray((tmp_path / "bad" / "shards_p0.bin").read_bytes())
        raw[7] ^= 1
        (tmp_path / "bad" / "shards_p0.bin").write_bytes(bytes(raw))
        fresh.load_checkpoint(str(tmp_path), tag="bad")


def test_keep_last_k_collects_old_tags(tmp_path):
    eng = _tiny_engine(resilience={"keep_last_k": 2})
    batch = np.random.default_rng(4).integers(0, 256, size=(4, 16))
    for _ in range(4):
        eng.train_batch(batch=batch)
        eng.save_checkpoint(str(tmp_path))
    assert sorted(ckpt._committed_tags(str(tmp_path))) == [
        "global_step3", "global_step4"]
    with pytest.raises(NotImplementedError, match="A5"):
        eng.save_checkpoint(str(tmp_path), async_save=True)


@pytest.mark.parametrize("scan_layers", [True, False])
def test_bridge_back_gives_jax_the_ports_loss(scan_layers):
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32,
                                 scan_layers=scan_layers)
    jmodel = jax_llama.LlamaLMLoss(jcfg)
    eng = _tiny_engine()
    batch = np.random.default_rng(6).integers(0, 256, size=(4, 16))
    for _ in range(3):
        eng.train_batch(batch=batch)
    tree = state_dict_to_flax(eng.module_state_dict(),
                              scan_layers=scan_layers)
    want = float(eng.eval_batch(batch=batch))
    got = float(jmodel.apply({"params": tree}, jnp.asarray(batch)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    back = flax_to_state_dict({"params": tree})
    for k, v in eng.module_state_dict().items():
        assert torch.equal(back[k], v)


@pytest.mark.parametrize("config,item", [
    ({"pipeline": {"stages": 2}}, "A11"),
    ({"expert_parallel": {"size": 2}}, "A11"),
    ({"curriculum_learning": {"enabled": True}}, "A11"),
    ({"tensor_parallel": {"tp_size": 2}}, "A11"),
    ({"bf16": {"enabled": True, "master_weights": False}}, "A4"),
])
def test_unported_paths_raise(config, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP {item}"):
        deepspeed_tpu_torch.initialize(model=_port_model(), config=config,
                                       device="cpu")


@pytest.mark.parametrize("policy,remat", [("everything_saveable", False),
                                           ("nothing_saveable", True)])
def test_activation_checkpointing_policy_drives_remat(policy, remat):
    model = _port_model(remat=not remat)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=model, device="cpu",
        config={"train_batch_size": 2, "activation_checkpointing": {
            "policy": policy}})
    assert all(m.config.remat == remat for m in eng.module.modules()
               if hasattr(m, "config"))
    # the selective policy reaches the model (models/gpt2.py's remat)
    eng, *_ = deepspeed_tpu_torch.initialize(
        model=_port_model(), device="cpu",
        config={"train_batch_size": 2, "activation_checkpointing": {
            "policy": "dots_saveable"}})
    assert {(m.config.remat, m.config.remat_policy)
            for m in eng.module.modules() if hasattr(m, "config")} == {
        (True, "dots_saveable")}


def test_wall_clock_breakdown_times_the_step():
    eng = _tiny_engine(wall_clock_breakdown=True, steps_per_print=2)
    batch = np.random.default_rng(8).integers(0, 256, size=(4, 16))
    for _ in range(3):
        eng.train_batch(batch=batch)
    means = eng.timers.get_mean(["batch_prep", "step"])
    assert set(means) == {"batch_prep", "step"}
    assert means["step"] > 0 and means["batch_prep"] >= 0


def test_imperative_triple_and_dots_saveable_raise():
    eng = _tiny_engine()
    for fn in (eng.forward, eng.backward, eng.step):
        with pytest.raises(NotImplementedError, match="A4"):
            fn()
    # every JAX policy name is ported; a name JAX does not know raises
    assert llama.LlamaConfig(
        remat_policy="dots_saveable").remat_policy == "dots_saveable"
    with pytest.raises(ValueError, match="unknown remat policy"):
        llama.LlamaConfig(remat_policy="dots_everything")
