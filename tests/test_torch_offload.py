"""The port's offload tiers (``runtime/swap_tensor.py``) in the engine,
against the resident engine and the JAX engine.

Weights come from one flax init (bridged), batches from numpy seeds.  What
is held, and to what tolerance:

- each tier (``cpu``; ``nvme``; ``cpu`` with ``offload_param`` at stage
  3) against the resident engine at stages 0-3 in one process, many
  buckets (``DSTPU_SWAP_BUCKET_MB``): losses, masters and moments
  bit-identical, one #4 launch a bucket a step; with ``fused: false``
  the plain update a bucket a step and never #4, bit-identical too;
- tier ``nvme`` at stage 2 against the JAX engine's real
  ``NvmeOptimizerSwapper``, and tier ``cpu`` at stage 3 with
  ``offload_param`` against the JAX engine there (which keeps that state
  on the device on the CPU backend), at ``tests/test_torch_training.py``'s
  tolerances: losses rtol 1e-5, the weights' moves within 1e-2 x lr x
  steps, at most 5e-5 of them over 1e-6;
- checkpoints cross tiers: resident, ``cpu`` and ``nvme`` each resume
  into each other bit-identically;
- the settings the JAX engine refuses or ignores, ``offload_states``,
  the swap stages under ``wall_clock_breakdown``, and ``buffer_numels``.
"""
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as dist
import deepspeed_tpu_torch
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from torch_dist_workers import whole_pieces
import torch_cpu  # noqa: F401  (one torch thread a process)

TINY = dict(vocab_size=256, hidden_size=256, intermediate_size=256,
            num_hidden_layers=2, num_attention_heads=4,
            num_key_value_heads=2, max_position_embeddings=64)
LR = 1e-3
STEPS = 3


@pytest.fixture(autouse=True)
def many_buckets(monkeypatch):
    monkeypatch.setenv("DSTPU_SWAP_BUCKET_MB", "1")


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32)
    model = jax_llama.LlamaLMLoss(jcfg)
    params = jax.tree_util.tree_map(np.asarray, model.init(
        jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32)))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, size=(4, 16)) for _ in range(STEPS)]
    return model, params, batches


def _config(stage=0, **zero):
    return {"train_batch_size": 4, "gradient_accumulation_steps": 2,
            "gradient_clipping": 1.0, "steps_per_print": 100,
            "optimizer": {"type": "AdamW", "params": {
                "lr": LR, "weight_decay": 0.1, "fused": True}},
            "scheduler": {"type": "WarmupLR", "params": {
                "warmup_min_lr": 0.0, "warmup_max_lr": LR,
                "warmup_num_steps": 5, "warmup_type": "linear"}},
            "zero_optimization": dict(
                stage=stage, stage3_param_persistence_threshold=1000,
                **zero)}


def _tier(tier, path, stage=0, **off):
    zero = {"offload_optimizer": dict(device=tier, nvme_path=str(path),
                                      **off)}
    if stage == 3 and tier == "cpu":
        zero["offload_param"] = {"device": "cpu"}
    return zero


def _engine(params, config):
    with torch.device("meta"):
        model = llama.LlamaLMLoss(llama.LlamaConfig(
            **TINY, dtype=torch.float32, param_dtype=torch.float32))
    return deepspeed_tpu_torch.initialize(
        model=model, model_parameters=flax_to_state_dict(params),
        config=config, device="cpu")[0]


def _state(eng):
    """Losses aside: every piece a checkpoint of ``eng`` holds."""
    return whole_pieces(eng)


def _train(eng, batches):
    return [float(eng.train_batch(batch=b)) for b in batches]


@pytest.fixture(scope="module")
def resident(setup):
    _, params, batches = setup
    out = {}
    for stage in range(4):
        eng = _engine(params, _config(stage))
        out[stage] = (_train(eng, batches), _state(eng))
    return out


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_tier_gives_the_resident_bits(setup, resident, stage, tier,
                                      tmp_path):
    _, params, batches = setup
    eng = _engine(params, _config(stage, **_tier(tier, tmp_path, stage)))
    assert eng.offload_tier == tier
    assert eng.offload_param == (stage == 3 and tier == "cpu")
    nb = len(eng.swapper.buckets)
    assert nb > 4
    losses = _train(eng, batches)
    assert eng.swapper.updates == STEPS * nb
    want_losses, want = resident[stage]
    assert losses == want_losses
    got = _state(eng)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    eng.swapper.close()


@pytest.mark.parametrize("tier", ["cpu", "nvme"])
def test_unfused_tier_runs_the_optimizers_update(setup, tier, tmp_path,
                                                 monkeypatch):
    """``fused: false``: each bucket runs the optimizer's own update, the
    plain ``adam_update_reference`` of the resident step, never kernel
    #4; losses, masters and moments equal the resident engine's."""
    from deepspeed_tpu_torch.ops import fused_adam as fa

    _, params, batches = setup
    calls = {"fused": 0, "plain": 0}
    plain = fa.adam_update_reference

    def count_plain(*a, **kw):
        calls["plain"] += 1
        return plain(*a, **kw)

    def refuse_fused(*a, **kw):
        calls["fused"] += 1
        raise AssertionError("kernel #4 with fused: false")

    monkeypatch.setattr(fa, "adam_update_reference", count_plain)
    monkeypatch.setattr(fa, "fused_adam", refuse_fused)

    def config(**zero):
        c = _config(2, **zero)
        c["optimizer"]["params"]["fused"] = False
        return c

    res = _engine(params, config())
    want_losses, want = _train(res, batches), _state(res)
    assert calls == {"fused": 0, "plain": STEPS}
    eng = _engine(params, config(**_tier(tier, tmp_path)))
    nb = len(eng.swapper.buckets)
    assert _train(eng, batches) == want_losses
    assert calls == {"fused": 0, "plain": STEPS + STEPS * nb}
    got = _state(eng)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    eng.swapper.close()


def _jax_engine(model, params, config, batches):
    topo = dist.initialize_mesh(dp=1, devices=jax.devices()[:1])
    eng, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=params, config=config, topology=topo,
        example_batch=jnp.asarray(batches[0][:2]))
    losses = [float(eng.train_batch(batch=b)) for b in batches]
    return eng, losses


def _assert_moves_match(got, want, p0, steps):
    names = list(p0)
    moved = {side: np.concatenate([(sd[n] - p0[n]).ravel() for n in names])
             for side, sd in (("got", got), ("want", want))}
    gap = np.abs(moved["got"] - moved["want"])
    assert gap.max() <= 1e-2 * LR * steps, gap.max()
    assert np.mean(gap > 1e-6) <= 5e-5, np.mean(gap > 1e-6)
    mean_moved = np.abs(moved["want"]).mean()
    assert mean_moved > 0.05 * LR          # 3 steps of a warm-up
    np.testing.assert_allclose(np.abs(moved["got"]).mean(), mean_moved,
                               rtol=1e-3)


@pytest.mark.parametrize("tier,stage", [("nvme", 2), ("cpu", 3)])
def test_tier_matches_jax_engine(setup, tier, stage, tmp_path):
    model, params, batches = setup
    config = _config(stage, **_tier(tier, tmp_path / "jax", stage))
    jeng, want = _jax_engine(model, params, config, batches)
    if tier == "nvme":
        assert jeng.nvme_swapper is not None
        assert jeng.nvme_swapper._bucket_ready
    eng = _engine(params, _config(stage, **_tier(tier, tmp_path / "port",
                                                   stage)))
    got = _train(eng, batches)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    p0 = {k: v.numpy() for k, v in flax_to_state_dict(params).items()}
    jp = {k: v.numpy() for k, v in flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray,
                               jax.device_get(jeng.state.params))).items()}
    port = {k: v.numpy() for k, v in eng.module_state_dict().items()}
    _assert_moves_match(port, jp, p0, len(batches))
    eng.swapper.close()
    if jeng.nvme_swapper is not None:
        jeng.nvme_swapper.close()


TIERS = ["resident", "cpu", "nvme"]


@pytest.mark.parametrize("dst", TIERS)
@pytest.mark.parametrize("src", TIERS)
def test_checkpoints_cross_tiers(setup, src, dst, tmp_path):
    _, params, batches = setup

    def make(tier, stage, where):
        zero = {} if tier == "resident" else _tier(tier, where, stage)
        return _engine(params, _config(stage, **zero))

    a = make(src, 2, tmp_path / "a")
    _train(a, batches[:1])
    a.save_checkpoint(str(tmp_path / "ckpt"), tag="t")
    cont = _train(a, batches[1:])
    want = _state(a)
    b = make(dst, 2, tmp_path / "b")
    path, _ = b.load_checkpoint(str(tmp_path / "ckpt"), tag="t")
    assert path is not None and b.global_steps == 1
    assert _train(b, batches[1:]) == cont
    got = _state(b)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    for eng in (a, b):
        if eng.swapper is not None:
            eng.swapper.close()


def test_settings_the_jax_engine_refuses_or_ignores(setup, tmp_path,
                                                    caplog):
    _, params, _ = setup
    lion = _config(2, **_tier("cpu", tmp_path))
    lion["optimizer"] = {"type": "Lion", "params": {"lr": 1e-4}}
    with pytest.raises(ValueError, match="Adam-family"):
        _engine(params, lion)
    with pytest.raises(ValueError, match="nvme_path"):
        _engine(params, _config(2, offload_optimizer={"device": "nvme"}))
    with pytest.raises(ValueError, match="offload_optimizer.device too"):
        _engine(params, _config(3, offload_param={"device": "cpu"}))
    from deepspeed_tpu_torch.utils.logging import logger as port_logger

    port_logger.addHandler(caplog.handler)
    try:
        with caplog.at_level(logging.WARNING):
            eng = _engine(params, _config(2, offload_param={"device": "cpu"},
                                          **_tier("cpu", tmp_path)))
    finally:
        port_logger.removeHandler(caplog.handler)
    assert "requires zero stage 3" in caplog.text
    assert eng.offload_tier == "cpu" and not eng.offload_param
    eng.swapper.close()


def test_breakdown_numels_and_offload_states(setup, tmp_path):
    _, params, batches = setup
    config = _config(2, **_tier("nvme", tmp_path))
    config.update(wall_clock_breakdown=True, steps_per_print=2)
    eng = _engine(params, config)
    _train(eng, batches)
    for name in ("swap_in_wait", "bucket_update", "swap_out_wait"):
        assert eng.timers.has_timer(name), name
    st = eng.swapper.stage_stats
    assert st["buckets"] == len(eng.swapper.buckets)
    assert st["bytes_written"] == 8 * eng.swapper.numel
    assert st["bytes_read"] == 8 * eng.swapper.numel
    numels = eng.buffer_numels()
    assert numels["master"] == numels["moments"] == 0
    assert numels["offloaded"] == 3 * eng.swapper.numel
    # the CPU has no host memory apart from the device: a no-op, as the
    # JAX engine's on its CPU backend; the next step trains on
    resident = _engine(params, _config(0))
    resident.offload_states()
    resident.reload_states()
    assert np.isfinite(_train(resident, batches[:1])[0])
    eng.swapper.close()
