"""ZeRO stages 1-3 of the port across ranks (``runtime/zero.py``).

The ranks are processes spawned by ``torch_dist_workers.spawn`` and joined
over gloo; the pytest process never initialises a process group.  Inputs
come from numpy seeds: one flax init of a tiny fp32 Llama (hidden 256, 4
heads of 64, 2 layers), bridged, and 4 global batches of 8 x 16 tokens,
trained with fused AdamW (lr 1e-3, WarmupLR, clipping 1.0, 2 accumulation
steps).  What is held, and to what tolerance:

- the plan, with no ranks: the unit layout and its padding, which leaves
  stage 3 keeps whole (exactly the leaves the JAX ``ZeroShardingPlan``
  does not shard, at three thresholds), the hpZ slices, and the
  W -> W' re-slicing math;
- stages 0 (every rank holding it all, the gradient all-reduced), 1, 2
  and 3 at world 2 against the JAX engine at ``dp=2`` on the
  same weights and batches, with the tolerances of
  ``test_torch_training.py::test_engine_matches_jax_engine`` (fused AdamW
  case): losses rtol 1e-5; the weights' moves within 1e-2 x lr x steps
  everywhere, at most 5e-5 of them more than 1e-6 apart, their mean
  magnitude rtol 1e-3;
- stages 0-3 at world 2 (stage 3 with activation checkpointing on and
  off) and stage 3 with ``zero_hpz_partition_size=2`` at world 4 against
  the port's own stage 0 in one process, to the same tolerances; every
  rank returns the same loss;
- each rank's buffers hold exactly the plan's elements (1/W of the
  padded layout, the persistent unit, at most one gathered unit), and a
  step issues exactly the plan's collectives;
- ``tensor_fragment``'s full getters against the one-process engine's
  values (rtol 1e-4 and atol 1e-7 for moments and gradients: summation
  order only; weights as above), its local getter against the full one,
  and a set that reads back;
- a stage-3 checkpoint saved at world 2 resumes bit-identically at world
  2, and loads at world 1 (stage 0) and world 4 (stage 2), whose next two
  steps equal the uninterrupted run within the tolerances above.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import deepspeed_tpu
import deepspeed_tpu.comm as dist
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu.parallel.topology import MeshTopology as JaxTopology
from deepspeed_tpu.runtime.zero import ZeroShardingPlan
from deepspeed_tpu_torch.checkpoint import reshard
from deepspeed_tpu_torch.module_inject.flax_bridge import flax_to_state_dict
from deepspeed_tpu_torch.runtime.zero import ZeroPartitionPlan, gather_units
from deepspeed_tpu_torch.utils import tensor_fragment as tf
from torch_dist_workers import (TINY, make_engine, numpy_state, spawn,
                                tiny_model, zero_config, zero_worker)
import torch_cpu  # noqa: F401  (one torch thread a process)

LR = 1e-3
PARAM_TOL, FLIP_SHARE, FLIP_ATOL = 1e-2, 5e-5, 1e-6
STATE_RTOL, STATE_ATOL = 1e-4, 1e-7
CASES2 = [(0, 1, True), (1, 1, True), (2, 1, True), (3, 1, True),
          (3, 1, False)]
CASES4 = [(3, 2, True)]
UP = "lm.model.layers.1.mlp.up_proj.weight"


def _flax_params(scan_layers=True):
    jcfg = jax_llama.LlamaConfig(**TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32,
                                 scan_layers=scan_layers)
    model = jax_llama.LlamaLMLoss(jcfg)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((2, 16), jnp.int32))
    return model, jax.tree_util.tree_map(np.asarray, params)


@pytest.fixture(scope="module")
def setup():
    model, fparams = _flax_params()
    state = numpy_state(flax_to_state_dict(fparams))
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 256, size=(8, 16)) for _ in range(4)]
    return model, fparams, state, batches


@pytest.fixture(scope="module")
def baseline(setup):
    """The port at stage 0 in this process (no process group)."""
    _, _, state, batches = setup
    eng = make_engine(state, 0)
    losses = [float(eng.train_batch(batch=b)) for b in batches]
    frag = {key: tf.safe_get_full_optimizer_state(eng, UP, key).numpy()
            for key in ("exp_avg", "exp_avg_sq")}
    frag["param"] = tf.safe_get_full_fp32_param(eng, UP).numpy()
    frag["grad"] = tf.safe_get_full_grad(eng, UP).numpy()
    return {"losses": losses, "state": numpy_state(eng.module_state_dict()),
            "frag": frag}


@pytest.fixture(scope="module")
def world2(setup, tmp_path_factory):
    _, _, state, batches = setup
    work = str(tmp_path_factory.mktemp("world2"))
    ckpt = os.path.join(work, "ckpt")
    out = spawn(zero_worker, 2, work, state=state, batches=batches,
                cases=CASES2, ckpt_dir=ckpt, drawn=True)
    return out, ckpt


@pytest.fixture(scope="module")
def world4(setup, world2, tmp_path_factory):
    _, _, state, batches = setup
    work = str(tmp_path_factory.mktemp("world4"))
    return spawn(zero_worker, 4, work, state=state, batches=batches,
                 cases=CASES4, load_dir=world2[1])


def _assert_moves_match(got, want, p0, steps):
    """The weights' moves from ``p0`` agree as the JAX engine test has
    them agree."""
    names = list(p0)
    moved = {side: np.concatenate([(sd[n] - p0[n]).ravel() for n in names])
             for side, sd in (("got", got), ("want", want))}
    gap = np.abs(moved["got"] - moved["want"])
    assert gap.max() <= PARAM_TOL * LR * steps, gap.max()
    assert np.mean(gap > FLIP_ATOL) <= FLIP_SHARE, np.mean(gap > FLIP_ATOL)
    mean_moved = np.abs(moved["want"]).mean()
    assert mean_moved > 0.1 * LR
    np.testing.assert_allclose(np.abs(moved["got"]).mean(), mean_moved,
                               rtol=1e-3)


# ---------------------------------------------------------------------------
# The plan, no ranks
# ---------------------------------------------------------------------------

def _names_shapes():
    named = list(tiny_model().named_parameters())
    return [n for n, _ in named], [tuple(p.shape) for _, p in named]


@pytest.mark.parametrize("world", [1, 2, 4])
def test_unit_layout_and_padding(world):
    names, shapes = _names_shapes()
    assert [u for u, _ in gather_units(names)] == [
        "lm.model.embed_tokens", "lm.model.layers.0", "lm.model.layers.1",
        "lm.model.norm+lm.lm_head"]
    plans = [ZeroPartitionPlan(names, shapes, 2, world=world, rank=r)
             for r in range(world)]
    plan = plans[0]
    numels = [int(np.prod(s)) for s in shapes]
    assert [u.numel for u in plan.units] == [
        sum(numels[i] for i in idx) for _, idx in gather_units(names)]
    for u in plan.units:
        assert u.padded % (world * reshard.ALIGN) == 0
        assert 0 <= u.padded - u.numel < world * reshard.ALIGN
    assert plan.n_shard * world == plan.n_full
    # the ranks' pieces cover every leaf exactly once
    covered = {i: np.zeros(n, int) for i, n in enumerate(numels)}
    for p in plans:
        for i, lo, hi, pos in p.leaf_pieces():
            covered[i][lo:hi] += 1
            assert 0 <= pos and pos + hi - lo <= p.n_shard
    assert all((c == 1).all() for c in covered.values())


@pytest.mark.parametrize("threshold", [64, 1000, 100_000])
def test_stage3_keeps_the_leaves_jax_does_not_shard(threshold):
    jmodel, fparams = _flax_params(scan_layers=False)
    topo = JaxTopology(dp=2, devices=jax.devices()[:2])
    specs = ZeroShardingPlan(topo, 3, persistence_threshold=threshold
                             ).param_specs(fparams)
    sharded = jax.tree_util.tree_map(
        lambda p, s: np.full(p.shape, any(x is not None for x in s),
                             np.float32),
        fparams, specs, is_leaf=lambda x: isinstance(x, jax.sharding
                                                     .PartitionSpec))
    want = {k: bool(v.reshape(-1)[0])
            for k, v in flax_to_state_dict(sharded).items()}
    names, shapes = _names_shapes()
    plan = ZeroPartitionPlan(names, shapes, 3, world=2,
                             persistence_threshold=threshold)
    got = dict(zip(names, plan.partitioned))
    assert got == want
    assert any(got.values()) != (threshold == 100_000)
    pers = plan.persistent_unit
    assert sorted(pers.leaves if pers else []) == [
        i for i, n in enumerate(names) if not got[n]]


def test_hpz_slices_lie_in_their_working_copy_piece():
    names, shapes = _names_shapes()
    plans = [ZeroPartitionPlan(names, shapes, 3, world=4, rank=r, hpz=2,
                               persistence_threshold=1000)
             for r in range(4)]
    # rank (d, s) = d*2 + s owns slice s*2 + d; keeps piece s of 2
    assert [p.slice_index for p in plans] == [0, 2, 1, 3]
    assert [p.param_index for p in plans] == [0, 1, 0, 1]
    for p in plans:
        assert p.n_param * 2 == sum(u.padded for u in p.regular_units)
        for u in p.regular_units:
            start = p.slice_start(u)
            piece = u.offset + p.param_index * (u.padded // 2)
            assert piece <= start and start + u.chunk <= \
                piece + u.padded // 2
    # below stage 3 hpZ changes nothing, as in the reference
    assert ZeroPartitionPlan(names, shapes, 2, world=4, rank=1,
                             hpz=2).slice_index == 1


def test_reshard_math_round_trips():
    rng = np.random.default_rng(1)
    full = rng.standard_normal(1000).astype(np.float32)
    for world, new in ((2, 4), (4, 1), (3, 2)):
        parts = reshard.partition_padded(full, world)
        assert len(parts) == world and all(
            p.size == reshard.padded_partition_size(1000, world)
            for p in parts)
        again = reshard.reshard_padded_partitions(parts, 1000, new)
        np.testing.assert_array_equal(
            reshard.gather_padded_partitions(again, 1000), full)
    pieces = [(0, 300, full[:300]), (300, 1000, full[300:])]
    got, covered = reshard.assemble_flat(250, 400, pieces, np.float32)
    np.testing.assert_array_equal(got, full[250:400])
    assert covered.all()
    _, covered = reshard.assemble_flat(250, 400, pieces[:1], np.float32)
    assert covered.sum() == 50


# ---------------------------------------------------------------------------
# Across ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_stages_match_jax_engine_at_dp2(stage, setup, world2):
    model, fparams, state, batches = setup
    topo = dist.initialize_mesh(dp=2, devices=jax.devices()[:2])
    cfg = zero_config(stage)
    del cfg["comms_logger"]
    jeng, *_ = deepspeed_tpu.initialize(
        model=model, model_parameters=fparams, config=cfg, topology=topo,
        example_batch=jnp.asarray(batches[0][:4]))
    want = [float(jeng.train_batch(batch=b)) for b in batches]
    got = world2[0][0][(stage, 1, True)]
    np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
    jstate = numpy_state(flax_to_state_dict(jax.tree_util.tree_map(
        np.asarray, jax.device_get(jeng.state.params))))
    _assert_moves_match(got["state"], jstate, state, len(batches))


@pytest.mark.parametrize("world,case", [(2, c) for c in CASES2] +
                         [(4, c) for c in CASES4])
def test_stages_match_stage0(world, case, setup, baseline, world2, world4):
    out = world2[0] if world == 2 else world4
    got = out[0][case]
    for rank in range(world):
        assert out[rank][case]["losses"] == got["losses"]
    np.testing.assert_allclose(got["losses"], baseline["losses"], rtol=1e-5)
    _assert_moves_match(got["state"], baseline["state"], setup[2],
                        len(setup[3]))


@pytest.mark.parametrize("world,case", [(2, c) for c in CASES2] +
                         [(4, c) for c in CASES4])
def test_buffers_and_collectives_are_the_plans(world, case, world2, world4):
    out = world2[0] if world == 2 else world4
    for r in out:
        got = r[case]
        stage, hpz, _ = case
        n = got["numels"]
        if stage == 0:              # every rank holds it all
            assert n["master"] == n["grad_fp32"] == got["n_total"]
            assert got["init_fp32_most"] == got["n_total"]
            assert n["moments"] == 2 * got["n_total"]
            assert got["per_step"] == {"grad_all_reduce": 1,
                                       "step_stats": 1}
            assert got["backend"] == got["per_step"]
            assert got["local_ok"]
            continue
        assert got["n_shard"] * world == got["n_full"]
        assert 0 <= got["n_full"] - got["n_total"] < \
            len(got["units"]) * world * reshard.ALIGN
        assert n["master"] == got["n_shard"]
        assert n["moments"] == 2 * got["n_shard"]
        assert n["working_shard"] == 0               # fp32: the master
        big = max(p for _, p, _ in got["units"])
        # the weights reach the shards one unit at a time: at init no
        # fp32 tensor outgrew the shard, one unit or (hpZ) the working
        # copy's piece at stage 3 (stages 1-2 keep a whole working copy,
        # fp32 in this model, by design)
        assert got["init_fp32_most"] <= (
            max(got["n_shard"], big, got["n_param"] if hpz > 1 else 0)
            if stage == 3 else got["n_full"])
        if stage == 1:
            assert n["grad_fp32"] == got["n_full"] + got["n_shard"]
            assert n["working"] == n["grad"] == got["n_full"]
            assert n["scratch"] == 0
        else:
            assert n["grad_fp32"] == got["n_shard"]
            # a unit's fp32 gradient and its piece (under hpZ its
            # data_sub part too)
            assert n["scratch"] == big + big // world + (
                big // hpz if hpz > 1 else 0)
        if stage == 2:
            assert n["working"] == got["n_full"]
        if stage == 3:
            pers = sum(p for _, p, is_pers in got["units"] if is_pers)
            assert pers > 0
            assert n["working"] == pers + (got["n_param"] if hpz > 1 else 0)
            # gathered units: at most one at a time
            assert 0 < got["peak_live"] <= max(
                p for _, p, is_pers in got["units"] if not is_pers)
        assert got["per_step"] == got["want_per_step"]
        # every one of them through the process group, none a local copy
        assert got["backend"] == got["per_step"]
        assert got["local_ok"]


@pytest.mark.parametrize("case", CASES2)
def test_tensor_fragment_full_getters(case, baseline, world2):
    got = world2[0][0][case]["frag"]
    want = baseline["frag"]
    for key in ("exp_avg", "exp_avg_sq", "grad"):
        np.testing.assert_allclose(got[key], want[key], rtol=STATE_RTOL,
                                   atol=STATE_ATOL, err_msg=key)
    gap = np.abs(got["param"] - want["param"])
    assert gap.max() <= PARAM_TOL * LR * 4
    np.testing.assert_array_equal(got["param"],
                                  world2[0][0][case]["state"][UP])


@pytest.mark.parametrize("stage", [2, 3])
def test_tensor_fragment_set_reads_back(stage, setup):
    """One process (no process group): a set value reads back and reaches
    the working copy, as on a stage-0 engine given the same value."""
    _, _, state, batches = setup
    value = np.random.default_rng(3).standard_normal(
        state[UP].shape).astype(np.float32)
    losses = []
    for st in (0, stage):
        eng = make_engine(state, st)
        tf.safe_set_full_fp32_param(eng, UP, value)
        np.testing.assert_array_equal(
            tf.safe_get_full_fp32_param(eng, UP).numpy(), value)
        tf.safe_set_full_optimizer_state(eng, UP, value, "exp_avg")
        np.testing.assert_array_equal(
            tf.safe_get_full_optimizer_state(eng, UP, "mu").numpy(), value)
        losses.append(float(eng.eval_batch(batch=batches[0])))
    assert losses[0] == losses[1]


def test_checkpoint_resumes_bit_identically_at_world2(world2):
    for rank in world2[0]:
        r = rank["resume"]
        assert r["path"] == "global_step2" and r["client"] == {"k": 7}
        assert r["again"] == r["cont"]
        assert r["bit_identical"] and r["moments_identical"]


def test_checkpoint_loads_at_world1_stage0(setup, world2):
    _, _, state, batches = setup
    eng = make_engine(state, 0)
    path, client = eng.load_checkpoint(world2[1])
    assert client == {"k": 7} and eng.global_steps == 2
    again = [float(eng.train_batch(batch=b)) for b in batches[2:]]
    want = world2[0][0]["resume"]
    np.testing.assert_allclose(again, want["cont"], rtol=1e-5)
    _assert_moves_match(numpy_state(eng.module_state_dict()), want["state"],
                        state, len(batches))


def test_checkpoint_loads_at_world4_stage2(setup, world2, world4):
    want = world2[0][0]["resume"]
    for rank in world4:
        got = rank["loaded"]
        assert got["client"] == {"k": 7} and got["global_steps"] == 4
        np.testing.assert_allclose(got["again"], want["cont"], rtol=1e-5)
    _assert_moves_match(world4[0]["loaded"]["state"], want["state"],
                        setup[2], len(setup[3]))


def test_drawn_weights_reach_the_shards_one_module_at_a_time(world2):
    """A stage-3 engine at world 2 that draws a meta-device model's
    weights (``init_module_weights``, module by module) holds exactly
    what ``init_weights`` draws over the whole model from the same seed,
    and at init no fp32 tensor outgrew its shard or one unit."""
    model = tiny_model()
    model.to_empty(device="cpu")
    model.init_weights(torch.Generator().manual_seed(5))
    got = world2[0][0]["drawn"]
    assert got["state"].keys() == model.state_dict().keys()
    for name, value in model.state_dict().items():
        np.testing.assert_array_equal(got["state"][name], value.numpy(),
                                      err_msg=name)
    for rank in world2[0]:
        d = rank["drawn"]
        assert d["most"] <= max(d["n_shard"], d["big"])
        assert d["n_shard"] < sum(v.size for v in got["state"].values())


@pytest.mark.parametrize("fault", ["missing", "unexpected", "shape"])
def test_model_parameters_must_match_the_module(fault, setup):
    params = {k: torch.from_numpy(v) for k, v in setup[2].items()}
    if fault == "missing":
        del params[UP]
    elif fault == "unexpected":
        params["lm.extra"] = torch.ones(3)
    else:
        params[UP] = params[UP][:, :-1]
    with pytest.raises(ValueError, match=fault):
        import deepspeed_tpu_torch

        deepspeed_tpu_torch.initialize(model=tiny_model(),
                                       model_parameters=params,
                                       config=zero_config(3), device="cpu")


def test_stage3_needs_a_module():
    with pytest.raises(ValueError, match="nn.Module"):
        import deepspeed_tpu_torch

        deepspeed_tpu_torch.initialize(
            model=lambda p, b, g: p["w"].sum(),
            model_parameters={"w": torch.ones(4)},
            config={"train_batch_size": 1,
                    "zero_optimization": {"stage": 3}}, device="cpu")


@pytest.mark.parametrize("stage", [0, 1, 2, 3])
def test_a_deleted_engine_frees_its_state(stage, setup):
    """No reference cycle keeps an engine alive once its caller drops it
    (the gradient hooks of stages 2-3 hold the buffers weakly)."""
    import gc
    import weakref

    _, _, state, batches = setup
    eng = make_engine(state, stage)
    eng.train_batch(batch=batches[0])
    refs = [weakref.ref(eng), weakref.ref(eng.module),
            weakref.ref(eng.state.params)]
    del eng
    gc.collect()
    assert all(r() is None for r in refs)


def test_a_kept_module_frees_a_deleted_stage3_engine(setup):
    """The stage-3 module hooks are removed with their engine: a module
    kept after its engine is dropped keeps none of the engine's memory,
    and no hook."""
    import gc
    import weakref

    _, _, state, batches = setup
    eng = make_engine(state, 3)
    eng.train_batch(batch=batches[0])
    model = eng.module
    assert any(m._forward_pre_hooks for m in model.modules())
    refs = [weakref.ref(eng), weakref.ref(eng.zero),
            weakref.ref(eng.zero.p), weakref.ref(eng.zero.w_pers)]
    del eng
    gc.collect()
    assert all(r() is None for r in refs)
    assert not any(m._forward_pre_hooks or m._forward_hooks
                   for m in model.modules())


def test_a_module_reinitialised_at_stage3_trains_under_its_new_engine(
        setup):
    """A second ``initialize`` on the same module replaces the first
    engine's hooks: the new engine's step issues exactly its plan's
    collectives, and the first engine's units are never gathered again;
    weights whose storage stage 3 released are refused unless given."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch import comm

    _, _, state, batches = setup
    first = make_engine(state, 3)
    first.train_batch(batch=batches[0])
    model, before = first.module, first.zero.peak_live
    params = {k: torch.from_numpy(v) for k, v in state.items()}
    with pytest.raises(ValueError, match="has no storage"):
        deepspeed_tpu_torch.initialize(model=model, config=zero_config(3),
                                       device="cpu")
    second = deepspeed_tpu_torch.initialize(
        model=model, model_parameters=params, config=zero_config(3),
        device="cpu")[0]
    counts = comm.comms_logger.counts()
    loss = float(second.train_batch(batch=batches[0]))
    after = comm.comms_logger.counts()
    got = {k: after[k] - counts.get(k, 0) for k in after
           if after[k] != counts.get(k, 0)}
    assert got == second.plan.step_collectives(second.gas)
    assert first.zero.peak_live == before and first.zero.live == 0
    fresh = make_engine(state, 3)
    assert loss == float(fresh.train_batch(batch=batches[0]))


def test_resilience_checks_run_in_the_step():
    """At stage 2 in one process: the desync check runs at its interval
    (one rank agrees with itself); an fp16 overflow skips the step on the
    partitions too, and two in a row abort past
    ``max_consecutive_skips``."""
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.resilience.guards import GradientAnomalyError

    def loss_fn(params, batch, generator):
        return torch.sum(params["w"].float() * batch.float()) * 1e30

    def make(resilience):
        return deepspeed_tpu_torch.initialize(
            model=loss_fn, model_parameters={"w": torch.ones(8, 8)},
            device="cpu", config={
                "train_batch_size": 8, "zero_optimization": {"stage": 2},
                "fp16": {"enabled": True, "initial_scale_power": 4,
                         "hysteresis": 1},
                "optimizer": {"type": "AdamW", "params": {
                    "lr": 0.1, "fused": True}},
                "resilience": resilience})[0]

    eng = make({"comm": {"desync_interval": 1}})
    for _ in range(2):
        eng.train_batch(batch=np.ones((8, 8), np.float32) * 1e-40)
    assert eng._desync.checks == 2 and eng.skipped_steps == 0
    eng = make({"max_consecutive_skips": 2})
    before = eng.state.params.clone()
    eng.train_batch(batch=np.ones((8, 8), np.float32))
    assert torch.equal(eng.state.params, before) and eng.skipped_steps == 1
    with pytest.raises(GradientAnomalyError, match="2 consecutive"):
        eng.train_batch(batch=np.ones((8, 8), np.float32))


def test_dataloader_gives_each_rank_the_engines_rows():
    """Each rank's loader collates exactly the rows the engine cuts from
    the global batch for it, micro-batch by micro-batch."""
    from deepspeed_tpu_torch.runtime.dataloader import DeepSpeedDataLoader

    data = [np.full(3, i) for i in range(40)]
    whole = list(DeepSpeedDataLoader(data, batch_size=8, seed=5))
    world, micro, gas = 2, 2, 2
    for rank in range(world):
        mine = list(DeepSpeedDataLoader(data, batch_size=8, seed=5,
                                        world_size=world, rank=rank,
                                        micro_batch_size=micro))
        assert len(mine) == len(whole)
        for g, local in zip(whole, mine):
            want = np.concatenate([
                g[i * micro * world + rank * micro:
                  i * micro * world + (rank + 1) * micro]
                for i in range(gas)])
            np.testing.assert_array_equal(local, want)


def test_checkpoint_fault_sites(setup, tmp_path):
    """The write and read paths' fault sites (one process, stage 2): a
    transient error at a blob write or a record read is retried; a crash
    just before the commit leaves no committed tag, and the next save of
    the tag replaces the leftover staging directory."""
    from deepspeed_tpu_torch.resilience import faults

    _, _, state, batches = setup
    eng = make_engine(state, 2)
    eng.train_batch(batch=batches[0])
    with faults.FaultInjector().transient_oserror("ckpt.write_blob", 1) \
            as inj:
        eng.save_checkpoint(str(tmp_path), tag="a")
    assert inj.fired == [("ckpt.write_blob", "oserror", 1)]
    with faults.FaultInjector().crash("ckpt.commit"):
        with pytest.raises(faults.SimulatedCrash):
            eng.save_checkpoint(str(tmp_path), tag="b")
    assert not (tmp_path / "b").exists() and (tmp_path / "tmp.b").is_dir()
    assert open(tmp_path / "latest").read() == "a"
    eng.save_checkpoint(str(tmp_path), tag="b")
    assert not (tmp_path / "tmp.b").exists()
    fresh = make_engine(state, 2)
    with faults.FaultInjector().transient_oserror("ckpt.read_record", 2) \
            as inj:
        path, _ = fresh.load_checkpoint(str(tmp_path), tag="a")
    assert os.path.basename(path) == "a" and len(inj.fired) == 2
    assert torch.equal(fresh.state.params, eng.state.params)
