"""The port's autotuning (``deepspeed_tpu_torch.autotuning``) against the
JAX package's, on the CPU.

- Copies of ``tests/unit/test_autotuning.py``'s suites against the port:
  the memory model, stage pruning, the doubling sweep with its plateau and
  failure stops, records, ``write_optimal_config``, the scheduler's
  quarantine and the grid, random and model-based tuners.
- ``instantiation_memory`` equal to the JAX Autotuner's for one
  ``ModelInfo`` at every stage, precision and chip count (exact).
- Each tuner's sequence of points equal to the JAX tuner's for one seed,
  with a failing point among them (exact).
- ``ModelInfo.from_model`` counts a meta-built module's parameters, the
  JAX count on the same config.
- A 2-point engine-backed run on a tiny Llama (``engine_runner``), and
  the subprocess runner once, in a fresh interpreter, beside a bad config
  quarantined without killing the tuner.
"""
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deepspeed_tpu import autotuning as jat
from deepspeed_tpu.models import llama as jax_llama
from deepspeed_tpu_torch.autotuning import (Autotuner, ExperimentScheduler,
                                            GridSearchTuner, ModelInfo,
                                            expand_space,
                                            make_subprocess_runner,
                                            tune_space)
from deepspeed_tpu_torch.autotuning.autotuner import engine_runner
import torch_autotune_factory as factory
import torch_cpu  # noqa: F401  (one torch thread a process)

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)


def make_tuner(runner, num_params=int(1e9), hbm=16e9, config=None,
               num_chips=8, cls=Autotuner):
    return cls(ModelInfo(num_params=num_params) if cls is Autotuner
               else jat.ModelInfo(num_params=num_params),
               config or {"optimizer": {"type": "AdamW",
                                        "params": {"lr": 1e-3}}},
               runner=runner, num_chips=num_chips, hbm_bytes=hbm)


class TestMemoryModel:
    def test_stage0_replicated(self):
        t = make_tuner(lambda c: 1.0, num_params=100, num_chips=4)
        assert t.instantiation_memory(0) == 100 * (4 + 4 + 8)

    def test_stages_shard_progressively(self):
        t = make_tuner(lambda c: 1.0, num_params=1000, num_chips=8)
        mems = [t.instantiation_memory(s) for s in (0, 1, 2, 3)]
        assert mems == sorted(mems, reverse=True)
        assert mems[3] == pytest.approx(1000 * (4 + 4 + 8) / 8)

    def test_low_precision_bytes(self):
        t = make_tuner(lambda c: 1.0, num_params=100,
                       config={"bf16": {"enabled": True}})
        assert t.instantiation_memory(0) == 100 * (2 + 2 + 12)

    def test_pruning_drops_oom_stages(self):
        t = make_tuner(lambda c: 1.0, num_params=int(1e9), hbm=4e9,
                       num_chips=8)
        stages = t._candidate_stages()
        assert 0 not in stages
        assert 3 in stages

    @pytest.mark.parametrize("chips", [1, 4, 8])
    @pytest.mark.parametrize("config", [{}, {"bf16": {"enabled": True}},
                                        {"fp16": {"enabled": True}}],
                             ids=["fp32", "bf16", "fp16"])
    def test_equals_jax_memory_model(self, chips, config):
        n = 124_439_808                     # gpt2-125m, tied head once
        port = make_tuner(lambda c: 1.0, num_params=n, num_chips=chips,
                          config=dict(config), hbm=80e9)
        ref = make_tuner(lambda c: 1.0, num_params=n, num_chips=chips,
                         config=dict(config), hbm=80e9, cls=jat.Autotuner)
        for stage in (0, 1, 2, 3):
            assert port.instantiation_memory(stage) == \
                ref.instantiation_memory(stage)
            assert port.memory_fits(stage) == ref.memory_fits(stage)
        assert port._candidate_stages() == ref._candidate_stages()


class TestSearch:
    def test_doubling_sweep_until_oom(self):
        calls = []

        def runner(cfg):
            mbs = cfg["train_micro_batch_size_per_gpu"]
            calls.append((cfg["zero_optimization"]["stage"], mbs))
            if mbs > 8:
                raise MemoryError("oom")
            return float(mbs * 10)

        t = make_tuner(runner, num_params=1000)
        best_cfg, best_val = t.tune()
        assert best_cfg["train_micro_batch_size_per_gpu"] == 8
        assert best_val == 80.0
        swept = [m for s, m in calls if s == calls[0][0]]
        assert swept == [1, 2, 4, 8, 16]

    def test_plateau_early_stop(self):
        t = make_tuner(lambda cfg: 100.0, num_params=1000)
        t.tune()
        assert len(t.records) == 2

    def test_no_success_returns_none(self):
        t = make_tuner(lambda c: (_ for _ in ()).throw(RuntimeError("x")),
                       num_params=1000)
        cfg, val = t.tune()
        assert cfg is None and val is None
        assert all(r["throughput"] is None for r in t.records)
        # the memory model's estimate stands beside every record
        assert all(r["estimate_bytes"] == t.instantiation_memory(
            r["zero_stage"]) for r in t.records)

    def test_fast_false_sweeps_all_stages(self):
        t = make_tuner(lambda c: 1.0, num_params=1000,
                       config={"autotuning": {"fast": False,
                                              "zero_stages": [0, 2]}})
        t.tune()
        assert {r["zero_stage"] for r in t.records} == {0, 2}

    def test_user_stage_respected(self):
        t = make_tuner(lambda c: 1.0, num_params=1000,
                       config={"zero_optimization": {"stage": 2}})
        t.tune()
        assert {r["zero_stage"] for r in t.records} == {2}

    def test_write_optimal_config(self, tmp_path):
        t = make_tuner(lambda c: 1.0, num_params=1000)
        with pytest.raises(RuntimeError, match="tune"):
            t.write_optimal_config(str(tmp_path / "x.json"))
        t.tune()
        path = str(tmp_path / "best" / "ds_config.json")
        t.write_optimal_config(path)
        with open(path) as f:
            assert "zero_optimization" in json.load(f)

    def test_sweeps_equal_jax(self):
        """The same runner through both Autotuners: the same records'
        points and values, the same best."""
        def runner(cfg):
            s = cfg["zero_optimization"]["stage"]
            mbs = cfg["train_micro_batch_size_per_gpu"]
            if mbs > 8 and s == 1:
                raise MemoryError("oom")
            return float(mbs * (10 - s))

        conf = {"autotuning": {"fast": False, "zero_stages": [0, 1, 2],
                               "min_train_micro_batch_size_per_gpu": 2,
                               "max_train_micro_batch_size_per_gpu": 32}}
        got = make_tuner(runner, num_params=1000, config=conf)
        ref = make_tuner(runner, num_params=1000, config=conf,
                         cls=jat.Autotuner)
        assert got.tune() == ref.tune()
        assert [(r["zero_stage"], r["micro_batch_size"], r["throughput"])
                for r in got.records] == [
            (r["zero_stage"], r["micro_batch_size"], r["throughput"])
            for r in ref.records]


def test_model_info_counts_meta_params():
    """Counted on the meta device (no weights allocated), equal to the
    JAX count of the same Llama config's flax params."""
    model = factory.tiny_model()
    info = ModelInfo.from_model(model)
    assert all(p.is_meta for p in model.parameters())
    jcfg = jax_llama.LlamaConfig(**factory.TINY, dtype=jnp.float32,
                                 param_dtype=jnp.float32, remat=False,
                                 use_flash_attention=False)
    ref = jat.ModelInfo.from_model(jax_llama.LlamaLMLoss(jcfg),
                                   np.zeros((1, 8), np.int32))
    assert info.num_params == ref.num_params > 10000


# -- the scheduler and tuners -------------------------------------------------

BASE = {"train_micro_batch_size_per_gpu": 1,
        "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}}}
SPACE = {"zero_optimization.stage": [0, 1, 2, 3],
         "train_micro_batch_size_per_gpu": [1, 2, 4, 8]}


def _synthetic_runner(cfg):
    """Known optimum (stage 2, mbs 4); stage 3 + mbs 8 'OOMs'."""
    pt = cfg["_tuning_point"]
    stage = pt["zero_optimization.stage"]
    mbs = pt["train_micro_batch_size_per_gpu"]
    if stage == 3 and mbs == 8:
        raise MemoryError("synthetic OOM")
    return 100.0 - (stage - 2) ** 2 * 10 - (mbs - 4) ** 2


class TestOrchestration:
    def test_expand_space(self):
        cfgs = expand_space(BASE, SPACE)
        assert len(cfgs) == 16
        assert all("_tuning_point" in c for c in cfgs)
        assert cfgs[0]["zero_optimization"]["stage"] == 0
        assert cfgs == jat.expand_space(BASE, SPACE)

    def test_grid_finds_optimum_and_quarantines(self):
        best = tune_space(BASE, SPACE, _synthetic_runner, tuner="gridsearch")
        assert best.metric_val == 100.0
        assert best.ds_config["_tuning_point"] == {
            "zero_optimization.stage": 2,
            "train_micro_batch_size_per_gpu": 4}

    def test_quarantine_records_error(self):
        sched = ExperimentScheduler(_synthetic_runner)
        exps = sched.run_experiments(expand_space(BASE, SPACE))
        bad = [e for e in exps if not e.ok]
        assert len(bad) == 1
        assert "MemoryError" in bad[0].error
        assert len([e for e in exps if e.ok]) == 15

    def test_random_tuner_covers_space(self):
        best = tune_space(BASE, SPACE, _synthetic_runner, tuner="random",
                          n_trials=16)
        assert best.metric_val == 100.0

    def test_model_based_tuner_beats_budgeted_random(self):
        best = tune_space(BASE, SPACE, _synthetic_runner,
                          tuner="model_based", n_trials=10, seed=0)
        assert best is not None and best.metric_val >= 97.0

    def test_early_stopping(self):
        sched = ExperimentScheduler(_synthetic_runner)
        t = GridSearchTuner(expand_space(BASE, SPACE), sched)
        t.tune(early_stopping=3)
        assert len(sched.finished) < 16

    @pytest.mark.parametrize("tuner", ["gridsearch", "random",
                                       "model_based"])
    @pytest.mark.parametrize("seed", [0, 5])
    def test_points_equal_jax(self, tuner, seed):
        """Each tuner visits the JAX tuner's points in the JAX order for
        one seed (the failing point included), and picks its best."""
        seen = {"port": [], "jax": []}

        def runner(key):
            def run(cfg):
                seen[key].append(tuple(sorted(cfg["_tuning_point"].items())))
                return _synthetic_runner(cfg)
            return run

        got = tune_space(BASE, SPACE, runner("port"), tuner=tuner,
                         n_trials=12, seed=seed, sample_size=2)
        ref = jat.tune_space(BASE, SPACE, runner("jax"), tuner=tuner,
                             n_trials=12, seed=seed, sample_size=2)
        assert seen["port"] == seen["jax"] and len(seen["port"]) == 12
        assert got.record == {**ref.record, "seconds": got.record["seconds"]}


# -- engine-backed runs -------------------------------------------------------

def test_engine_runner_two_points():
    """Two points of a real stage-0 sweep on a tiny Llama on the CPU, each
    on a fresh engine, the winner the larger micro batch's config when it
    is faster; the records hold the memory model's estimate."""
    conf = {"optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "steps_per_print": 10000,
            "autotuning": {"zero_stages": [0],
                           "min_train_micro_batch_size_per_gpu": 1,
                           "max_train_micro_batch_size_per_gpu": 2}}
    model = factory.tiny_model()
    t = Autotuner(ModelInfo.from_model(model), conf,
                  runner=engine_runner(model, factory.batch_fn, steps=1,
                                       device="cpu"),
                  device="cpu")
    assert t.num_chips == 1 and t.hbm_bytes > 0
    cfg, val = t.tune()
    assert cfg is not None and val > 0
    assert cfg["zero_optimization"]["stage"] == 0
    assert [r["micro_batch_size"] for r in t.records][:2] == [1, 2]
    assert all(r["throughput"] > 0 for r in t.records)
    assert all(p.is_meta for p in model.parameters())   # never trained


def test_subprocess_runner(tmp_path):
    """A real engine measurement in a fresh interpreter, plus a bad config
    quarantined without killing the tuner process."""
    env = {"PYTHONPATH": os.pathsep.join([REPO, TESTS]),
           "CUDA_VISIBLE_DEVICES": ""}
    runner = make_subprocess_runner("torch_autotune_factory:tiny_llama",
                                    steps=1, timeout=300, env=env,
                                    device="cpu", python=sys.executable)
    sched = ExperimentScheduler(runner, exps_dir=str(tmp_path))
    good = {"train_micro_batch_size_per_gpu": 1,
            "optimizer": {"type": "AdamW", "params": {"lr": 1e-3}},
            "steps_per_print": 10000}
    bad = dict(good, zero_optimization={"stage": 99})
    exps = sched.run_experiments([good, bad])
    assert exps[0].ok and exps[0].metric_val > 0, exps[0].error
    assert not exps[1].ok and exps[1].error
    assert os.path.exists(tmp_path / "exp_0.json")
