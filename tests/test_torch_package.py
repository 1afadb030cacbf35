"""Package-level contracts of the PyTorch port ``deepspeed_tpu_torch``.

- It imports neither JAX nor the JAX package (checked in a fresh
  interpreter, and by an AST scan of every port file and chip_smoke.py).
- Entry points run on the GPU unless the caller asks for the CPU: with no
  GPU and no ``device="cpu"`` they raise.
- Kernel launch counters stay 0 when everything runs on the CPU (the v1
  engine's flash kernel, the v2 engine's paged kernels, the training
  engine's flash backward and optimizer kernels), and a tensor on neither
  the CPU nor a GPU reaches no plain version: the wrappers raise.
- Its inference config parses JSON configs to the same values as the JAX
  package's.
- ``chip_smoke.py`` refuses to run without a GPU and prints no result.
- The kernel builder names a library by its source, every shared header
  and its flags, so editing a header rebuilds (checked on a copy of
  ``csrc``, without ``nvcc``), and the package ships the headers.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import deepspeed_tpu_torch
from deepspeed_tpu.inference.config import \
    load_inference_config as jax_load_config
from deepspeed_tpu.telemetry.slo import parse_objective as jax_parse
from deepspeed_tpu_torch import accelerator
from deepspeed_tpu_torch.inference.config import load_inference_config
from deepspeed_tpu_torch.models import llama
from deepspeed_tpu_torch.ops import builder
from deepspeed_tpu_torch.ops import flash_attention as fa
from deepspeed_tpu_torch.ops import fused_adam as fo
from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa
from deepspeed_tpu_torch.telemetry.slo import parse_objective
import torch_cpu  # noqa: F401  (one torch thread a process)

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "deepspeed_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "deepspeed_tpu")


def _forbidden(module: str) -> bool:
    return module.split(".")[0] in FORBIDDEN


def test_import_loads_no_jax():
    code = ("import sys, deepspeed_tpu_torch, "
            "deepspeed_tpu_torch.models.llama, "
            "deepspeed_tpu_torch.models.gpt2, "
            "deepspeed_tpu_torch.module_inject.flax_bridge, "
            "deepspeed_tpu_torch.inference.v2.ragged_engine, "
            "deepspeed_tpu_torch.inference.paged, "
            "deepspeed_tpu_torch.inference.sampling, "
            "deepspeed_tpu_torch.ops.ragged_paged_attention, "
            "deepspeed_tpu_torch.telemetry.requests, "
            "deepspeed_tpu_torch.telemetry, deepspeed_tpu_torch.serving, "
            "deepspeed_tpu_torch.serving.server, "
            "deepspeed_tpu_torch.serving.client, "
            "deepspeed_tpu_torch.control, "
            "deepspeed_tpu_torch.runtime.engine, "
            "deepspeed_tpu_torch.checkpoint.engine, "
            "deepspeed_tpu_torch.ops.fused_adam, "
            "deepspeed_tpu_torch.ops.quantization, "
            "deepspeed_tpu_torch.inference.quantization, "
            "deepspeed_tpu_torch.utils.timer, "
            "deepspeed_tpu_torch.utils.tensor_fragment, "
            "deepspeed_tpu_torch.comm, deepspeed_tpu_torch.comm.benchmark, "
            "deepspeed_tpu_torch.parallel.topology, "
            "deepspeed_tpu_torch.runtime.zero, "
            "deepspeed_tpu_torch.checkpoint.reshard, "
            "deepspeed_tpu_torch.resilience.distributed\n"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*PORT.rglob("*.py"),
                                       REPO / "chip_smoke.py"]))
def test_no_file_imports_jax(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        bad = [n for n in names if _forbidden(n)]
        assert not bad, f"{path}:{node.lineno} imports {bad}"


def test_entry_points_refuse_to_run_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        accelerator.resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        accelerator.resolve_device("cuda")
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(llama.get_config(
            "tinyllama", hidden_size=128, num_attention_heads=2,
            num_key_value_heads=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.init_inference(model, config={"dtype": "fp32"})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.RaggedInferenceEngineV2(model)
    with torch.device("meta"):
        lm = llama.LlamaLMLoss(llama.get_config(
            "tinyllama", hidden_size=128, num_attention_heads=2,
            num_key_value_heads=1))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        deepspeed_tpu_torch.initialize(model=lm, config={})
    assert accelerator.resolve_device("cpu") == torch.device("cpu")


def test_launch_counter_stays_zero_on_cpu():
    start = fa.flash_fwd.launches
    g = torch.Generator().manual_seed(0)
    q = torch.randn(1, 2, 20, 64, generator=g)
    k = torch.randn(1, 1, 20, 64, generator=g)
    fa.flash_attention(q, k, k, causal=True)
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(llama.get_config(
            "tinyllama", hidden_size=128, num_attention_heads=2,
            num_key_value_heads=1))
    eng = deepspeed_tpu_torch.init_inference(
        model, config={"dtype": "float32", "max_out_tokens": 32},
        generator=torch.Generator().manual_seed(0), device="cpu")
    out = eng.generate(torch.zeros(2, 5, dtype=torch.long), max_new_tokens=3)
    assert out.shape == (2, 8)
    assert fa.flash_fwd.launches == start == 0


def test_training_launch_counters_stay_zero_on_cpu():
    counters = (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv,
                fo.fused_adam, fo.fused_lion)
    with torch.device("meta"):
        model = llama.LlamaLMLoss(llama.get_config(
            "tinyllama", hidden_size=128, num_attention_heads=2,
            num_key_value_heads=1))
    for opt in ("AdamW", "Lion"):
        eng, *_ = deepspeed_tpu_torch.initialize(
            model=model, device="cpu",
            config={"train_batch_size": 2, "bf16": {"enabled": True},
                    "optimizer": {"type": opt, "params": {"fused": True}}},
            generator=torch.Generator().manual_seed(0))
        loss = eng.train_batch(batch=np.ones((2, 16), np.int64))
        assert torch.isfinite(loss)
    assert [c.launches for c in counters] == [0] * 5


@pytest.mark.parametrize("wrapper", ["flash_bwd", "flash_bwd_dq",
                                     "flash_bwd_dkv", "fused_adam",
                                     "fused_lion"])
def test_new_wrappers_never_take_the_plain_path_off_the_cpu(wrapper,
                                                            monkeypatch):
    """A tensor that is not on the CPU (here the meta device: this sandbox
    has no GPU) makes the wrapper launch its kernel or raise, never run
    the plain version."""
    def plain(*a, **k):
        raise AssertionError("took the plain path")

    for name in ("flash_bwd_reference",):
        monkeypatch.setattr(fa, name, plain)
    monkeypatch.setattr(fo, "adam_update_reference", plain)
    monkeypatch.setattr(fo, "lion_update_reference", plain)
    meta = dict(device="meta")
    q = torch.empty(1, 2, 16, 64, **meta)
    k = torch.empty(1, 1, 16, 64, **meta)
    lse = torch.empty(1, 2, 16, **meta)
    p = torch.empty(100, **meta)
    sc = torch.empty(5, **meta)
    calls = {
        "flash_bwd": lambda: fa.flash_bwd(q, k, k, q, lse, q),
        "flash_bwd_dq": lambda: fa.flash_bwd_dq(q, k, k, q, lse, lse),
        "flash_bwd_dkv": lambda: fa.flash_bwd_dkv(q, k, k, q, lse, lse),
        "fused_adam": lambda: fo.fused_adam(p, p, p, p, sc),
        "fused_lion": lambda: fo.fused_lion(p, p, p, sc),
    }
    with pytest.raises(ValueError):
        calls[wrapper]()


@pytest.mark.parametrize("kv_cache_dtype", ["none", "int8"])
def test_paged_launch_counters_stay_zero_on_cpu(kv_cache_dtype):
    counters = (rpa.ragged_paged_attention, rpa.ragged_paged_attention_quant)
    with torch.device("meta"):
        model = llama.LlamaForCausalLM(llama.get_config(
            "tinyllama", hidden_size=128, num_attention_heads=2,
            num_key_value_heads=1))
    eng = deepspeed_tpu_torch.RaggedInferenceEngineV2(
        model, generator=torch.Generator().manual_seed(0), device="cpu",
        max_seqs=2, max_seq_len=64, prefill_chunk=16, page_size=16,
        kv_cache_dtype=kv_cache_dtype)
    outs = eng.generate_all([np.arange(1, 20), np.arange(3, 8)],
                            max_new_tokens=12)
    assert sorted(len(t) for t in outs.values()) == [17, 31]
    assert eng.host_stats.ticks > 0
    assert [f.launches for f in counters] == [0, 0]


@pytest.mark.parametrize("config", [
    {},
    {"dtype": "fp16", "max_out_tokens": 2048, "tp": {"tp_size": 1},
     "quant": {"qtype": "fp8", "group_size": 64}},
    {"v2": {"async_depth": 3, "slo": ["ttft_ms_p99 <= 150"],
            "kv_tiering": {"enabled": True, "checksum": "crc32"},
            "speculation": {"mode": "ngram", "k": 2}}},
])
def test_config_parses_like_jax(config):
    got = load_inference_config(json.loads(json.dumps(config))).model_dump()
    want = jax_load_config(json.loads(json.dumps(config))).model_dump()
    assert got == want


@pytest.mark.parametrize("bad", [
    {"v2": {"kv_tiering": {"checksum": "md5"}}},
    {"v2": {"slo": ["ttft_ms <= 150"]}},
    {"v2": {"async_depth": 0}}])
def test_config_rejects_like_jax(bad):
    with pytest.raises(ValueError):
        jax_load_config(bad)
    with pytest.raises(ValueError):
        load_inference_config(bad)


@pytest.mark.parametrize("spec", ["ttft_ms_p99 <= 150", "tpot_ms_p99.9<2.5"])
def test_parse_objective_matches_jax(spec):
    got, want = parse_objective(spec), jax_parse(spec)
    assert (got.name, got.metric, got.target, got.threshold) == (
        want.name, want.metric, want.target, want.threshold)


@pytest.mark.parametrize("where", ["repo", "alone"])
def test_chip_smoke_refuses_without_gpu(where, tmp_path):
    """With no GPU visible, chip_smoke.py must fail before printing a
    result, both in the repository and as a lone copy outside it."""
    script = REPO / "chip_smoke.py"
    if where == "alone":
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                         capture_output=True, text=True, timeout=120, env=env)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.fixture
def csrc_copy(tmp_path, monkeypatch):
    """The builder pointed at a temporary copy of ``csrc``."""
    copy = Path(shutil.copytree(builder.CSRC, tmp_path / "csrc"))
    monkeypatch.setattr(builder, "CSRC", copy)
    return copy


def _append(path: Path, text: str) -> None:
    path.write_text(path.read_text() + text)


@pytest.mark.parametrize("edit", ["header", "source", "flags"])
def test_builder_target_tracks_headers_and_flags(csrc_copy, monkeypatch,
                                                 edit):
    before = builder._target("flash_fwd")
    assert builder._target("flash_fwd") == before
    if edit == "header":
        _append(csrc_copy / "hopper.cuh", "\n// edited\n")
    elif edit == "source":
        _append(csrc_copy / "flash_fwd.cu", "\n// edited\n")
    else:
        monkeypatch.setitem(builder.EXTRA_FLAGS, "flash_fwd", ("-lineinfo",))
    after = builder._target("flash_fwd")
    assert after != before and after.parent == before.parent


def test_builder_target_ignores_other_sources(csrc_copy):
    fwd, adam = builder._target("flash_fwd"), builder._target("fused_adam")
    _append(csrc_copy / "fused_adam.cu", "\n// edited\n")
    assert builder._target("flash_fwd") == fwd
    assert builder._target("fused_adam") != adam


def test_package_data_ships_the_headers():
    text = (REPO / "pyproject.toml").read_text()
    headers = sorted(builder.CSRC.glob("*.cuh"))
    assert headers and '"csrc/*.cuh"' in text
    assert '#include "hopper.cuh"' in (builder.CSRC /
                                       "flash_fwd.cu").read_text()
