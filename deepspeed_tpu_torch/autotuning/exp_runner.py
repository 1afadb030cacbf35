"""Single-experiment subprocess entry (reference: the training script
relaunched by the autotuner's ResourceManager with ``--autotuning run``).

Counterpart of ``deepspeed_tpu/autotuning/exp_runner.py``.  Builds the
user's model via the ``--factory`` import path, runs a few timed
``train_batch`` steps under the candidate ds_config, each window closed
by ``torch.cuda.synchronize()`` on the card, and writes
``{"metric_val": samples_per_sec}`` to ``--out``.  Any failure (out of
memory, a kernel that does not build, a bad config) exits nonzero: the
parent quarantines it.

Usage::

    python -m deepspeed_tpu_torch.autotuning.exp_runner --config c.json \\
        --factory pkg.module:fn --out result.json [--steps 3] [--device cpu]
"""
from __future__ import annotations

import argparse
import importlib
import json
import time


def _load_factory(spec: str):
    mod_name, _, fn_name = spec.partition(":")
    if not fn_name:
        raise ValueError(f"--factory must be 'pkg.module:fn', got {spec!r}")
    return getattr(importlib.import_module(mod_name), fn_name)


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True)
    p.add_argument("--factory", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default=None)
    args = p.parse_args(argv)

    import torch

    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.accelerator import resolve_device

    device = resolve_device(args.device)
    with open(args.config) as f:
        ds_config = json.load(f)
    model, batch_fn = _load_factory(args.factory)()
    engine, *_ = deepspeed_tpu_torch.initialize(
        model=model, config=ds_config, device=device,
        generator=torch.Generator(device=device).manual_seed(0))
    batch = batch_fn(engine.config.train_batch_size)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    engine.train_batch(batch=batch)             # warm-up: kernel builds
    sync()
    t0 = time.perf_counter()
    for _ in range(args.steps):
        engine.train_batch(batch=batch)
    sync()
    dt = (time.perf_counter() - t0) / args.steps
    with open(args.out, "w") as f:
        json.dump({"metric_val": engine.config.train_batch_size / dt,
                   "seconds_per_step": dt}, f)


if __name__ == "__main__":
    main()
