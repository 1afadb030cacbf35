"""ZeRO stages 1-3 across two GPUs over NCCL.

Marked ``gpu``: it needs at least two CUDA GPUs (NCCL puts one rank on
each) and skips with the reason otherwise.  It imports only torch and the
port, so it runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_zero.py

Two ranks spawned by ``torch_dist_workers.spawn`` (``file://``
rendezvous, no TCP port) train the tiny fp32 Llama of
``tests/test_torch_zero.py`` at stages 1, 2 and 3 (3 with hpZ off) on
``cuda:0`` and ``cuda:1``; the losses equal the one-GPU stage-0 engine's
to rtol 1e-5 (fp32, only the reductions' order differs, TF32 off), every
rank returns the same losses, and each step issues exactly the plan's
collectives, every one through NCCL.
"""
import numpy as np
import pytest
import torch

from torch_dist_workers import (TINY, make_engine, spawn, tiny_model,
                                zero_worker)

pytestmark = pytest.mark.gpu


@pytest.fixture
def two_gpus():
    # decided inside the test run, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs two CUDA GPUs: NCCL puts one rank on each")
    if torch.cuda.device_count() < 2:
        pytest.skip(f"needs two CUDA GPUs, {torch.cuda.device_count()} "
                    "visible: NCCL refuses two ranks on one device")


def test_stages_over_nccl_match_stage0(two_gpus, tmp_path):
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(0)
    state = _state(rng)
    batches = [rng.integers(0, TINY["vocab_size"], size=(8, 16))
               for _ in range(3)]
    eng = make_engine(state, 0, device="cuda")
    want = [float(eng.train_batch(batch=b)) for b in batches]
    del eng
    cases = [(1, 1, True), (2, 1, True), (3, 1, True)]
    out = spawn(zero_worker, 2, str(tmp_path), state=state, batches=batches,
                cases=cases, device="cuda")
    for case in cases:
        got = out[0][case]
        assert out[1][case]["losses"] == got["losses"]
        np.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        for rank in out:
            assert rank[case]["per_step"] == rank[case]["want_per_step"]
            assert rank[case]["backend"] == rank[case]["per_step"]


def _state(rng):
    """Seeded weights by parameter name: N(0, 1/fan_in) matrices, unit
    norms."""
    return {n: (np.ones(p.shape) if p.dim() == 1 else
                rng.standard_normal(p.shape) / np.sqrt(p.shape[-1])
                ).astype(np.float32)
            for n, p in tiny_model().named_parameters()}
