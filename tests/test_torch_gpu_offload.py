"""The offload tiers on the card (``runtime/swap_tensor.py``).

Marked ``gpu``: it needs a CUDA GPU and ``nvcc`` (kernel #4) and skips
without one.  It imports only torch and the port, so it runs where JAX is
not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_offload.py

- one bucket of page-locked host state through #4 on the card against
  ``adam_update_reference``, fp32 rtol 1e-6 and atol 1e-7 (the two
  differ only where the compiler contracts a multiply-add);
- a small bf16 Llama trained 3 steps at stages 0, 2 and 3 (no process
  group: one rank) with the optimizer state resident, in tier ``cpu``
  (stage 3: the working copy too) and in tier ``nvme``, pipelined and
  serial, over many buckets: losses, masters and moments bit-identical
  to resident, one #4 launch a bucket a step; with ``fused: false``
  both run the plain update (the two differ from each other, so a tier
  that launched #4 there would not give the resident bits);
- ``offload_states`` moving a resident engine's moments and master to
  page-locked host RAM between steps, the next step moving them back:
  the same bits as an engine that never moved them.
"""
import numpy as np
import pytest
import torch

from torch_dist_workers import TINY, whole_pieces

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    # decided inside the test run, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU (kernel #4 has no CPU build)")


def test_one_bucket_from_pinned_staging_matches_plain(cuda):
    from deepspeed_tpu_torch.ops import fused_adam as fo
    from deepspeed_tpu_torch.runtime.swap_tensor import host_buffer

    n = 1 << 22
    dev = torch.device("cuda")
    owners = []
    gen = torch.Generator().manual_seed(0)
    host = []
    for scale in (1.0, 1e-3, 1e-4):
        h = host_buffer(n, torch.float32, dev, owners=owners)
        h.copy_(torch.rand(n, generator=gen) * scale)
        host.append(h)
    assert all(o.pinned for o in owners)
    assert all(h.is_pinned() for h in host)
    p, m, v = (h.to(dev, non_blocking=True) for h in host)
    g = torch.randn(n, generator=gen).to(dev) * 1e-2
    w = torch.empty(n, dtype=torch.bfloat16, device=dev)
    sc = torch.tensor([3e-4, 0.19, 0.0975, 0.5, 0.0], device=dev)
    kw = dict(b1=0.9, b2=0.95, eps=1e-8, wd=0.1, adam_w=True)
    ref = [t.clone() for t in (p, m, v, w)]
    before = fo.fused_adam.launches
    fo.fused_adam(p, g, m, v, sc, w, **kw)
    assert fo.fused_adam.launches == before + 1
    fo.adam_update_reference(ref[0], g, ref[1], ref[2], sc, ref[3], **kw)
    for a, b in zip((p, m, v), ref[:3]):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)
    assert torch.equal(w, p.to(torch.bfloat16))
    # and back into the page-locked buffers, asynchronously
    for h, d in zip(host, (p, m, v)):
        h.copy_(d, non_blocking=True)
    torch.cuda.synchronize()
    assert torch.equal(host[0], p.cpu())


def _engine(stage, fused=True, **zero):
    import deepspeed_tpu_torch
    from deepspeed_tpu_torch.models import llama

    with torch.device("meta"):
        model = llama.LlamaLMLoss(llama.LlamaConfig(
            **TINY, dtype=torch.bfloat16, param_dtype=torch.float32))
    cfg = {"train_batch_size": 4, "gradient_accumulation_steps": 2,
           "bf16": {"enabled": True}, "gradient_clipping": 1.0,
           "steps_per_print": 100,
           "optimizer": {"type": "AdamW", "params": {
               "lr": 1e-3, "weight_decay": 0.1, "fused": fused}},
           "zero_optimization": dict(
               stage=stage, stage3_param_persistence_threshold=1000,
               **zero)}
    return deepspeed_tpu_torch.initialize(
        model=model, config=cfg,
        generator=torch.Generator(device="cuda").manual_seed(0))[0]


def _run(stage, steps, batches, fused=True, **zero):
    eng = _engine(stage, fused, **zero)
    losses = [float(eng.train_batch(batch=b)) for b in batches[:steps]]
    pieces = whole_pieces(eng)
    buckets = None if eng.swapper is None else len(eng.swapper.buckets)
    if eng.swapper is not None:
        eng.swapper.close()
    return losses, pieces, buckets


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("stage", [0, 2, 3])
def test_tiers_give_the_resident_bits(cuda, stage, fused, tmp_path,
                                      monkeypatch):
    from deepspeed_tpu_torch.ops import fused_adam as fo

    monkeypatch.setenv("DSTPU_SWAP_BUCKET_MB", "1")
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, TINY["vocab_size"], size=(4, 32))
               for _ in range(3)]
    want, want_pieces, _ = _run(stage, 3, batches, fused)
    param = {"offload_param": {"device": "cpu"}} if stage == 3 else {}
    for tier, pipe in (("cpu", True), ("nvme", True), ("nvme", False)):
        before = fo.fused_adam.launches
        got, pieces, nb = _run(stage, 3, batches, fused, offload_optimizer={
            "device": tier, "nvme_path": str(tmp_path),
            "pipeline_read": pipe, "pipeline_write": pipe}, **param)
        assert nb > 4
        assert fo.fused_adam.launches - before == (3 * nb if fused else 0)
        assert got == want, (tier, pipe, got, want)
        assert pieces.keys() == want_pieces.keys()
        for k, v in want_pieces.items():
            assert torch.equal(pieces[k], v), (tier, pipe, k)


def test_offload_states_round_trip(cuda):
    """A resident engine's moments and master go to page-locked host RAM
    between steps and come back at the next step, bit for bit."""
    rng = np.random.default_rng(1)
    batches = [rng.integers(0, TINY["vocab_size"], size=(4, 32))
               for _ in range(3)]
    want, want_pieces, _ = _run(2, 3, batches)
    eng = _engine(2)
    got = [float(eng.train_batch(batch=batches[0]))]
    eng.offload_states(("optimizer", "params"))
    st = eng.state
    assert st.params.device.type == "cpu" and st.params.is_pinned()
    assert all(v.device.type == "cpu" for k, v in st.opt_state.items()
               if k != "count")
    got += [float(eng.train_batch(batch=b)) for b in batches[1:]]
    assert st.params.device.type == "cuda"
    assert got == want
    pieces = whole_pieces(eng)
    for k, v in want_pieces.items():
        assert torch.equal(pieces[k], v), k
