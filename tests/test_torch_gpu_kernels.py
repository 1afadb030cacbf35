"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA GPU: a CUDA
kernel has no CPU mode.  The file imports only torch and the port, so it
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

Tolerances: bf16 outputs 2e-2 (p and o round to bf16 at 2^-8 relative, in
different places in the kernel and the plain version); fp32 outputs 1e-4
(full fp32 products, another summation order); lse 2e-3 absolute.
"""
import pytest
import torch

from deepspeed_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda():
    # decided inside the test run, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, B, H, Hkv, S, Sk, D, dtype, device):
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g).to(device, dtype).transpose(1, 2)
    k = torch.randn(B, Hkv, Sk, D, generator=g).to(device, dtype)
    v = torch.randn(B, Hkv, Sk, D, generator=g).to(device, dtype)
    return q, k, v


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [
    (2, 4, 2, 100, 130, 128, True),    # Sk > S, ragged causal edge, GQA
    (2, 4, 2, 130, 100, 64, True),     # Sk < S: rows that see no key
    (1, 8, 8, 64, 64, 64, False),      # one full tile, not causal
])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain(cuda, shape, dtype):
    dt = getattr(torch, dtype)
    B, H, Hkv, S, Sk, D, causal = shape
    q, k, v = _qkv(sum(shape), B, H, Hkv, S, Sk, D, dt, cuda)
    before = fa.flash_fwd.launches
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    assert fa.flash_fwd.launches == before + 1
    ro, rlse = fa.flash_fwd_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    tol = 2e-2 if dt == torch.bfloat16 else 1e-4
    torch.testing.assert_close(o.float(), ro.float(), atol=tol, rtol=tol)
    torch.testing.assert_close(lse, rlse, atol=2e-3, rtol=1e-4)
    if causal and Sk < S:
        assert torch.isinf(lse[:, :, :S - Sk]).all()
        assert (o[:, :, :S - Sk] == 0).all()


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(0, 1, 2, 2, 16, 16, 64, torch.bfloat16, cuda)
    misaligned = torch.empty(1, 2, 16, 65, dtype=torch.bfloat16,
                             device=cuda)[..., 1:]
    before = fa.flash_fwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(misaligned, k, v)
    assert fa.flash_fwd.launches == before
