"""The port's flash-attention forward against the JAX package's.

Inputs come from numpy with a seed and go through the JAX Pallas kernel
(in interpret mode, as ``tests/unit/ops/test_flash_attention.py`` runs it
on the CPU) and through ``deepspeed_tpu_torch.ops.flash_attention``, which
takes its plain PyTorch version for CPU tensors.  All in fp32, atol 2e-5:
the two differ only in summation order and in where ``sm_scale`` is
applied (the JAX kernel folds it into q, the port scales the scores).

The kernel itself runs only on a CUDA card: see test_torch_gpu_kernels.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.flash_attention import _flash_fwd_pallas
from deepspeed_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu.ops.flash_attention import mha_reference as jax_mha
from deepspeed_tpu_torch.ops import flash_attention as fa

ATOL = 2e-5


# B, H, Hkv, S, Sk, D, causal
CASES = {
    "causal": (1, 2, 2, 64, 64, 64, True),
    "noncausal": (1, 2, 2, 64, 64, 64, False),
    "gqa": (2, 4, 2, 48, 48, 64, True),
    "ragged_s_d128": (1, 2, 1, 80, 80, 128, True),
    "sk_gt_s_bottom_right": (1, 2, 2, 40, 72, 64, True),
    "sk_lt_s_masked_rows": (1, 2, 2, 72, 40, 64, True),
    "cross_noncausal_d128": (1, 4, 2, 72, 40, 128, False),
}


def _qkv(seed, B, H, Hkv, S, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_forward_matches_pallas_kernel(case):
    B, H, Hkv, S, Sk, D, causal = CASES[case]
    q, k, v = _qkv(len(case), B, H, Hkv, S, Sk, D)
    jo, jlse = _flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), sm_scale=1 / np.sqrt(D),
                                 causal=causal, block_q=32, block_k=32,
                                 interpret=True)
    o, lse = fa.flash_fwd(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), causal=causal)
    assert o.shape == (B, H, S, D) and o.dtype == torch.float32
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=ATOL, rtol=0)
    # +inf rows (no valid key) must coincide; assert_allclose equates infs
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=ATOL,
                               rtol=0)
    if causal and Sk < S:
        blind = S - Sk
        assert np.isinf(lse.numpy()[:, :, :blind]).all()
        assert not np.isinf(lse.numpy()[:, :, blind:]).any()
        assert (o.numpy()[:, :, :blind] == 0).all()
    # the public call, against the JAX public call in interpret mode
    jout = jax_flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, block_q=32, block_k=32,
                               interpret=True)
    out = fa.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=ATOL,
                               rtol=0)


@pytest.mark.parametrize("causal,with_bias", [(True, False), (False, True)])
def test_mha_reference_matches_jax(causal, with_bias):
    q, k, v = _qkv(3, 2, 4, 2, 24, 24, 64)
    bias = (np.random.default_rng(4).standard_normal((1, 1, 24, 24),
                                                     dtype=np.float32)
            if with_bias else None)
    want = jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=causal,
                   bias=None if bias is None else jnp.asarray(bias))
    got = fa.mha_reference(torch.from_numpy(q), torch.from_numpy(k),
                           torch.from_numpy(v), causal=causal,
                           bias=None if bias is None else torch.from_numpy(
                               bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_plain_forward_bf16_rounds_like_the_kernel():
    """bf16 inputs: fp32 scores, p cast to bf16 before PV, o in bf16."""
    q, k, v = (torch.from_numpy(x).bfloat16()
               for x in _qkv(5, 1, 2, 2, 40, 40, 64))
    o, lse = fa.flash_fwd(q, k, v, causal=True)
    assert o.dtype == torch.bfloat16 and lse.dtype == torch.float32
    ref = fa.mha_reference(q.float(), k.float(), v.float(), causal=True)
    # bf16 p and o each round at 2^-8 relative
    np.testing.assert_allclose(o.float().numpy(), ref.numpy(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize("bad", ["dtype", "head_dim", "gqa", "rank",
                                 "mixed_dtype", "kv_shape"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    q, k, v = (torch.from_numpy(x) for x in _qkv(6, 1, 4, 2, 16, 16, 64))
    if bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "head_dim":
        q, k, v = q[..., :32], k[..., :32], v[..., :32]
    elif bad == "gqa":
        q = q[:, :3]
    elif bad == "rank":
        q = q[0]
    elif bad == "mixed_dtype":
        k = k.bfloat16()
    elif bad == "kv_shape":
        v = v[:, :, :8]
    with pytest.raises((TypeError, ValueError)):
        fa.flash_fwd(q, k, v)

