"""The port's flash-attention backward against the JAX package's.

Inputs come from numpy with a seed.  The JAX side runs kernels #2 and #3
(``_flash_bwd_pallas``) in the Pallas interpreter, as the JAX package's
own tests run them on the CPU, followed by the GQA group sum of
``_flash_vjp_bwd``; the port's ``flash_bwd`` takes its plain PyTorch
version for CPU tensors.  fp32 throughout, atol 1e-5: the two differ in
summation order and in where ``sm_scale`` is applied (the JAX kernels
fold it into q).  The autograd ``Function`` is also held against
``jax.grad`` of the JAX ``flash_attention`` and against autograd through
``mha_reference``.

The kernels themselves run only on a CUDA card: see
test_torch_gpu_kernels.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.flash_attention import (_flash_bwd_pallas,
                                               _flash_fwd_pallas)
from deepspeed_tpu.ops.flash_attention import \
    flash_attention as jax_flash_attention
from deepspeed_tpu_torch.ops import flash_attention as fa
import torch_cpu  # noqa: F401  (one torch thread a process)

ATOL = 1e-5

# B, H, Hkv, S, Sk, D, causal
CASES = {
    "causal_gqa4_2_tail": (1, 4, 2, 100, 100, 64, True),
    "noncausal_gqa4_2": (1, 4, 2, 64, 64, 64, False),
    "causal_gqa8_1": (1, 8, 1, 48, 48, 64, True),
    "sk_gt_s_d128": (1, 2, 1, 40, 72, 128, True),
    "sk_lt_s_masked_rows": (2, 4, 2, 72, 40, 64, True),
    "cross_noncausal_d128": (1, 4, 2, 72, 40, 128, False),
}


def _inputs(seed, B, H, Hkv, S, Sk, D):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, H, S, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32),
            rng.standard_normal((B, Hkv, Sk, D), dtype=np.float32),
            rng.standard_normal((B, H, S, D), dtype=np.float32))


@pytest.mark.parametrize("case", list(CASES))
def test_plain_backward_matches_pallas_kernels(case):
    B, H, Hkv, S, Sk, D, causal = CASES[case]
    q, k, v, do = _inputs(len(case), B, H, Hkv, S, Sk, D)
    kw = dict(sm_scale=1 / np.sqrt(D), causal=causal, block_q=32,
              block_k=32, interpret=True)
    jo, jlse = _flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), **kw)
    jdq, jdk, jdv = _flash_bwd_pallas(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jo, jlse,
                                      jnp.asarray(do), **kw)
    G = H // Hkv            # the group sum of _flash_vjp_bwd
    jdk = np.asarray(jdk).reshape(B, Hkv, G, Sk, D).sum(axis=2)
    jdv = np.asarray(jdv).reshape(B, Hkv, G, Sk, D).sum(axis=2)

    t = [torch.from_numpy(x) for x in (q, k, v)]
    o, lse = fa.flash_fwd(*t, causal=causal)
    dq, dk, dv = fa.flash_bwd(*t, o, lse, torch.from_numpy(do),
                              causal=causal)
    assert (dq.shape, dk.shape, dv.shape) == (q.shape, k.shape, v.shape)
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)
    if causal and Sk < S:       # rows that see no key: exactly 0
        assert (dq.numpy()[:, :, :S - Sk] == 0).all()


@pytest.mark.parametrize("case", ["causal_gqa4_2_tail", "sk_gt_s_d128",
                                  "sk_lt_s_masked_rows"])
def test_autograd_matches_jax_grad(case):
    B, H, Hkv, S, Sk, D, causal = CASES[case]
    q, k, v, do = _inputs(len(case) + 1, B, H, Hkv, S, Sk, D)

    def jloss(q, k, v):
        out = jax_flash_attention(q, k, v, causal=causal, block_q=32,
                                  block_k=32, interpret=True)
        return jnp.sum(out * jnp.asarray(do))

    want = jax.grad(jloss, argnums=(0, 1, 2))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    (fa.flash_attention(*t, causal=causal) *
     torch.from_numpy(do)).sum().backward()
    for x, w in zip(t, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("case", ["causal_gqa4_2_tail", "noncausal_gqa4_2",
                                  "causal_gqa8_1", "sk_gt_s_d128",
                                  "cross_noncausal_d128"])
def test_autograd_matches_mha_reference(case):
    """Every row sees a key here: ``mha_reference`` averages masked keys
    uniformly on rows that see none, where flash attention gives 0."""
    B, H, Hkv, S, Sk, D, causal = CASES[case]
    q, k, v, do = _inputs(len(case) + 2, B, H, Hkv, S, Sk, D)
    grads = []
    for fn in (fa.flash_attention, fa.mha_reference):
        t = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
        (fn(*t, causal=causal) * torch.from_numpy(do)).sum().backward()
        grads.append([x.grad for x in t])
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=ATOL, rtol=0)


def test_bf16_plain_backward_rounds_like_the_kernels():
    """bf16 inputs: gradients in bf16, P and dS rounded to bf16 before
    their products; within bf16 rounding (2^-8 relative per rounding) of
    the fp32 gradients."""
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(9, 1, 4, 2, 64, 64, 64))
    o32, lse32 = fa.flash_fwd(q, k, v)
    want = fa.flash_bwd(q, k, v, o32, lse32, do)
    qb, kb, vb, dob = (x.bfloat16() for x in (q, k, v, do))
    ob, lseb = fa.flash_fwd(qb, kb, vb)
    got = fa.flash_bwd(qb, kb, vb, ob, lseb, dob)
    for a, b in zip(got, want):
        assert a.dtype == torch.bfloat16
        torch.testing.assert_close(a.float(), b, atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("bad", ["do_shape", "do_dtype", "cpu_only_dq"])
def test_backward_rejects_what_it_does_not_take(bad):
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(6, 1, 4, 2, 16, 16, 64))
    o, lse = fa.flash_fwd(q, k, v)
    if bad == "do_shape":
        do = do[:, :, :8]
    elif bad == "do_dtype":
        do = do.bfloat16()
    else:
        # the kernel wrappers take only CUDA tensors; the CPU goes through
        # flash_bwd and its plain version
        with pytest.raises(ValueError, match="CUDA"):
            fa.flash_bwd_dq(q, k, v, do, lse, lse)
        return
    with pytest.raises(ValueError):
        fa.flash_bwd(q, k, v, o, lse, do)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_delta_is_the_rowsum_and_leaves_do_alone(dtype):
    """delta = rowsum(dO * O) in fp32, against the expression
    ``_flash_bwd_pallas`` uses outside Pallas; dO, which the pass
    multiplies in place after its fp32 copy, is never written, also when
    it is fp32 already.  dO and O as the model hands them: [B,S,H,D]
    seen as [B,H,S,D]."""
    rng = np.random.default_rng(9)
    do_np, o_np = (rng.standard_normal((2, 24, 4, 64), dtype=np.float32)
                   for _ in range(2))
    dt = getattr(torch, dtype)
    do = torch.from_numpy(do_np).to(dt).transpose(1, 2)
    o = torch.from_numpy(o_np).to(dt).transpose(1, 2)
    before = do.clone()
    got = fa.bwd_delta(do, o)
    assert torch.equal(do, before)
    assert got.dtype == torch.float32 and got.shape == (2, 4, 24)
    assert got.is_contiguous()
    want = jnp.sum(jnp.asarray(do.float().numpy()).astype(jnp.float32) *
                   jnp.asarray(o.float().numpy()).astype(jnp.float32),
                   axis=-1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
