"""The port's fused Adam and Lion steps against the JAX package's kernels.

The JAX side runs kernels #4 and #5 (``adam_update_leaf`` and
``lion_update_leaf`` with ``interpret=True``) in the Pallas interpreter
and applies ``p - lr * u`` as the JAX engine does; the port's
``fused_adam`` / ``fused_lion`` take their plain PyTorch versions for CPU
tensors and apply the update in place.  Inputs come from numpy with a
seed, over odd sizes.  fp32, rtol 1e-6 and atol 1e-7 for p, m and v (the
two compute 1 - b^t and the divisions in another order).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.ops.fused_adam import adam_update_leaf, lion_update_leaf
from deepspeed_tpu_torch.ops import fused_adam as fo
import torch_cpu  # noqa: F401  (one torch thread a process)

SHAPES = [(700,), (129,), (3, 5, 7)]
LR = 1e-3
B1, B2, EPS = 0.9, 0.999, 1e-8


def _state(seed, shape):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, dtype=np.float32) * s
            for s in (1.0, 1e-2, 0.0, 0.0)]      # p, g, m, v


def _scalars(step, lr=LR, gscale=1.0, skip=0.0, b1=B1, b2=B2):
    t = torch.tensor(float(step))
    return torch.stack([torch.tensor(lr), 1 - torch.pow(b1, t),
                        1 - torch.pow(b2, t), torch.tensor(gscale),
                        torch.tensor(skip)]).float()


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("adam_w", [True, False])
def test_adam_matches_pallas_kernel_over_three_steps(shape, adam_w):
    p, g, m, v = _state(sum(shape), shape)
    jp, jm, jv = jnp.asarray(p), jnp.asarray(m), jnp.asarray(v)
    tp, tm, tv = (torch.from_numpy(x.reshape(-1).copy()) for x in (p, m, v))
    rng = np.random.default_rng(1)
    for step in (1, 2, 3):
        g = rng.standard_normal(shape, dtype=np.float32) * 1e-2
        u, jm, jv = adam_update_leaf(
            jnp.asarray(g), jp, jm, jv, jnp.asarray(step), b1=B1, b2=B2,
            eps=EPS, wd=0.1, adam_w=adam_w, interpret=True)
        jp = jp - LR * u
        fo.fused_adam(tp, torch.from_numpy(g.reshape(-1)), tm, tv,
                      _scalars(step), b1=B1, b2=B2, eps=EPS, wd=0.1,
                      adam_w=adam_w)
    for got, want in ((tp, jp), (tm, jm), (tv, jv)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape", SHAPES)
def test_lion_matches_pallas_kernel_over_three_steps(shape):
    p, _, m, _ = _state(sum(shape) + 1, shape)
    jp, jm = jnp.asarray(p), jnp.asarray(m)
    tp, tm = (torch.from_numpy(x.reshape(-1).copy()) for x in (p, m))
    rng = np.random.default_rng(2)
    for step in (1, 2, 3):
        g = rng.standard_normal(shape, dtype=np.float32) * 1e-2
        u, jm = lion_update_leaf(jnp.asarray(g), jp, jm, jnp.asarray(step),
                                 b1=0.9, b2=0.99, wd=0.1, interpret=True)
        jp = jp - LR * u
        fo.fused_lion(tp, torch.from_numpy(g.reshape(-1)), tm,
                      _scalars(step), b1=0.9, b2=0.99, wd=0.1)
    for got, want in ((tp, jp), (tm, jm)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want).reshape(-1),
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("opt", ["adam", "lion"])
def test_overflow_flag_leaves_the_state_untouched(opt):
    p, g, m, v = (torch.from_numpy(x.reshape(-1)) for x in
                  _state(5, (129,)))
    m += 0.5
    v += 0.25
    w = p.to(torch.bfloat16) + 1       # a working copy that must not move
    before = [t.clone() for t in (p, m, v, w)]
    sc = _scalars(1, skip=1.0)
    if opt == "adam":
        fo.fused_adam(p, g, m, v, sc, w, wd=0.1)
    else:
        fo.fused_lion(p, g, m, sc, w, wd=0.1)
    for a, b in zip((p, m, v, w), before):
        assert torch.equal(a, b)


def test_one_multi_leaf_call_equals_leaf_by_leaf_calls():
    """The engine's one launch over flat buffers computes what per-leaf
    calls compute (the JAX kernels run per leaf)."""
    leaves = [_state(i, s) for i, s in enumerate(SHAPES)]
    flat = [torch.from_numpy(np.concatenate([lf[j].reshape(-1)
                                             for lf in leaves]))
            for j in range(4)]
    flat[3] += 1e-4
    per_leaf = [[torch.from_numpy(x.reshape(-1).copy()) for x in lf]
                for lf in leaves]
    for lf in per_leaf:
        lf[3] += 1e-4
    sc = _scalars(2, gscale=0.5)
    w = flat[0].to(torch.bfloat16)
    fo.fused_adam(flat[0], flat[1], flat[2], flat[3], sc, w, wd=0.01)
    for lf in per_leaf:
        fo.fused_adam(lf[0], lf[1], lf[2], lf[3], sc, wd=0.01)
    for j in (0, 2, 3):
        assert torch.equal(flat[j], torch.cat([lf[j] for lf in per_leaf]))
    assert torch.equal(w, flat[0].to(torch.bfloat16))


def test_gradient_scale_is_applied_first():
    p, g, m, v = (torch.from_numpy(x.reshape(-1)) for x in _state(3, (700,)))
    a = [t.clone() for t in (p, g, m, v)]
    fo.fused_adam(a[0], a[1], a[2], a[3], _scalars(1, gscale=0.25))
    b = [t.clone() for t in (p, g, m, v)]
    fo.fused_adam(b[0], b[1] * 0.25, b[2], b[3], _scalars(1))
    for x, y in zip(a, b):
        if x is not a[1]:
            assert torch.equal(x, y)


@pytest.mark.parametrize("bad", ["dtype", "size", "scalars", "w_dtype"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    p, g, m, v = (torch.from_numpy(x.reshape(-1)) for x in _state(4, (129,)))
    sc, w = _scalars(1), None
    if bad == "dtype":
        g = g.double()
    elif bad == "size":
        m = m[:100]
    elif bad == "scalars":
        sc = sc[:3]
    else:
        w = p.to(torch.int32)
    with pytest.raises(ValueError):
        fo.fused_adam(p, g, m, v, sc, w)
