"""The port's fp8, fp6 and W8A8 weight formats against the JAX package's
functions, bit for bit, on seeded numpy inputs in fp32 and bf16.

- fp8 (``quantize_fp8`` / ``dequantize_fp8``): payload bits, the scale,
  the dequantized output.
- fp6 (``quantize_fp6`` / ``dequantize_fp6``): packed bytes, scales, the
  group size at groups of 128, 512 and 2048, a size that drives the
  group-size search loop and one that takes the pad-to-4 path; and a
  group of edge values (0, exact powers of two, the subnormal boundary,
  ``FP6_MAX``, rounding ties, the mantissa ``bump``, the clip).
- W8A8: the weight's payload and per-channel scale against
  ``quantize_param_tree``'s w8a8 branch; :func:`w8a8_linear` and
  ``W8A8Linear`` against ``w8a8_dot_general`` at M 1, 16 and 17 with a
  zero row and an inf row, exactly (NaN where the reference has NaN);
  the card's GEMM kernel's arithmetic replayed in plain torch block by
  block as :func:`w8a8_plan` cuts a call (the row max over slices, the
  int32 partials of a tile shared by blocks summed in a shuffled order,
  the epilogue's order) against ``w8a8_dot_general`` at M 1, 16, 80 and
  300, and the plan's invariants at every ``llama3-8b`` Linear.
- The CPU takes the plain versions (no launch counted); a tensor off the
  CPU never does.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import quantization as jax_iq
from deepspeed_tpu.ops import quantization as jax_q
from deepspeed_tpu_torch.inference import quantization as iq
from deepspeed_tpu_torch.ops import quantization as q
import torch_cpu  # noqa: F401  (one torch thread a process)

SHAPES = {"rows": (64, 256), "odd": (37, 53), "flat": (4103,)}


def _inputs(shape, dtype, seed=0):
    """The same values as a JAX array and a torch tensor: rows of mixed
    magnitude with a zero row, made in numpy fp32 and rounded to ``dtype``
    by JAX."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    if len(shape) == 2:
        x *= rng.uniform(0.01, 3.0, size=(shape[0], 1)).astype(np.float32)
    x[0] = 0.0
    jx = jnp.asarray(x, dtype=getattr(jnp, dtype))
    return jx, _torch(jx)


def _torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    if a.dtype.name == "float8_e4m3fn":
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def _bits(a):
    """Raw bits of a float array or tensor, for bit-exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.contiguous()
        return a.view({1: torch.uint8, 2: torch.int16,
                       4: torch.int32}[a.element_size()]).numpy()
    a = np.asarray(a)
    return a.view({1: np.uint8, 2: np.int16, 4: np.int32}[a.dtype.itemsize])


def _same(got: torch.Tensor, want) -> None:
    """Bit-equal, NaN matched to NaN whatever its payload and sign (the
    two frameworks' casts keep different NaN bits)."""
    g = got.float().numpy()
    w = np.asarray(want, np.float32)
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    keep = ~np.isnan(w)
    np.testing.assert_array_equal(_bits(got)[keep], _bits(want)[keep])


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_matches_jax(shape, dtype):
    jx, tx = _inputs(SHAPES[shape], dtype)
    jt, tt = jax_q.quantize_fp8(jx), q.quantize_fp8(tx)
    assert tt.values.dtype == torch.float8_e4m3fn and tt.shape == jt.shape
    np.testing.assert_array_equal(_bits(tt.values), _bits(jt.values))
    np.testing.assert_array_equal(_bits(tt.scale), _bits(jt.scale))
    np.testing.assert_array_equal(_bits(q.dequantize_fp8(tt)),
                                  _bits(jax_q.dequantize_fp8(jt)))


# (shape, group size asked for, the group size the search settles on):
# whole groups of 128, 512 and 2048; 1961 = 37 x 53 values leave the loop
# at 148 (1961 has no divisor that is a multiple of 4, so it pads to 4:
# "pad4"); 4103 values with groups of 512 search down to 4 and pad too;
# 64 x 30 = 1920 searches 512 down to 480 ("search")
FP6_CASES = {"g128": ((64, 256), 128, 128), "g512": ((64, 256), 512, 512),
             "g2048": ((64, 256), 2048, 2048),
             "search": ((64, 30), 512, 480),
             "pad4": ((37, 53), 128, 4), "pad4_flat": ((4103,), 512, 4)}


@pytest.mark.parametrize("case", list(FP6_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp6_matches_jax(case, dtype):
    shape, gs, want_gs = FP6_CASES[case]
    jx, tx = _inputs(shape, dtype, seed=1)
    jt, tt = jax_q.quantize_fp6(jx, group_size=gs), q.quantize_fp6(
        tx, group_size=gs)
    assert tt.group_size == jt.group_size == want_gs
    assert tt.values.dtype == torch.uint8 and tt.scale.dtype == torch.float32
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_array_equal(_bits(tt.scale), _bits(jt.scale))
    got = q.dequantize_fp6(tt)
    assert got.shape == tuple(shape) and got.dtype == tx.dtype
    np.testing.assert_array_equal(_bits(got), _bits(jax_q.dequantize_fp6(jt)))


def test_fp6_edge_values_match_jax():
    """One group whose absmax is FP6_MAX (scale 1: values are their own
    scaled values): 0 and -0-ish, powers of two, the subnormal boundary
    and just under it, subnormal and normal rounding ties (half to even),
    mantissa overflows that bump the exponent, the top of the range, and
    random values."""
    edge = [0.0, -1e-9, 28.0, -28.0, 1.0, 2.0, 4.0, 16.0, 0.5, 0.25,
            0.2499, 0.0625, 0.125, 0.1875, 0.03125, 0.09375, 0.15625,
            1.125, 1.375, -1.625, 1.875, 1.9, 3.9, 7.9, 15.9, 27.9, 26.0,
            22.0, 24.0, -0.24, 0.3, 6.5]
    rng = np.random.default_rng(4)
    x = np.concatenate([edge, rng.uniform(-28, 28, size=64 - len(edge))])
    x = x.astype(np.float32)
    jt = jax_q.quantize_fp6(jnp.asarray(x), group_size=64)
    tt = q.quantize_fp6(torch.from_numpy(x), group_size=64)
    assert float(tt.scale[0, 0]) == 1.0
    np.testing.assert_array_equal(tt.values.numpy(), np.asarray(jt.values))
    np.testing.assert_array_equal(_bits(q.dequantize_fp6(tt)),
                                  _bits(jax_q.dequantize_fp6(jt)))
    # the grid itself: every code decodes to its e3m2 value
    codes = torch.arange(32, dtype=torch.uint8)
    np.testing.assert_array_equal(
        q._fp6_decode(codes).numpy(),
        np.asarray(jax_q._fp6_decode(jnp.arange(32, dtype=jnp.uint8))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_weight_matches_quantize_param_tree(dtype):
    jw, _ = _inputs((96, 48), dtype, seed=2)       # flax [in, out]
    qt, _, _ = jax_iq.quantize_param_tree({"kernel": jw}, "w8a8",
                                          min_size=1)
    jv, js = qt["kernel"].arrays
    v, s = q.quantize_per_channel(_torch(jw).t().contiguous())
    assert v.dtype == torch.int8 and v.shape == (48, 96)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv).T)
    np.testing.assert_array_equal(_bits(s), _bits(js))
    # v1's expansion of a w8a8 weight: the w8a8 branch of
    # dequantize_param_tree, one scale an output channel
    want = jax_iq.dequantize_param_tree(qt)["kernel"]
    np.testing.assert_array_equal(
        _bits(q.dequant_scaled(v, s, getattr(torch, dtype)).t()), _bits(want))


@pytest.mark.parametrize("M", [1, 16, 17])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_w8a8_linear_matches_dot_general(M, dtype):
    """Exactly ``w8a8_dot_general``: a zero row (sx 0, quotients by the
    1e-12 floor) and, from 2 rows, an inf row (its quotients NaN, cast to
    0; its outputs NaN in both)."""
    rng = np.random.default_rng(M)
    K, N = 64, 48
    x = rng.standard_normal((M, K)).astype(np.float32)
    x[0] = 0.0
    if M > 1:
        x[1, 5] = np.inf
    w = rng.standard_normal((K, N)).astype(np.float32)
    qt, _, _ = jax_iq.quantize_param_tree(
        {"kernel": jnp.asarray(w, getattr(jnp, dtype))}, "w8a8", min_size=1)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jax_iq.w8a8_dot_general(jx, qt["kernel"],
                                   (((1,), (0,)), ((), ())))
    jv, js = qt["kernel"].arrays
    before = (q.w8a8_quant_rows.launches, q.w8a8_gemm.launches)
    got = q.w8a8_linear(_torch(jx), _torch(jv).t().contiguous(), _torch(js))
    assert (q.w8a8_quant_rows.launches, q.w8a8_gemm.launches) == before
    assert got.dtype == getattr(torch, dtype) and got.shape == (M, N)
    _same(got, want)
    out = np.asarray(want, np.float32)
    assert (out[0] == 0).all() and (M == 1 or np.isnan(out[1]).all())
    # and as the model's W8A8Linear, through a leading batch axis
    lin = iq.W8A8Linear("w8a8", (_torch(jv).t().contiguous(), _torch(js)),
                        (K, N), getattr(torch, dtype), None)
    _same(lin(_torch(jx)[None])[0], want)


def test_int8_product_is_exact():
    """The plain product's float64 sums stay exact at the widest K the
    models use, where fp32 sums would not (127^2 x 14336 > 2^24)."""
    K = 14336
    xq = torch.full((2, K), 127, dtype=torch.int8)
    xq[1, ::2] = -127
    v = torch.full((3, K), 127, dtype=torch.int8)
    v[2, 1::2] = -1
    acc = q.int8_product_reference(xq, v)
    want = (xq.long() @ v.long().t()).to(torch.int32)
    assert torch.equal(acc, want) and acc[0, 0] == 127 * 127 * K


@pytest.mark.parametrize("wrapper", ["dequant_scaled", "dequantize_fp6",
                                     "w8a8_quant_rows", "w8a8_gemm"])
def test_wrappers_never_take_the_plain_path_off_the_cpu(wrapper,
                                                        monkeypatch):
    """A tensor that is not on the CPU (the meta device, which needs no
    GPU) makes the wrapper launch its kernel or raise, never run the plain
    version."""
    def plain(*a, **k):
        raise AssertionError("took the plain path")

    for name in ("dequant_scaled_reference", "dequantize_fp6_reference",
                 "w8a8_quant_rows_reference", "w8a8_linear_reference"):
        monkeypatch.setattr(q, name, plain)
    meta = dict(device="meta")
    calls = {
        "dequant_scaled": lambda: q.dequant_scaled(
            torch.empty(8, 16, dtype=torch.float8_e4m3fn, **meta),
            torch.empty((), **meta), torch.bfloat16),
        "dequantize_fp6": lambda: q.dequantize_fp6(q.FP6Tensor(
            torch.empty(2, 96, dtype=torch.uint8, **meta),
            torch.empty(2, 1, **meta), (2, 128), torch.bfloat16, 128)),
        "w8a8_quant_rows": lambda: q.w8a8_quant_rows(
            torch.empty(4, 64, **meta)),
        "w8a8_gemm": lambda: q.w8a8_gemm(
            torch.empty(4, 64, **meta),
            torch.empty(8, 64, dtype=torch.int8, **meta),
            torch.empty(8, **meta))}
    with pytest.raises(ValueError, match="cuda or cpu"):
        calls[wrapper]()


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError, match="int8 or float8_e4m3fn"):
        q.dequant_scaled(torch.zeros(4, 4), torch.ones(()), torch.float32)
    with pytest.raises(ValueError, match="neither one value"):
        q.dequant_scaled(torch.zeros(4, 4, dtype=torch.int8),
                         torch.ones(3), torch.float32)
    with pytest.raises(ValueError, match="cannot hold"):
        q.dequantize_fp6(q.FP6Tensor(torch.zeros(2, 3, dtype=torch.uint8),
                                     torch.ones(2, 1), (100,),
                                     torch.float32, 4))
    with pytest.raises(ValueError, match="s must be"):
        q.w8a8_gemm(torch.zeros(2, 16), torch.zeros(4, 16, dtype=torch.int8),
                    torch.ones(3))
    with pytest.raises(ValueError, match="v must be"):
        q.w8a8_gemm(torch.zeros(2, 16), torch.zeros(4, 8, dtype=torch.int8),
                    torch.ones(4))


# llama3-8b's Linears as (N, K): q/o, k/v, gate/up, down and the head
LLAMA3_8B_LINEARS = [(4096, 4096), (1024, 4096), (14336, 4096),
                     (4096, 14336), (128256, 4096)]


@pytest.mark.parametrize("N,K", LLAMA3_8B_LINEARS)
def test_w8a8_plan_covers_each_linear(N, K):
    """At every row count up to a 528-row fused tick: up to 64 rows one
    token tile holds every row and one block an SM takes a share of the
    work (never more blocks than units of it); above, 128- or 256-token
    tiles hold the rows, the K ranges tile K exactly in whole 128-byte
    panels, the grid's y (the K ranges) stays under CUDA's 65,535, and a
    grid whose tiles are shared fits the card's SMs at once."""
    for M in list(range(1, 130)) + [255, 256, 257, 512, 528]:
        p = q.w8a8_plan(M, N, K)
        assert p.tiles == -(-N // 128)
        assert p.tn * p.token_tiles >= M > p.tn * (p.token_tiles - 1)
        if M <= q.W8A8_STREAM_MAX_ROWS:
            assert p.tn in (16, 32, 64) and p.token_tiles == 1
            assert p.ksplit == 1
            assert p.blocks == min(132, p.tiles * -(-K // 128))
        else:
            assert p.tn == (128 if M <= 128 else 256)
            assert p.kr % 128 == 0 and p.ksplit * p.kr >= K > (
                p.ksplit - 1) * p.kr and 1 <= p.ksplit <= 65535
            assert p.blocks == p.tiles * p.ksplit * p.token_tiles
            assert p.ksplit == 1 or (p.blocks <= 132 and p.kr >= 1024)


def _gemm_as_the_kernel(x, v, s, plan, rng):
    """What ``csrc/w8a8_gemm.cu`` computes, block by block as ``plan``
    cuts the call, in plain torch: each row's max over |x|'s bits, taken
    over the row's slices in a shuffled order; each row quantized by the
    one divisor; each block's exact int32 partial of each tile it touches
    (up to 64 rows: block b takes units [b U / G, (b + 1) U / G) of the
    tiles' 128-byte K panels, tile by tile; above: a block a tile and K
    range); a tile's partials summed in a shuffled order; then
    (float(acc) * sx) * s, cast."""
    M, K = x.shape
    N = v.shape[0]
    bits = x.float().abs().view(torch.int32)   # ordered as the floats
    slices = [bits[:, k:k + 128].amax(dim=1) for k in range(0, K, 128)]
    mx = functools.reduce(torch.maximum,
                          [slices[i] for i in rng.permutation(len(slices))])
    sx = mx.view(torch.float32) / torch.tensor(127.0)
    d = torch.where(sx < 1e-12, torch.tensor(1e-12), sx)  # keeps a NaN
    t = torch.round(x.float() / d[:, None])
    xq = torch.where(t != t, 0.0, t.clamp(-127, 127)).to(torch.int32)
    P = -(-K // 128)
    if plan.tn <= q.W8A8_STREAM_MAX_ROWS:   # (tile, first, end panel)
        U, G = plan.tiles * P, plan.blocks
        pieces = []
        for b in range(G):
            u = b * U // G
            while u < (b + 1) * U // G:
                end = min((u // P + 1) * P, (b + 1) * U // G)
                pieces.append((u // P, u % P, (end - 1) % P + 1))
                u = end
    else:
        per = plan.kr // 128
        pieces = [(t, k, min(P, k + per)) for t in range(plan.tiles)
                  for k in range(0, P, per)]
    partials = {}
    for tile, k0, k1 in pieces:
        ch = slice(tile * 128, min(N, (tile + 1) * 128))
        ks = slice(k0 * 128, k1 * 128)
        partials.setdefault(tile, []).append(
            (xq[:, ks].long() @ v[ch, ks].long().t()).to(torch.int32))
    acc = torch.empty(M, N, dtype=torch.int32)
    for tile, parts in partials.items():
        acc[:, tile * 128:min(N, (tile + 1) * 128)] = functools.reduce(
            torch.add, [parts[i] for i in rng.permutation(len(parts))])
    return ((acc.float() * sx[:, None]) * s).to(x.dtype)


@pytest.mark.parametrize("M", [1, 16, 80, 300])
def test_w8a8_gemm_blocks_match_dot_general(M):
    """The GEMM kernel's arithmetic as ``w8a8_plan`` cuts the call
    (up to 64 rows: 12 units of work, 3 tiles x 4 panels, the last 80
    values short of a panel, over a card of 5 SMs, so tiles are shared
    by 2 blocks; at 80 rows a 128-token tile, at 300 rows two 256-token
    tiles, a block a tile) equals
    ``w8a8_dot_general`` bit for bit, with a zero row, an inf row and a
    NaN row, whatever the order of the slices' maxima and of the
    partials."""
    rng = np.random.default_rng(100 + M)
    K, N = 464, 328
    x = rng.standard_normal((M, K)).astype(np.float32)
    x *= rng.uniform(0.01, 3.0, size=(M, 1)).astype(np.float32)
    x[0] = 0.0
    if M > 2:
        x[1, 7] = np.inf
        x[2, 300] = np.nan
    w = rng.standard_normal((K, N)).astype(np.float32)
    qt, _, _ = jax_iq.quantize_param_tree(
        {"kernel": jnp.asarray(w, jnp.bfloat16)}, "w8a8", min_size=1)
    jx = jnp.asarray(x, jnp.bfloat16)
    want = jax_iq.w8a8_dot_general(jx, qt["kernel"],
                                   (((1,), (0,)), ((), ())))
    jv, js = qt["kernel"].arrays
    v, s = _torch(jv).t().contiguous(), _torch(js)
    plan = q.w8a8_plan(M, N, K, sms=5)
    assert (plan.tn, plan.blocks, plan.ksplit) == (
        (16, 5, 1) if M <= 16 else (128, 3, 1) if M <= 128 else (256, 6, 1))
    for _ in range(3):
        _same(_gemm_as_the_kernel(_torch(jx), v, s, plan, rng), want)
