"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA GPU: a CUDA
kernel has no CPU mode.  The file imports only torch and the port, so it
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

Kernels: the flash-attention forward (``flash_fwd.cu``: S and Sk off
the 128-row tiles, Sk above and below S, groups of 1, 4 and 8, D 64 and
128, [B,S,H,D] views, and a tensor map TMA refuses), its backward
(``flash_bwd.cu``: dQ and dK/dV, GQA, tails, Sk != S, rows that see no
key, more units than SMs, two calls bit-identical), a CUDA call at a head
dim the kernels do not take (it raises, naming ROADMAP B1d), the fused Adam and Lion steps (``fused_adam.cu``: L2 and AdamW, the
overflow skip, bf16 and fp16 working copies), and ragged paged attention
over bf16, fp32, int8 and e4m3 pages (``ragged_paged_attn.cu``) at the v2
path's shapes: decode, mixed decode and prefill, a sliding window,
page-table holes, D=64 with 16-row pages, 128-row pages with 8 q heads per
KV head, MHA with padding tokens, and on the split-KV decode path kv_len at
a split boundary and one key past it, one 2048-key sequence among 1-key
ones, a window across splits, holes that empty a whole split, D=64 with
16- and 128-row pages, group 1 at D 128 (16 heads over 16, the
Qwen1.5-MoE shape) at decode and mixed, and two calls bit-identical;
with the
long-context scan's incoming carry (neutral, and random with some rows
neutral) at its shapes, a 4096-key table with its middle parked as
holes: a decode row (many splits, most of them holes only), a 64-token
prefill page (one split, so the carry alone sends it through the
combine), four ragged decode rows with their own holes, a row that sees
no resident key and returns the carry, fp32 queries, the neutral carry
bit-identical to no carry, and a malformed carry refused; and group-wise
int8
quantize and
dequantize (``quantization.cu``) at the int8 serving path's shapes
(``gate_proj`` at groups of 128 and 2048, the embedding table), at groups
of 32, 64, 256 and 4096, 4 bits at 2048, fp16 input, n off a whole tile,
tails, and an input one value off 16 bytes, symmetric and asymmetric,
bf16 and fp32; and the serving weight formats' kernels
(``weight_formats.cu``): K1 over e4m3 and over int8 with a scale a row,
K2 (fp6) at groups of 128, 2048 and a searched size; and the W8A8
Linear (``w8a8_gemm.cu``: the row pre-pass, then the GEMM over one token
tile up to 128 rows, over 256-token tiles above) at 1, 16, 17, 80 and
512 rows at ``gate_proj``,
``down_proj`` and ``k_proj``, ``lm_head`` at 16 rows, bf16, fp16 and
fp32, with a zero, an inf and a NaN row, N off the 128-channel tile, K
off the 128-byte panel, and the named refusal of K off 16.  Last, the
``torch.profiler`` reader (``telemetry/profiler.py``) over a CUDA run.
An MoE expert bank quantized to int8, fp8 and fp6 expands through #7,
K1 and K2 bit-identically to their plain versions, one launch each.

Tolerances: bf16 flash outputs 2e-2 (p and o round to bf16 at 2^-8
relative, in different places in the kernel and the plain version); bf16
flash gradients 3e-3 absolute plus 2e-2 relative (P and dS round to bf16
from fp32 values summed in another order, and each side rounds the
gradient to bf16 once: one ulp is 2^-8 relative; the absolute part sits an
order under the gradients' median size); fp32 gradients 2e-4 (full fp32 products over
up to 200 keys, another order); optimizer steps 1e-6 relative (fp32
elementwise, the kernel contracts multiply-adds into FMAs); bf16 paged outputs 2e-3 absolute plus 2e-2 relative (K and V are O(1), so |o|
is ~0.04 at 2048 keys and the absolute part stays under it); fp32 outputs
1e-4 (full fp32 products, another summation order); lse 2e-3 absolute;
quantize, dequantize and the weight formats' kernels none: payload,
scales and output must be bit-identical to the plain version (IEEE
division, rint, no FMA; the int8 product is exact).
"""
import pytest
import torch

from deepspeed_tpu_torch.inference.paged import PagedKVPool
from deepspeed_tpu_torch.ops import flash_attention as fa


@pytest.fixture
def cuda():
    # decided inside the test run, never at import: every xdist worker
    # must collect the same tests
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernel has no CPU mode")
    return torch.device("cuda")


def _qkv(seed, B, H, Hkv, S, Sk, D, dtype, device, kv_view=False):
    """q as the model hands it in: a [B,S,H,D] projection seen as
    [B,H,S,D]; k and v contiguous [B,Hkv,Sk,D], or [B,Sk,Hkv,D] views."""
    g = torch.Generator().manual_seed(seed)
    q = torch.randn(B, S, H, D, generator=g).to(device, dtype).transpose(1, 2)
    if kv_view:
        k, v = (torch.randn(B, Sk, Hkv, D, generator=g).to(
            device, dtype).transpose(1, 2) for _ in range(2))
    else:
        k = torch.randn(B, Hkv, Sk, D, generator=g).to(device, dtype)
        v = torch.randn(B, Hkv, Sk, D, generator=g).to(device, dtype)
    return q, k, v


# B, H, Hkv, S, Sk, D, causal, kv_view.  The bf16 kernel walks 128-row q
# tiles over 128-key tiles: S and Sk at 1, 63, 129, 1000 leave ragged
# tiles; groups of 1, 4 and 8
FWD_SHAPES = [
    (2, 4, 2, 100, 130, 128, True, False),    # Sk > S, ragged causal edge
    (2, 4, 2, 130, 100, 64, True, False),     # Sk < S: rows that see no key
    (1, 8, 8, 64, 64, 64, False, False),      # one partial tile, not causal
    (1, 8, 8, 1, 1, 64, True, True),          # one row, one key
    (2, 8, 2, 1, 1000, 128, True, True),      # one query row over 1000 keys
    (1, 8, 1, 63, 63, 64, False, False),      # group of 8
    (1, 8, 2, 129, 129, 128, True, True),     # one row past a tile
    (1, 8, 1, 129, 400, 64, True, False),     # Sk - S = 271: over two tiles
    (2, 16, 4, 1000, 1000, 128, True, True),  # the serving shape's tails
    (1, 16, 2, 1000, 1000, 64, False, True),
    (1, 4, 1, 1000, 129, 128, True, False),   # 871 rows see no key
    (1, 4, 4, 300, 1000, 128, False, True),   # Sk > S, not causal
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", FWD_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_kernel_matches_plain(cuda, shape, dtype):
    dt = getattr(torch, dtype)
    B, H, Hkv, S, Sk, D, causal, kv_view = shape
    q, k, v = _qkv(sum(shape), B, H, Hkv, S, Sk, D, dt, cuda, kv_view)
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
def test_tensor_map_refusal_raises_and_launches_nothing(cuda):
    q, k, v = _qkv(0, 1, 2, 2, 64, 64, 64, torch.bfloat16, cuda)
    # a size-1 batch dim may carry any stride; TMA refuses one of 2^41
    # elements (2^42 bytes, past its 2^40 limit)
    far = q.as_strided(q.shape, (2 ** 41, *q.stride()[1:]))
    before = fa.flash_fwd.launches
    with pytest.raises(RuntimeError, match="cuTensorMapEncodeTiled.*q"):
        fa.flash_fwd(far, k, v)
    assert fa.flash_fwd.launches == before


def paged_case(seed, q_lens, kv_lens, H=32, Hkv=8, D=128, page=64,
               qdtype=torch.bfloat16, pdtype=torch.bfloat16, holes=False,
               pad=0, device="cuda", hole_cols=None):
    """q, a pool holding just the pages the sequences use (plus the trash
    page 0, in a shuffled order), scales for 1-byte pages, and the tick's
    metadata.  K and V are standard normal for every page type.  ``holes``
    marks every other page before a sequence's first query token -1;
    ``hole_cols`` lists each sequence's columns to mark -1; ``pad`` adds
    padding tokens after the last."""
    g = torch.Generator().manual_seed(seed)
    S = len(q_lens)
    cols = [-(-kv // page) for kv in kv_lens]
    pp = max(cols)
    n_pages = 1 + sum(cols)
    ids = (torch.randperm(n_pages - 1, generator=g) + 1).tolist()
    table = torch.full((S, pp), -1, dtype=torch.int32)
    for j, c in enumerate(cols):
        table[j, :c] = torch.tensor(ids[:c], dtype=torch.int32)
        ids = ids[c:]
        if holes:
            first_q = (kv_lens[j] - q_lens[j]) // page
            table[j, 1:first_q:2] = -1
        if hole_cols is not None:
            table[j, list(hole_cols[j])] = -1
    kv = torch.randn(n_pages, page, 2 * Hkv, D, generator=g)
    scales = None
    if pdtype in (torch.int8, torch.float8_e4m3fn):
        # quantized as the pool's own write does: scale = row absmax / qmax
        pool = PagedKVPool(n_pages, page, Hkv, D,
                           "int8" if pdtype == torch.int8 else "fp8",
                           qdtype, "cpu")
        rows = kv.view(n_pages * page, 2 * Hkv, D)
        pool.write(rows[:, 0::2], rows[:, 1::2],
                   torch.arange(n_pages * page))
        pages, scales = pool.pages, pool.scales.to(device)
    else:
        pages = kv.to(pdtype)
    T = sum(q_lens) + pad
    q = torch.randn(T, H, D, generator=g).to(device, qdtype)
    cu = torch.zeros(S + 1, dtype=torch.int32)
    cu[1:] = torch.cumsum(torch.tensor(q_lens), 0)
    meta = (torch.tensor(kv_lens, dtype=torch.int32).to(device),
            table.to(device), cu.to(device),
            torch.tensor([S], dtype=torch.int32).to(device))
    return q, pages.to(device), scales, meta


# (q_lens, kv_lens, options): the kernel phase's shapes, scaled down
PAGED_CASES = {
    "decode": ([1] * 16, [128 + 120 * j for j in range(16)], {}),
    "mixed": ([1] * 8 + [512], [300 + 150 * j for j in range(8)] + [1500],
              {}),
    "window": ([1] * 8 + [512], [300 + 150 * j for j in range(8)] + [1500],
               {"window": 256}),
    "holes": ([1] * 4 + [100], [700, 900, 1000, 1300, 1400],
              {"holes": True}),
    "d64_page16": ([1] * 4 + [70], [40, 90, 130, 200, 300],
                   {"D": 64, "page": 16, "pad": 9}),
    "page128_gqa8": ([3, 1, 40], [200, 129, 300],
                     {"H": 64, "Hkv": 8, "page": 128}),
    "page32_mha": ([1, 33], [50, 97], {"H": 4, "Hkv": 4, "page": 32,
                                       "pad": 5}),
    # the split-KV decode path (ops/ragged_paged_attention.split_plan):
    # kv_len at a split boundary and one key past it (128-key splits here)
    "split_boundary": ([1] * 4, [256, 257, 512, 513], {}),
    "one_long_among_short": ([1] * 8, [1] * 7 + [2048], {}),
    "window_across_splits": ([1] * 16, [128 + 120 * j for j in range(16)],
                             {"window": 300}),
    # one sequence: 64-key splits, so each hole page is a whole split
    "holes_empty_a_split": ([1], [1000], {"holes": True}),
    "d64_page16_decode": ([1] * 6, [100 * (j + 1) for j in range(6)],
                          {"D": 64, "H": 16, "Hkv": 4, "page": 16}),
    "d64_page128": ([1] * 5 + [20], [150 * (j + 1) for j in range(6)],
                    {"D": 64, "H": 16, "Hkv": 4, "page": 128, "pad": 2}),
    # group 1 at D 128 (qwen1.5-moe-a2.7b: H 16 over Hkv 16, 64-token q
    # tiles): the decode block's rows and a tick's 512-token chunk
    "group1_h16_decode": ([1] * 16, [128 + 90 * j for j in range(16)],
                          {"H": 16, "Hkv": 16}),
    "group1_h16_mixed": ([1] * 8 + [512],
                         [200 + 150 * j for j in range(8)] + [1100],
                         {"H": 16, "Hkv": 16, "pad": 3}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(PAGED_CASES))
@pytest.mark.parametrize("pdtype", ["bfloat16", "int8", "float8_e4m3fn"])
def test_paged_kernels_match_plain(cuda, case, pdtype):
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    q_lens, kv_lens, opt = PAGED_CASES[case]
    opt = dict(opt)
    window = opt.pop("window", None)
    pdt = getattr(torch, pdtype)
    q, pages, scales, meta = paged_case(len(case), q_lens, kv_lens,
                                        pdtype=pdt, device=cuda, **opt)
    sm = q.shape[-1] ** -0.5
    fn = rpa.ragged_paged_attention_quant if scales is not None \
        else rpa.ragged_paged_attention
    extra = () if scales is None else (scales,)
    before = fn.launches
    out = fn(q, pages, *extra, *meta, sm_scale=sm, sliding_window=window)
    assert fn.launches == before + 1
    want = fn(q.cpu(), pages.cpu(), *(e.cpu() for e in extra),
              *(m.cpu() for m in meta), sm_scale=sm, sliding_window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float().cpu(), want.float(), atol=2e-3,
                               rtol=2e-2)
    n_real = int(meta[2][-1])
    assert (out[n_real:] == 0).all()


@pytest.mark.gpu
@pytest.mark.parametrize("pdtype", ["bfloat16", "int8", "float8_e4m3fn"])
def test_paged_kernels_are_bit_identical_twice(cuda, pdtype):
    """No atomics: each split writes its own stats and the combine folds
    them in split order, so two identical calls give the same bits."""
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    q_lens, kv_lens, _ = PAGED_CASES["decode"]
    q, pages, scales, meta = paged_case(3, q_lens, kv_lens,
                                        pdtype=getattr(torch, pdtype),
                                        device=cuda)
    S, pp = meta[1].shape
    assert rpa.split_plan(q.shape[0], S, 32, 8, pp, 64)[0] > 1
    fn = rpa.ragged_paged_attention_quant if scales is not None \
        else rpa.ragged_paged_attention
    extra = () if scales is None else (scales,)
    first = fn(q, pages, *extra, *meta, sm_scale=0.1)
    second = fn(q, pages, *extra, *meta, sm_scale=0.1)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.gpu
@pytest.mark.parametrize("pdtype", ["float32", "int8", "float8_e4m3fn"])
def test_paged_kernels_fp32_match_plain(cuda, pdtype):
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    pdt = getattr(torch, pdtype)
    q, pages, scales, meta = paged_case(
        5, [1, 1, 37], [65, 200, 150], H=8, Hkv=2, page=16,
        qdtype=torch.float32, pdtype=pdt, pad=3, device=cuda)
    extra = () if scales is None else (scales,)
    fn = rpa.ragged_paged_attention_quant if scales is not None \
        else rpa.ragged_paged_attention
    out = fn(q, pages, *extra, *meta, sm_scale=0.1, sliding_window=50)
    want = fn(q.cpu(), pages.cpu(), *(e.cpu() for e in extra),
              *(m.cpu() for m in meta), sm_scale=0.1, sliding_window=50)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.cpu(), want, atol=1e-4, rtol=1e-4)


def random_carry(seed, T, H, D, device):
    """Raw flash stats (m, l, acc) with every third row neutral."""
    from deepspeed_tpu_torch.inference.paged import neutral_carry

    g = torch.Generator().manual_seed(seed)
    m, l, acc = neutral_carry(T, H, D)
    live = (torch.arange(T) % 3 != 2)[:, None]
    m = torch.where(live, torch.randn(T, H, generator=g), m)
    l = torch.where(live, torch.rand(T, H, generator=g) + 0.5, l)
    acc = torch.where(live[..., None], torch.randn(T, H, D, generator=g),
                      acc)
    return tuple(x.to(device) for x in (m, l, acc))


_LC_HOLES = range(1, 53)      # a 64-page table: columns 0, 53..63 resident
# (q_lens, kv_lens, hole columns per sequence, options)
CARRY_CASES = {
    "lc_decode": ([1], [4096], [_LC_HOLES], {}),
    "lc_prefill_page": ([64], [4096], [_LC_HOLES], {}),
    "lc_ragged": ([1, 1, 1, 1], [4096, 3000, 2500, 1800],
                  [_LC_HOLES, range(1, 40), range(2, 30, 2), ()], {}),
    # sequence 0's only key left is parked: its row returns the carry
    "no_resident_key": ([1, 5], [64, 600], [[0], [2, 3]],
                        {"pad": 2}),
    "window_d64": ([1, 20], [2000, 1500], [range(3, 20), range(5, 9)],
                   {"D": 64, "H": 16, "Hkv": 4, "page": 16,
                    "window": 700}),
}


@pytest.mark.gpu
@pytest.mark.parametrize("case", list(CARRY_CASES))
@pytest.mark.parametrize("kind", ["neutral", "random"])
@pytest.mark.parametrize("qdtype,pdtype", [
    ("bfloat16", "bfloat16"), ("bfloat16", "int8"),
    ("bfloat16", "float8_e4m3fn"), ("float32", "float32"),
    ("float32", "int8")])
def test_paged_kernels_with_carry_match_plain(cuda, case, kind, qdtype,
                                              pdtype):
    from deepspeed_tpu_torch.inference.paged import neutral_carry
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    q_lens, kv_lens, hole_cols, opt = CARRY_CASES[case]
    opt = dict(opt)
    window = opt.pop("window", None)
    qdt, pdt = getattr(torch, qdtype), getattr(torch, pdtype)
    q, pages, scales, meta = paged_case(len(case), q_lens, kv_lens,
                                        qdtype=qdt, pdtype=pdt, device=cuda,
                                        hole_cols=hole_cols, **opt)
    T, H, D = q.shape
    carry = (neutral_carry(T, H, D, device=cuda) if kind == "neutral"
             else random_carry(len(case), T, H, D, cuda))
    sm = D ** -0.5
    fn = rpa.ragged_paged_attention_quant if scales is not None \
        else rpa.ragged_paged_attention
    extra = () if scales is None else (scales,)
    before = fn.launches
    out = fn(q, pages, *extra, *meta, sm_scale=sm, sliding_window=window,
             carry=carry)
    assert fn.launches == before + 1
    want = fn(q.cpu(), pages.cpu(), *(e.cpu() for e in extra),
              *(m.cpu() for m in meta), sm_scale=sm, sliding_window=window,
              carry=tuple(c.cpu() for c in carry))
    torch.cuda.synchronize()
    tol = (1e-4, 1e-4) if qdt == torch.float32 else (2e-3, 2e-2)
    torch.testing.assert_close(out.float().cpu(), want.float(), atol=tol[0],
                               rtol=tol[1])
    assert torch.isfinite(out.float()).all()
    n_real = int(meta[2][-1])
    assert (out[n_real:] == 0).all()
    if kind == "neutral":       # the neutral carry folds exactly
        plain = fn(q, pages, *extra, *meta, sm_scale=sm,
                   sliding_window=window)
        assert torch.equal(out, plain)


@pytest.mark.gpu
def test_paged_kernel_refuses_a_malformed_carry(cuda):
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    q, pages, _, meta = paged_case(0, [1], [10], page=64, device=cuda)
    T, H, D = q.shape
    m, l, acc = random_carry(0, T, H, D, cuda)
    before = rpa.ragged_paged_attention.launches
    for bad in ((m, l), (m, l, acc[..., :64]), (m.half(), l, acc),
                (m.cpu(), l, acc)):
        with pytest.raises(ValueError, match="carry|one device"):
            rpa.ragged_paged_attention(q, pages, *meta, sm_scale=0.1,
                                       carry=bad)
    assert rpa.ragged_paged_attention.launches == before


@pytest.mark.gpu
def test_paged_kernel_raises_instead_of_falling_back(cuda):
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    q, pages, _, meta = paged_case(0, [1], [10], page=64, device=cuda)
    before = rpa.ragged_paged_attention.launches
    with pytest.raises(ValueError, match="page size"):
        rpa.ragged_paged_attention(q, pages[:, :48].contiguous(), *meta,
                                   sm_scale=0.1)
    strided = torch.empty(*q.shape[:2], 2 * q.shape[2], dtype=q.dtype,
                          device=cuda)[..., :q.shape[2]]
    strided.copy_(q)
    with pytest.raises(ValueError, match="contiguous"):
        rpa.ragged_paged_attention(strided, pages, *meta, sm_scale=0.1)
    assert rpa.ragged_paged_attention.launches == before


@pytest.mark.gpu
def test_kernel_raises_instead_of_falling_back(cuda):
    q, k, v = _qkv(0, 1, 2, 2, 16, 16, 64, torch.bfloat16, cuda)
    misaligned = torch.empty(1, 2, 16, 65, dtype=torch.bfloat16,
                             device=cuda)[..., 1:]
    before = fa.flash_fwd.launches
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_fwd(misaligned, k, v)
    assert fa.flash_fwd.launches == before


# B, H, Hkv, S, Sk, D, causal
BWD_SHAPES = [
    (2, 4, 2, 100, 100, 64, True),     # q and key tails, GQA 2
    (1, 8, 1, 130, 100, 128, True),    # Sk < S: rows that see no key, GQA 8
    (1, 4, 4, 64, 200, 64, True),      # Sk > S, bottom-right diagonal
    (1, 8, 2, 96, 96, 128, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_flash_bwd_kernels_match_plain(cuda, shape, dtype):
    dt = getattr(torch, dtype)
    B, H, Hkv, S, Sk, D, causal = shape
    q, k, v = _qkv(sum(shape) + 1, B, H, Hkv, S, Sk, D, dt, cuda)
    g = torch.Generator().manual_seed(7)
    # dO in the layout the o_proj backward gives: [B,S,H,D] seen as [B,H,S,D]
    do = torch.randn(B, S, H, D, generator=g).to(cuda, dt).transpose(1, 2)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    before = (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    assert (fa.flash_bwd_dq.launches, fa.flash_bwd_dkv.launches) == (
        before[0] + 1, before[1] + 1)
    want = fa.flash_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    # bf16: rtol covers one ulp where the two round a gradient apart;
    # atol sits an order under the gradients' size (chip_smoke.py)
    atol, rtol = (3e-3, 2e-2) if dt == torch.bfloat16 else (2e-4, 2e-4)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        assert a.dtype == dt and a.shape == b.shape, name
        torch.testing.assert_close(a.float(), b.float(), atol=atol,
                                   rtol=rtol, msg=name)
    if causal and Sk < S:
        assert (got[0][:, :, :S - Sk] == 0).all()


# GPT-2's attention: q, k and v strided [B, H, S, D] views into one
# [B, S, 3E] c_attn output (a row stride of 3E, no copy), one KV head per
# query head, D 64, causal; the forward and the backward through
# flash_attention's autograd, at phase 2's and phase 8's limits.
# B, H, S: a ragged tail at GPT-2 small's 12 heads, and 32 heads (1.3b)
MHA_SHAPES = [(2, 12, 300), (1, 32, 1030)]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", MHA_SHAPES)
def test_fused_qkv_views_mha_d64_match_plain(cuda, shape):
    B, H, S = shape
    D, E = 64, shape[1] * 64
    g = torch.Generator().manual_seed(sum(shape))
    qkv = torch.randn(B, S, 3 * E, generator=g).to(cuda, torch.bfloat16)
    qkv.requires_grad_()
    q, k, v = (t.view(B, S, H, D).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    assert q.stride() == (S * 3 * E, D, 3 * E, 1)
    before = [c.launches for c in (fa.flash_fwd, fa.flash_bwd_dq,
                                   fa.flash_bwd_dkv)]
    o = fa.flash_attention(q, k, v, causal=True)
    do = torch.randn(B, S, H, D, generator=g).to(
        cuda, torch.bfloat16).transpose(1, 2)
    (got,) = torch.autograd.grad(o, qkv, do)
    assert [c.launches - b for c, b in zip(
        (fa.flash_fwd, fa.flash_bwd_dq, fa.flash_bwd_dkv), before)] == \
        [1, 1, 1]
    qd, kd, vd = (t.detach() for t in (q, k, v))
    ro, rlse = fa.flash_fwd_reference(qd, kd, vd, causal=True)
    want = fa.flash_bwd_reference(qd, kd, vd, o.detach(), rlse, do,
                                  causal=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(o.detach().float(), ro.float(), atol=2e-2,
                               rtol=2e-2)
    for name, a, b in zip(("dq", "dk", "dv"), got.split(E, dim=-1), want):
        torch.testing.assert_close(
            a.view(B, S, H, D).transpose(1, 2).float(), b.float(),
            atol=3e-3, rtol=2e-2, msg=name)


# The TMA/wgmma bf16 kernels' own paths, same limits: more units than the
# card has SMs with q and key tails off the 128-row tiles (dQ: 9 q tiles x
# 16 heads x 2; dK/dV: 9 key tiles x 8 KV heads x 2), and D=128 (64-row q
# stages in dK/dV, 64-row key tiles in dQ) with Sk > S
BWD_HOPPER_SHAPES = [
    (2, 16, 2, 1100, 1100, 64, True),
    (2, 16, 8, 1100, 1100, 64, True),
    (2, 8, 2, 300, 700, 128, True),
    (1, 4, 1, 200, 460, 128, False),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", BWD_HOPPER_SHAPES)
def test_flash_bwd_hopper_paths_match_plain(cuda, shape):
    B, H, Hkv, S, Sk, D, causal = shape
    q, k, v = _qkv(sum(shape), B, H, Hkv, S, Sk, D, torch.bfloat16, cuda)
    g = torch.Generator().manual_seed(8)
    do = torch.randn(B, S, H, D, generator=g).to(
        cuda, torch.bfloat16).transpose(1, 2)
    o, lse = fa.flash_fwd(q, k, v, causal=causal)
    got = fa.flash_bwd(q, k, v, o, lse, do, causal=causal)
    want = fa.flash_bwd_reference(q, k, v, o, lse, do, causal=causal)
    torch.cuda.synchronize()
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        torch.testing.assert_close(a.float(), b.float(), atol=3e-3,
                                   rtol=2e-2, msg=name)


@pytest.mark.gpu
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_is_bit_identical_twice(cuda, D):
    """No atomics: every block owns its output tiles and sums in a fixed
    order, so two identical calls give the same bits."""
    q, k, v = _qkv(11, 2, 16, 4, 700, 700, D, torch.bfloat16, cuda)
    do = torch.randn_like(q)
    o, lse = fa.flash_fwd(q, k, v)
    first = fa.flash_bwd(q, k, v, o, lse, do)
    second = fa.flash_bwd(q, k, v, o, lse, do)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.gpu
def test_unsupported_head_dim_raises_on_cuda_naming_b1d(cuda):
    """CPU tensors of any D take the plain versions; a CUDA call at a D the
    kernels do not take raises, naming the roadmap item, and launches
    nothing."""
    q, k, v = _qkv(12, 1, 2, 1, 16, 16, 96, torch.bfloat16, cuda)
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    with pytest.raises(ValueError, match="B1d"):
        fa.flash_fwd(q, k, v)
    lse = torch.zeros(1, 2, 16, device=cuda)
    with pytest.raises(ValueError, match="B1d"):
        fa.flash_bwd(q, k, v, q, lse, q)
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == before


@pytest.mark.gpu
def test_unsupported_head_dim_raises_on_cuda_paged(cuda):
    from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa

    q, pages, _, meta = paged_case(0, [1], [10], H=4, Hkv=2, D=96, page=16,
                                   device=cuda)
    before = rpa.ragged_paged_attention.launches
    with pytest.raises(ValueError, match="B1d"):
        rpa.ragged_paged_attention(q, pages, *meta, sm_scale=0.1)
    assert rpa.ragged_paged_attention.launches == before


@pytest.mark.gpu
def test_flash_attention_grad_runs_the_kernels(cuda):
    q, k, v = (t.requires_grad_() for t in
               _qkv(3, 2, 8, 2, 128, 128, 64, torch.bfloat16, cuda))
    before = (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
              fa.flash_bwd_dkv.launches)
    fa.flash_attention(q, k, v).float().square().sum().backward()
    assert (fa.flash_fwd.launches, fa.flash_bwd_dq.launches,
            fa.flash_bwd_dkv.launches) == tuple(b + 1 for b in before)
    assert all(torch.isfinite(t.grad.float()).all() for t in (q, k, v))


def _opt_state(seed, n, device, wdtype=None):
    g = torch.Generator().manual_seed(seed)
    p = torch.randn(n, generator=g)
    grad = torch.randn(n, generator=g) * 1e-2
    m = torch.randn(n, generator=g) * 1e-3
    v = torch.rand(n, generator=g) * 1e-4
    out = [t.to(device) for t in (p, grad, m, v)]
    w = None if wdtype is None else out[0].to(wdtype)
    return out, w


@pytest.mark.gpu
@pytest.mark.parametrize("adam_w", [True, False])
@pytest.mark.parametrize("skip", [0.0, 1.0])
@pytest.mark.parametrize("wdtype", ["bfloat16", "float16", None])
def test_fused_adam_matches_plain(cuda, adam_w, skip, wdtype):
    from deepspeed_tpu_torch.ops import fused_adam as fo

    wdt = None if wdtype is None else getattr(torch, wdtype)
    (p, g, m, v), w = _opt_state(1, 1_000_003, cuda, wdt)
    sc = torch.tensor([1e-3, 0.1, 0.001, 0.5, skip], device=cuda)
    ref = [t.clone() for t in (p, g, m, v)]
    ref_w = None if w is None else w.clone()
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, wd=0.1, adam_w=adam_w)
    before = fo.fused_adam.launches
    fo.fused_adam(p, g, m, v, sc, w, **kw)
    assert fo.fused_adam.launches == before + 1
    fo.adam_update_reference(ref[0], ref[1], ref[2], ref[3], sc, ref_w, **kw)
    torch.cuda.synchronize()
    for a, b in zip((p, m, v), (ref[0], ref[2], ref[3])):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)
    if skip:
        assert torch.equal(p, ref[0]) and torch.equal(m, ref[2])
    if w is not None:
        assert torch.equal(w, p.to(wdt))


@pytest.mark.gpu
@pytest.mark.parametrize("skip", [0.0, 1.0])
def test_fused_lion_matches_plain(cuda, skip):
    from deepspeed_tpu_torch.ops import fused_adam as fo

    (p, g, m, _), w = _opt_state(2, 777_777, cuda, torch.bfloat16)
    sc = torch.tensor([1e-4, 1.0, 1.0, 0.5, skip], device=cuda)
    ref = [t.clone() for t in (p, g, m)]
    ref_w = w.clone()
    before = fo.fused_lion.launches
    fo.fused_lion(p, g, m, sc, w, b1=0.9, b2=0.99, wd=0.1)
    assert fo.fused_lion.launches == before + 1
    fo.lion_update_reference(ref[0], ref[1], ref[2], sc, ref_w, b1=0.9,
                             b2=0.99, wd=0.1)
    torch.cuda.synchronize()
    torch.testing.assert_close(p, ref[0], atol=1e-7, rtol=1e-6)
    torch.testing.assert_close(m, ref[2], atol=1e-7, rtol=1e-6)
    assert torch.equal(w, p.to(torch.bfloat16))


# (shape, group size, dtype, bits, symmetric): the int8 serving path's
# weights in bf16 at v1's and v2's group sizes, then tails (n % gs != 0)
# in every mode, and a group size the vector path cannot take; then the
# ring path's other lane and row splits (groups of 32, 64 and 256, and
# of 4096 over 8 rows), fp16 input, 4 bits at 2048 as ZeRO++ quantizes,
# and n off a whole tile (the last tile holds fewer groups, the last
# group padding) in bf16 and in fp32 at 4096 (one group a tile)
QUANT_CASES = [((4096, 14336), 128, "bfloat16", 8, True),
               ((4096, 14336), 2048, "bfloat16", 8, True),
               ((128256, 4096), 2048, "bfloat16", 8, True)] + [
    ((1000, 1001), 128, dt, bits, sym)
    for dt in ("bfloat16", "float32") for bits in (8, 4)
    for sym in (True, False)] + [((300, 77), 100, "float32", 8, False)] + [
    ((4096, 14336), 32, "bfloat16", 8, True),
    ((4096, 14336), 64, "bfloat16", 8, False),
    ((1024, 4096), 256, "bfloat16", 8, True),
    ((512, 14336), 4096, "bfloat16", 8, True),
    ((4096, 4096), 128, "float16", 8, True),
    ((4096, 4096), 2048, "float16", 8, False),
    ((4096, 4096), 2048, "bfloat16", 4, True),
    ((1000, 1004), 256, "float32", 8, False),
    ((777, 1000), 128, "bfloat16", 8, True),
    ((77, 4104), 4096, "float32", 8, True)]


def _float_bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


@pytest.mark.gpu
@pytest.mark.parametrize("case", QUANT_CASES, ids=lambda c: "-".join(
    map(str, (f"{c[0][0]}x{c[0][1]}", *c[1:]))))
def test_quant_kernels_match_plain(cuda, case):
    from deepspeed_tpu_torch.ops import quantization as qz

    shape, gs, dtype, bits, sym = case
    g = torch.Generator().manual_seed(sum(shape) + gs)
    x = (torch.randn(shape, generator=g) *
         torch.rand(shape[0], 1, generator=g) * 3).to(cuda, getattr(torch,
                                                                   dtype))
    before = (qz.quantize.launches, qz.dequantize.launches)
    got = qz.quantize(x, num_bits=bits, group_size=gs, symmetric=sym)
    back = qz.dequantize(got)
    assert (qz.quantize.launches, qz.dequantize.launches) == (
        before[0] + 1, before[1] + 1)
    want = qz.quantize_reference(x, num_bits=bits, group_size=gs,
                                 symmetric=sym)
    want_back = qz.dequantize_reference(want)
    torch.cuda.synchronize()
    assert torch.equal(got.values, want.values)
    assert torch.equal(_float_bits(got.scale), _float_bits(want.scale))
    assert torch.equal(_float_bits(got.offset), _float_bits(want.offset))
    assert back.shape == x.shape and back.dtype == x.dtype
    assert torch.equal(_float_bits(back), _float_bits(want_back))
    out = torch.empty_like(x)
    assert qz.dequantize(got, out=out) is out
    assert torch.equal(_float_bits(out), _float_bits(want_back))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_quant_kernels_off_16_bytes_match_plain(cuda, dtype):
    """An input one value past a 16-byte boundary (2 bytes in bf16, 4 in
    fp32), sliced from a larger tensor: the ring's bulk copy cannot read
    it, so it takes the one-value-an-access path, bit-identical all the
    same."""
    from deepspeed_tpu_torch.ops import quantization as qz

    g = torch.Generator().manual_seed(11)
    dt = getattr(torch, dtype)
    base = (torch.randn(1000 * 1024 + 8, generator=g) * 2).to(cuda, dt)
    x = base[1:1 + 1000 * 1024].view(1000, 1024)
    assert x.data_ptr() % 16 == base.element_size() and x.is_contiguous()
    got = qz.quantize(x, group_size=128)
    back = qz.dequantize(got)
    want = qz.quantize_reference(x, group_size=128)
    torch.cuda.synchronize()
    assert torch.equal(got.values, want.values)
    assert torch.equal(_float_bits(got.scale), _float_bits(want.scale))
    assert torch.equal(_float_bits(back),
                       _float_bits(qz.dequantize_reference(want)))


@pytest.mark.gpu
def test_quant_kernel_errors_propagate(cuda, monkeypatch):
    from deepspeed_tpu_torch.ops import quantization as qz

    x = torch.randn(64, 256, device=cuda)
    qt = qz.quantize(x, group_size=128)
    before = (qz.quantize.launches, qz.dequantize.launches)
    with pytest.raises(ValueError, match="contiguous"):
        qz.quantize(x.t())
    # a dtype code the C side does not know: it refuses the launch, and
    # the wrapper raises instead of answering with the plain version
    monkeypatch.setattr(qz, "_DTYPES", {torch.float32: 9})
    with pytest.raises(RuntimeError, match="launch failed"):
        qz.quantize(x, group_size=128)
    with pytest.raises(RuntimeError, match="launch failed"):
        qz.dequantize(qt)
    assert (qz.quantize.launches, qz.dequantize.launches) == before


# --------------------------------------------------------------------------
# The weight formats' kernels (weight_formats.cu): K1-K4 and the W8A8
# Linear, bit-identical to their plain versions
# --------------------------------------------------------------------------

def _bits_equal(a, b):
    word = {1: torch.uint8, 2: torch.int16, 4: torch.int32}[a.element_size()]
    return (a.dtype == b.dtype and a.shape == b.shape and
            torch.equal(a.contiguous().view(word), b.contiguous().view(word)))


def _weight(seed, rows, cols, dtype, device):
    """Rows of mixed magnitude, as trained weights have."""
    g = torch.Generator().manual_seed(seed)
    w = torch.randn(rows, cols, generator=g) * torch.rand(rows, 1,
                                                          generator=g)
    return w.to(device, dtype)


# rows, cols: gate_proj's shape, a tail off the 16-element vector, odd
WF_SHAPES = [(4096, 14336), (1000, 1001), (37, 53)]


@pytest.mark.gpu
@pytest.mark.parametrize("fmt", ["int8", "fp8", "fp6"])
def test_quantized_bank_dequant_matches_plain(cuda, fmt):
    """An MoE expert bank [E, M, I] in bf16 quantized as the engines
    quantize it (``quantize_model_``): its one expansion a call (#7, K1 or
    K2) bit-identical to the plain version, and one launch."""
    from deepspeed_tpu_torch.inference import quantization as iq
    from deepspeed_tpu_torch.moe.layer import MoE
    from deepspeed_tpu_torch.ops import quantization as qz

    moe = MoE(256, 6, 384, param_dtype=torch.bfloat16).to(cuda)
    moe.init_weights(torch.Generator(device=cuda).manual_seed(5))
    w2 = moe.w2.detach().clone()
    iq.quantize_model_(moe, fmt)
    bank = moe.w2
    assert isinstance(bank, iq.QuantizedBank) and bank.shape == (6, 384, 256)
    counter = {"int8": qz.dequantize, "fp8": qz.dequant_scaled,
               "fp6": qz.dequantize_fp6}[fmt]
    before = counter.launches
    got = bank.dequantized()
    assert counter.launches == before + 1
    if fmt == "int8":
        want = qz.dequantize_reference(qz.QuantizedTensor(
            bank.values, bank.scale, bank.offset, bank.shape, bank.dtype))
    elif fmt == "fp8":
        want = qz.dequant_scaled_reference(bank.values, bank.scale,
                                           bank.dtype)
    else:
        want = qz.dequantize_fp6_reference(qz.FP6Tensor(
            bank.values, bank.scale, bank.shape, bank.dtype,
            bank.group_size))
    assert _bits_equal(got, want)
    assert (got.float() - w2.float()).abs().max() < 0.1 * w2.float(
        ).abs().max()


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WF_SHAPES)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32", "float16"])
def test_dequant_scaled_matches_plain(cuda, shape, dtype):
    from deepspeed_tpu_torch.ops import quantization as qz

    dt = getattr(torch, dtype)
    w = _weight(1, *shape, dt, cuda)
    ft = qz.quantize_fp8(w)
    assert _bits_equal(qz.dequantize_fp8(ft), qz.dequant_scaled_reference(
        ft.values, ft.scale, dt))
    v, s = qz.quantize_per_channel(w)
    before = qz.dequant_scaled.launches
    assert _bits_equal(qz.dequant_scaled(v, s, dt),
                       qz.dequant_scaled_reference(v, s, dt))
    assert qz.dequant_scaled.launches == before + 1


@pytest.mark.gpu
@pytest.mark.parametrize("shape", WF_SHAPES)
@pytest.mark.parametrize("gs", [128, 2048, 100])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_dequantize_fp6_matches_plain(cuda, shape, gs, dtype):
    """Groups of 128 and 2048, a group size the search lowers, and 37 x 53
    values, which pad to groups of 4 (the byte-wise path)."""
    from deepspeed_tpu_torch.ops import quantization as qz

    w = _weight(2, *shape, getattr(torch, dtype), cuda)
    t = qz.quantize_fp6(w, gs)
    got = qz.dequantize_fp6(t)
    assert got.shape == shape and _bits_equal(got,
                                              qz.dequantize_fp6_reference(t))


def _w8a8_case(M, K, N, dtype, device, seed=3):
    """quantize_per_channel's weight [N, K] and x [M, K] with a zero row,
    an inf row and a NaN row."""
    from deepspeed_tpu_torch.ops import quantization as qz

    dt = getattr(torch, dtype)
    v, s = qz.quantize_per_channel(_weight(seed, N, K, dt, device))
    x = _weight(seed + 1, M, K, dt, device) * 3
    x[0] = 0
    if M > 1:
        x[1, K // 3] = float("inf")
    if M > 2:
        x[2, K // 2] = float("nan")
    return x, v, s


@pytest.mark.gpu
@pytest.mark.parametrize("M", [1, 16, 17, 80, 512])
@pytest.mark.parametrize("K,N", [(4096, 14336), (14336, 4096), (4096, 1024),
                                 (80, 40)])
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_w8a8_gemm_matches_plain(cuda, M, K, N, dtype):
    """The W8A8 Linear bit-identical to ``w8a8_linear_reference`` (NaN
    where it has NaN): one row pre-pass and one GEMM launch a call; the
    pre-pass's rows and scales are the plain version's too."""
    from deepspeed_tpu_torch.ops import quantization as qz

    x, v, s = _w8a8_case(M, K, N, dtype, cuda)
    before = (qz.w8a8_gemm.launches, qz.w8a8_quant_rows.launches)
    got = qz.w8a8_linear(x, v, s)
    assert (qz.w8a8_gemm.launches - before[0],
            qz.w8a8_quant_rows.launches - before[1]) == (1, 1)
    assert _bits_equal(got, qz.w8a8_linear_reference(x, v, s))
    assert (got[0] == 0).all()
    xq, sx = qz.w8a8_quant_rows(x)
    rq, rs = qz.w8a8_quant_rows_reference(x)
    assert torch.equal(xq, rq) and _bits_equal(sx, rs)


@pytest.mark.gpu
def test_w8a8_gemm_lm_head_matches_plain(cuda):
    """The head's 128256 channels at a decode tick's 16 rows: each of
    the 132 blocks walks several channel tiles."""
    from deepspeed_tpu_torch.ops import quantization as qz

    x, v, s = _w8a8_case(16, 4096, 128256, "bfloat16", cuda)
    assert qz.w8a8_plan(16, 128256, 4096).blocks == 132
    assert _bits_equal(qz.w8a8_linear(x, v, s),
                       qz.w8a8_linear_reference(x, v, s))


@pytest.mark.gpu
def test_w8a8_gemm_twice_and_batched_rows(cuda):
    """Two calls bit-identical (the split-K sums and tickets are left
    zeroed), and x [B, S, K] through ``w8a8_linear`` as its rows."""
    from deepspeed_tpu_torch.ops import quantization as qz

    x, v, s = _w8a8_case(16, 4096, 1024, "bfloat16", cuda)
    first = qz.w8a8_linear(x, v, s)
    assert _bits_equal(first, qz.w8a8_linear(x, v, s))
    got = qz.w8a8_linear(x.reshape(2, 8, 4096), v, s)
    assert _bits_equal(got.reshape(16, 1024), first)


@pytest.mark.gpu
def test_weight_format_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    from deepspeed_tpu_torch.ops import quantization as qz

    v = torch.zeros(8, 32, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        qz.dequant_scaled(v.t(), torch.ones((), device=cuda), torch.float32)
    with pytest.raises(ValueError, match="one device"):
        qz.dequant_scaled(v, torch.ones(()), torch.float32)
    # K off 16 bytes: the W8A8 kernels' TMA rows; the refusal names the
    # item that would widen it
    x72, v72, s72 = _w8a8_case(16, 72, 40, "bfloat16", cuda)
    with pytest.raises(ValueError, match="ROADMAP B10"):
        qz.w8a8_linear(x72, v72, s72)
    with pytest.raises(ValueError, match="ROADMAP B10"):
        qz.w8a8_quant_rows(x72)
    with pytest.raises(ValueError, match="one device"):
        qz.w8a8_gemm(x72[:, :64].contiguous(), v72[:, :64].cpu().contiguous(),
                     s72.cpu())


@pytest.mark.gpu
def test_weight_format_wrappers_count_no_launch_on_empty_inputs(cuda):
    """Empty inputs launch nothing, so the counters stay where they were."""
    from deepspeed_tpu_torch.ops import quantization as qz

    counters = (qz.dequant_scaled, qz.dequantize_fp6, qz.w8a8_quant_rows,
                qz.w8a8_gemm)
    before = [c.launches for c in counters]
    one = torch.ones((), device=cuda)
    assert qz.dequant_scaled(torch.zeros(0, 8, dtype=torch.int8, device=cuda),
                             one, torch.bfloat16).shape == (0, 8)
    empty6 = qz.FP6Tensor(torch.zeros(0, 96, dtype=torch.uint8, device=cuda),
                          torch.zeros(0, 1, device=cuda), (0, 8),
                          torch.bfloat16, 128)
    assert qz.dequantize_fp6(empty6).shape == (0, 8)
    xq, sx = qz.w8a8_quant_rows(torch.zeros(0, 64, device=cuda))
    assert xq.shape == (0, 64) and sx.shape == (0, 1)
    v8 = torch.zeros(8, 64, dtype=torch.int8, device=cuda)
    y = qz.w8a8_gemm(torch.zeros(0, 64, device=cuda), v8,
                     torch.ones(8, device=cuda))
    assert y.shape == (0, 8)
    y = qz.w8a8_gemm(torch.zeros(4, 64, device=cuda), v8[:0],
                     torch.ones(0, device=cuda))
    assert y.shape == (4, 0)
    assert [c.launches for c in counters] == before


@pytest.mark.gpu
def test_profiler_reads_device_seconds_of_a_cuda_run(cuda, tmp_path):
    """``telemetry/profiler.py`` over a real CUDA run: the profile object
    and its exported Chrome trace both name the kernels the matmuls
    launched, with device time."""
    from torch.profiler import ProfilerActivity, profile

    from deepspeed_tpu_torch.telemetry import profiler

    a = torch.randn(1024, 1024, device=cuda)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(4):
            a = a @ a
        torch.cuda.synchronize()
    path = str(tmp_path / "cuda.json")
    prof.export_chrome_trace(path)
    from_trace = profiler.device_seconds_by_kernel(path)
    from_prof = profiler.device_seconds_by_kernel(prof)
    assert from_trace and from_prof
    assert set(from_prof) <= set(from_trace)
    assert sum(from_prof.values()) > 0
    assert sum(from_trace.values()) >= 0.99 * sum(from_prof.values())
