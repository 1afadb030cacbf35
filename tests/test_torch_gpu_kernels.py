"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA GPU: a CUDA
kernel has no CPU mode.  The file imports only torch and the port, so it
runs where JAX is not installed:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py

Kernels: the flash-attention forward (``flash_fwd.cu``) and ragged paged
attention over bf16, fp32, int8 and e4m3 pages (``ragged_paged_attn.cu``)
at the v2 path's shapes: decode, mixed decode and prefill, a sliding
window, page-table holes, D=64 with 16-row pages, 128-row pages with 8 q
heads per KV head, MHA with padding tokens.

Tolerances: bf16 flash outputs 2e-2 (p and o round to bf16 at 2^-8
relative, in different places in the kernel and the plain version); bf16
paged outputs 2e-3 absolute plus 2e-2 relative (K and V are O(1), so |o|
is ~0.04 at 2048 keys and the absolute part stays under it); fp32 outputs
1e-4 (full fp32 products, another summation order); lse 2e-3 absolute.
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


def paged_case(seed, q_lens, kv_lens, H=32, Hkv=8, D=128, page=64,
               qdtype=torch.bfloat16, pdtype=torch.bfloat16, holes=False,
               pad=0, device="cuda"):
    """q, a pool holding just the pages the sequences use (plus the trash
    page 0, in a shuffled order), scales for 1-byte pages, and the tick's
    metadata.  K and V are standard normal for every page type.  ``holes``
    marks every other page before a sequence's first query token -1;
    ``pad`` adds padding tokens after the last."""
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
