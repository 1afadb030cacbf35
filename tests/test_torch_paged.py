"""The port's paged KV cache against the JAX package's.

The same numpy-seeded inputs go through ``deepspeed_tpu.inference.paged``
and ``deepspeed_tpu_torch.inference.paged``:

- ``PageAllocator``: one seeded random sequence of allocate / grow /
  attach / cow / free / incref / decref ends with the same free list,
  ownership, refcounts and ``audit()`` counts in both.
- The plain paged-attention versions against JAX's references (fp32,
  atol 1e-5: the same masked softmax, summed in another order) over
  mixed decode and prefill rows, GQA, D 64 and 128, a sliding window,
  interior -1 holes and padding tokens.
- The quantized plain version against JAX's reference and against JAX's
  Pallas kernel #8 run with ``interpret=True`` (int8 and fp8, atol 5e-6,
  the tolerance ``tests/unit/inference/test_paged_quant.py`` holds the
  kernel to).
- Quantize-on-write against JAX's write path on identical K/V: int8 and
  fp8 payloads and fp32 scales bit-equal.
- The kernel wrappers route CPU tensors to the plain versions and count
  no launch.
"""
import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepspeed_tpu.inference import paged as jpaged
from deepspeed_tpu.models.llama import get_config as jax_get_config
from deepspeed_tpu.ops import ragged_paged_attention_quant as jax_kernel8
from deepspeed_tpu_torch.inference import paged
from deepspeed_tpu_torch.ops import ragged_paged_attention as rpa


# -- the allocator ---------------------------------------------------------

def _drive(alloc, ops):
    for op, *args in ops:
        getattr(alloc, op)(*args)
    return alloc


def _random_ops(seed, num_pages=24, slots=6, steps=300):
    """A valid random op sequence, planned against the JAX allocator."""
    rng = np.random.default_rng(seed)
    ref = jpaged.PageAllocator(num_pages, 16)
    ops, external = [], []
    for _ in range(steps):
        live = [s for s in range(slots) if ref.owned(s)]
        free_slots = [s for s in range(slots) if not ref.owned(s)]
        kind = rng.choice(["allocate", "grow", "attach", "cow", "free",
                           "incref", "decref"])
        if kind == "allocate" and free_slots:
            n = int(rng.integers(1, 60))
            if ref.can_allocate(n):
                op = ("allocate", int(rng.choice(free_slots)), n)
            else:
                continue
        elif kind == "grow" and live and ref.free_pages:
            op = ("grow", int(rng.choice(live)),
                  int(rng.integers(1, ref.free_pages + 1)))
        elif kind == "attach" and live and free_slots:
            src = ref.owned_pages(int(rng.choice(live)))
            op = ("attach", int(rng.choice(free_slots)),
                  src[:int(rng.integers(1, len(src) + 1))])
        elif kind == "cow" and live and ref.free_pages:
            s = int(rng.choice(live))
            op = ("cow", s, int(rng.integers(0, ref.owned(s))))
        elif kind == "free" and live:
            op = ("free", int(rng.choice(live)))
        elif kind == "incref" and live:
            p = int(rng.choice(ref.owned_pages(int(rng.choice(live)))))
            external.append(p)
            op = ("incref", p)
        elif kind == "decref" and external:
            op = ("decref", external.pop(int(rng.integers(len(external)))))
        else:
            continue
        _drive(ref, [op])
        ops.append(op)
    return ops, external


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_allocator_matches_jax(seed):
    ops, external = _random_ops(seed)
    assert len(ops) > 100
    want = _drive(jpaged.PageAllocator(24, 16), ops)
    got = _drive(paged.PageAllocator(24, 16), ops)
    assert got._free == want._free
    assert got._owned == want._owned
    np.testing.assert_array_equal(got._ref, want._ref)
    held = {}
    for p in external:
        held[p] = held.get(p, 0) + 1
    assert got.audit(external=held) == want.audit(external=held)
    assert got.audit() == want.audit()


def test_allocator_audit_catches_a_leak():
    alloc = paged.PageAllocator(8, 16)
    alloc.allocate(0, 40)
    alloc._ref[alloc.owned_pages(0)[0]] += 1       # a lost reference
    with pytest.raises(AssertionError, match="refcount"):
        alloc.audit(external={})


@pytest.mark.parametrize("n,page,want", [(0, 16, 1), (16, 16, 1),
                                         (17, 16, 2), (100, 64, 2)])
def test_pages_for_matches_jax(n, page, want):
    assert paged.pages_for(n, page) == jpaged.pages_for(n, page) == want


# -- the plain paged-attention versions --------------------------------------

def _case(seed, q_lens, kv_lens, H, Hkv, D, page, holes=(), pad=0,
          fmt=None):
    """numpy q, pool (and scales), metadata.  Pages are spread over a pool
    of 1 + sum(pages) + 2 pages in a shuffled order; ``holes`` lists
    (sequence, column) entries set to -1."""
    r = np.random.default_rng(seed)
    S = len(q_lens)
    cols = [-(-kv // page) for kv in kv_lens]
    P = 1 + sum(cols) + 2
    ids = list(r.permutation(np.arange(1, P)))
    table = np.full((S, max(cols) + 1), -1, np.int32)
    for j, c in enumerate(cols):
        table[j, :c] = ids[:c]
        ids = ids[c:]
    for j, c in holes:
        table[j, c] = -1
    shape = (P, page, 2 * Hkv, D)
    scales = None
    if fmt == "int8":
        pool = r.integers(-127, 128, size=shape).astype(np.int8)
    elif fmt == "fp8":
        pool = np.clip(r.standard_normal(shape) * 100, -448, 448).astype(
            jnp.float8_e4m3fn)
    else:
        pool = r.standard_normal(shape).astype(np.float32)
    if fmt is not None:
        scales = (r.random(shape[:3]) * 0.02 + 0.001).astype(np.float32)
    q = r.standard_normal((sum(q_lens) + pad, H, D)).astype(np.float32)
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    meta = (np.asarray(kv_lens, np.int32), table, cu,
            np.asarray([S], np.int32))
    return q, pool, scales, meta


def _torch(x):
    if x.dtype == jnp.float8_e4m3fn:
        return torch.from_numpy(x.view(np.uint8)).view(torch.float8_e4m3fn)
    return torch.from_numpy(np.ascontiguousarray(x))


# name: (q_lens, kv_lens, H, Hkv, D, page, options)
CASES = {
    "decode_and_prefill_gqa": ([1, 1, 7, 1], [9, 30, 20, 3], 4, 2, 64, 8,
                               {}),
    "mha_d128": ([5, 1], [5, 17], 2, 2, 128, 16, {}),
    "gqa4_window": ([1, 12, 1], [40, 25, 33], 8, 2, 64, 8,
                    {"window": 6}),
    "interior_holes": ([1, 4], [50, 44], 4, 2, 64, 8,
                       {"holes": [(0, 1), (0, 3), (1, 2)]}),
    "padding_tokens": ([3, 1], [10, 21], 4, 1, 64, 4, {"pad": 5}),
    "prefill_from_zero": ([16], [16], 4, 2, 128, 4, {}),
}


@pytest.mark.parametrize("name", list(CASES))
def test_ref_paged_attention_matches_jax(name):
    q_lens, kv_lens, H, Hkv, D, page, opt = CASES[name]
    window = opt.get("window")
    q, pool, _, meta = _case(1, q_lens, kv_lens, H, Hkv, D, page,
                             holes=opt.get("holes", ()),
                             pad=opt.get("pad", 0))
    sm = 1 / np.sqrt(D)
    want = np.asarray(jpaged.ref_paged_attention(
        jnp.asarray(q), jnp.asarray(pool), *map(jnp.asarray, meta),
        sm_scale=sm, sliding_window=window))
    got = paged.ref_paged_attention(
        _torch(q), _torch(pool), *map(_torch, meta), sm_scale=sm,
        sliding_window=window).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert (got[sum(q_lens):] == 0).all()


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("name", ["decode_and_prefill_gqa", "gqa4_window",
                                  "interior_holes", "padding_tokens"])
def test_ref_paged_attention_quant_matches_jax(name, fmt):
    q_lens, kv_lens, H, Hkv, D, page, opt = CASES[name]
    window = opt.get("window")
    q, pool, scales, meta = _case(2, q_lens, kv_lens, H, Hkv, D, page,
                                  holes=opt.get("holes", ()),
                                  pad=opt.get("pad", 0), fmt=fmt)
    sm = 1 / np.sqrt(D)
    want = np.asarray(jpaged.ref_paged_attention_quant(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales),
        *map(jnp.asarray, meta), sm_scale=sm, sliding_window=window))
    got = paged.ref_paged_attention_quant(
        _torch(q), _torch(pool), _torch(scales), *map(_torch, meta),
        sm_scale=sm, sliding_window=window).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


@pytest.mark.parametrize("fmt", ["int8", "fp8"])
@pytest.mark.parametrize("window", [None, 7])
def test_ref_paged_attention_quant_matches_jax_kernel8(fmt, window):
    """JAX's Pallas kernel #8 (D=128 only), run as its own tests run it
    on the CPU: through the Pallas interpreter."""
    q, pool, scales, meta = _case(3, [1, 6, 2], [10, 20, 5], 4, 2, 128, 8,
                                  fmt=fmt)
    sm = 1 / np.sqrt(128)
    want = np.asarray(jax_kernel8(
        jnp.asarray(q), jnp.asarray(pool), jnp.asarray(scales),
        *map(jnp.asarray, meta), sm_scale=sm, sliding_window=window,
        interpret=True))
    got = paged.ref_paged_attention_quant(
        _torch(q), _torch(pool), _torch(scales), *map(_torch, meta),
        sm_scale=sm, sliding_window=window).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


def test_carry_is_not_ported_yet():
    q, pool, scales, meta = _case(4, [1], [4], 2, 1, 64, 4, fmt="int8")
    with pytest.raises(NotImplementedError, match="A9.5"):
        paged.ref_paged_attention_quant(
            _torch(q), _torch(pool), _torch(scales), *map(_torch, meta),
            sm_scale=0.1, carry=object())


# -- the write path ----------------------------------------------------------

_WCFG = jax_get_config("tinyllama", vocab_size=64, hidden_size=32,
                       intermediate_size=64, num_hidden_layers=1,
                       num_attention_heads=4, num_key_value_heads=2,
                       max_position_embeddings=128, dtype=jnp.float32,
                       param_dtype=jnp.float32, scan_layers=False,
                       remat=False, use_flash_attention=False)


class _Harness(fnn.Module):
    cfg: object

    @fnn.compact
    def __call__(self, q, k, v, ragged_meta):
        return jpaged.paged_update_and_attend(self, q, k, v, ragged_meta,
                                              self.cfg)


@pytest.mark.parametrize("fmt", ["none", "int8", "fp8"])
@pytest.mark.parametrize("magnitude", [1.0, 1e-30, 0.0])
def test_write_path_matches_jax(fmt, magnitude):
    """Rows land at ``new_kv_dest`` with K at even and V at odd combined
    heads; quantized pools store the same payload bits and scales as
    JAX's write path (``paged.py:551-578``), including the tiny-scale
    floor for rows near zero."""
    T, Hkv, D, P, page = 8, 2, 16, 5, 4
    r = np.random.default_rng(7)
    k = (r.standard_normal((T, Hkv, D)) * magnitude).astype(np.float32)
    v = (r.standard_normal((T, Hkv, D)) * magnitude).astype(np.float32)
    dest = np.asarray([4, 5, 6, 7, 12, 13, 0, 0], np.int32)   # 2 pads
    cfg = dataclasses.replace(_WCFG, paged_decode=True, kv_num_pages=P,
                              kv_page_size=page, kv_cache_dtype=fmt)
    meta = {"kv_lens": jnp.asarray([6], jnp.int32),
            "page_indices": jnp.asarray([[1, 3]], jnp.int32),
            "cu_q_lens": jnp.asarray([0, 6], jnp.int32),
            "num_seqs": jnp.asarray([1], jnp.int32),
            "new_kv_dest": jnp.asarray(dest)}
    q = jnp.ones((1, 4, T, D), jnp.float32)
    kj = jnp.asarray(k.transpose(1, 0, 2)[None])
    vj = jnp.asarray(v.transpose(1, 0, 2)[None])
    m = _Harness(cfg)
    variables = m.init(jax.random.PRNGKey(0), q, kj, vj, meta)
    _, mut = m.apply(variables, q, kj, vj, meta, mutable=["cache"])
    want_pages = np.asarray(mut["cache"]["kv_pages"])

    pool = paged.PagedKVPool(P, page, Hkv, D, fmt, torch.float32,
                             torch.device("cpu"))
    pool.write(torch.from_numpy(k), torch.from_numpy(v),
               torch.from_numpy(dest.astype(np.int64)))
    got = pool.pages
    # the trash page's row 0 takes whichever padding row lands last
    if fmt == "fp8":
        np.testing.assert_array_equal(
            got.view(torch.uint8).numpy()[1:], want_pages.view(np.uint8)[1:])
    else:
        np.testing.assert_array_equal(got.numpy()[1:], want_pages[1:])
    if fmt != "none":
        want_scales = np.asarray(mut["cache"]["kv_scales"])
        np.testing.assert_array_equal(pool.scales.numpy()[1:],
                                      want_scales[1:])
        assert pool.quantized and pool.nbytes() == P * page * 2 * Hkv * (
            D + 4)


# -- the wrappers on the CPU ---------------------------------------------------

def test_wrappers_take_the_plain_versions_on_cpu():
    q, pool, scales, meta = _case(5, [1, 3], [9, 12], 4, 2, 64, 16,
                                  fmt="int8")
    meta = [_torch(m) for m in meta]
    qt, sc, pt = _torch(q), _torch(scales), _torch(pool)
    before = (rpa.ragged_paged_attention.launches,
              rpa.ragged_paged_attention_quant.launches)
    got = rpa.ragged_paged_attention_quant(qt, pt, sc, *meta, sm_scale=0.1)
    want = paged.ref_paged_attention_quant(qt, pt, sc, *meta, sm_scale=0.1)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    full = pt.float() * sc[..., None]
    got = rpa.ragged_paged_attention(qt, full, *meta, sm_scale=0.1)
    torch.testing.assert_close(got, paged.ref_paged_attention(
        qt, full, *meta, sm_scale=0.1), atol=0, rtol=0)
    assert (rpa.ragged_paged_attention.launches,
            rpa.ragged_paged_attention_quant.launches) == before == (0, 0)


@pytest.mark.parametrize("bad,err,match", [
    ({"page": 8}, ValueError, "page size"),
    ({"D": 32}, ValueError, "head dim"),
    ({"kv_dtype": torch.int64}, TypeError, "int32"),
    ({"pool_dtype": torch.bfloat16}, TypeError, "q's dtype"),
    ({"window": 0}, ValueError, "sliding_window"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad, err, match):
    page, D = bad.get("page", 16), bad.get("D", 64)
    q, pool, _, meta = _case(6, [2], [5], 2, 1, D, page)
    meta = [_torch(m) for m in meta]
    meta[0] = meta[0].to(bad.get("kv_dtype", torch.int32))
    pt = _torch(pool).to(bad.get("pool_dtype", torch.float32))
    with pytest.raises(err, match=match):
        rpa.ragged_paged_attention(_torch(q), pt, *meta, sm_scale=0.1,
                                   sliding_window=bad.get("window"))


def test_kv_dequant_path_names_the_route():
    assert paged.kv_dequant_path(torch.device("cpu")) == "torch-gather"
    assert paged.kv_dequant_path(torch.device("cuda", 0)) == "cuda-quant"
