// Ragged paged attention for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (deepspeed_tpu_torch/ops/
// ragged_paged_attention.py).
//
// Replaces two TPU kernels with one source, templated on the page type:
// - full-width pages (bf16, fp32): upstream's vLLM-TPU Pallas kernel
//   ragged_paged_attention_kernel, which deepspeed_tpu/inference/
//   paged.py:602-609 calls on every serving tick;
// - quantized pages (int8, fp8 e4m3 with per-(row, combined head) fp32
//   scales): deepspeed_tpu/ops/ragged_paged_quant.py::_quant_kernel.
// Same function: q [T,H,D] holds one fused tick's tokens (decode tokens
// and prefill chunks of several sequences, sequence j owning rows
// cu_q_lens[j]..cu_q_lens[j+1]); pages [P,page,2*Hkv,D] hold K at even
// and V at odd combined heads; key k of sequence j lives at row k % page
// of page page_indices[j, k / page] (-1: padding or a hole, never
// attended).  Token t of sequence j sits at absolute position
// kv_lens[j] - q_len_j + (t - cu_q_lens[j]) and attends the keys at or
// before it, below kv_lens[j], and inside the optional sliding window.
// Tokens past cu_q_lens[num_seqs] write 0, and so does a row that sees
// no key (the engine never makes one: a token's own key is written
// before attention).
//
// An optional incoming carry (the long-context scan's finish dispatch:
// deepspeed_tpu/ops/ragged_paged_quant.py:84-90 seeds its accumulators
// with it) holds raw flash stats of keys attended elsewhere, m and l
// [T,H] and un-normalized acc [T,H,D], fp32, m in natural-log units of
// the scaled score.  The kernel folds the carry first, then the resident
// keys, then normalizes, so a row that sees no resident key returns the
// normalized carry.  A carry row with l == 0 is the neutral element and
// is skipped: its m (-0.7 * FLT_MAX) would overflow to -inf in log2
// units, and -inf - -inf is NaN.
//
// What bounds it on this card: bytes.  Decode reads every attended page
// once per tick (page * 2 * Hkv * D * elem bytes per page) for 4 * D
// operations per (query head, key) pair, so a decode tick at 16
// sequences x ~1000 keys is ~32 MiB for ~1 GFLOP: ~10 us of HBM against
// ~1 us of tensor-core time.  A prefill chunk (512 tokens on ~1500 keys)
// has ~400x the operations per byte and is bound by operations.
//
// What this design does about it (bf16 queries: rpa_mma, rpa_combine):
// - Split-KV work units.  A unit is (sequence, KV head, q tile, key
//   split), one block each.  The rows of a q tile are (token, q head of
//   the GQA group) pairs, 64 of them, so each page is read once per
//   unit and not once per q head.  A split is a run of `split_stages`
//   whole 64-key stages at absolute key positions: split z of every
//   sequence covers keys [64 * split_stages * z, 64 * split_stages *
//   (z + 1)), so at the v2 decode shape (16 sequences, a 2048-key
//   table: 2 splits) a 2048-key sequence gets 2 units and a 128-key one
//   1, and two sequences of 2048 keys get 11 units each.  The wrapper
//   sizes the splits from host-known numbers only (T, S, H, Hkv, the
//   page-table width and the page size: split_plan), and the grid, (q
//   tile slots, Hkv, splits), from host-known bounds: each block reads
//   cu_q_lens and kv_lens to find its unit and exits at once when its
//   split lies outside its tile's key range (kv_len, causal bound,
//   window).  No device value is read on the host, so the launch can sit
//   inside a captured decode block.
// - The combine is the reference's fold_stats, in split order.  A tile
//   whose key range lies in one split writes o directly.  Otherwise each
//   of its splits writes raw fp32 stats (m in log2 units, l, acc) to the
//   wrapper's scratch [splits, T, H(, D)], and a second kernel of the
//   same call, rpa_combine, folds them in split order and normalizes.
//   No atomics: two calls give the same bits.  A call with a carry
//   always takes the stats path, at one split too: rpa_combine folds the
//   carry as a split before split 0 (splits made only of holes have
//   l == 0 and weigh nothing), so the direct write is never reached.
// - A page ring several stages deep.  A unit copies its slice of the
//   page table into shared memory once; then cp.async keeps two (bf16
//   pages) or three (1-byte pages) stages in flight behind the one being
//   computed, with one __syncthreads per stage.  A copy finds its page in
//   shared memory and its row with a shift and a mask (pages are powers
//   of two): no global read of the page table and no division between
//   two loads.  A stage made only of -1 holes is neither loaded nor
//   computed; hole rows inside a stage issue no read (cp.async zero-
//   fills them) and are masked.
// - Every warp at work.  A tile with at most 16 live rows (decode: one
//   token x a group of up to 16) gives all 4 warps the same 16 rows and
//   each a quarter of every stage's keys; up to 32 rows, two warps per
//   row tile take half each; above that each warp owns 16 rows and all
//   keys.  Warps that shared rows fold their (m, l, acc) in shared memory
//   at the end of the unit, in warp order.
// - mma.sync m16n8k16 (bf16 in, fp32 accumulate), the FlashAttention-2
//   register layout: at decode the tensor cores are far from the bound.
//   Q fragments come from global memory straight into registers.
//   Prefill tiles, which are bound by operations, stay on mma.sync too:
//   wgmma for them is ROADMAP B4d.
// - 1-byte pages stay 1 byte in HBM and in the ring.  Once per stage all
//   threads convert it to a bf16 tile, 16 bytes a thread at a time (int8
//   and e4m3 are exact in bf16, e4m3 through f16x2); each key's K scale
//   multiplies its fp32 score, and its V scale folds into p before the
//   PV product (the row sum takes p unscaled).
// - fp32 queries take a SIMT kernel in full fp32 over fp32, int8 or e4m3
//   pages (rpa_simt: one block per (q tile, KV head), no split), so a
//   float32 model matches the CPU without TF32 rounding.  A carry seeds
//   its softmax state, as the Pallas kernel seeds its scratch.
// - Masks use the finite -0.7 * FLT_MAX of the reference, so a wholly
//   masked tile or split folds away exactly once a valid key arrives.
// - The launcher returns cudaGetLastError(), so a refused launch is seen.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int BM = 64;   // rows (token x q head of the group) per block
constexpr int BN = 64;   // keys per tile
constexpr int WARPS = 4; // each warp owns WM rows
constexpr int WM = BM / WARPS;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr float MASK = -0.7f * FLT_MAX;  // _MASK_VALUE of the reference
constexpr float LOG2E = 1.4426950408889634f;

struct Args {
  const void* q;
  const void* pages;
  const float* scales;  // quantized pages only
  void* o;
  const int* kv_lens;       // [S]
  const int* page_indices;  // [S, pp]
  const int* cu_q_lens;     // [S + 1]
  const int* num_seqs;      // [1]
  // raw stats of each split, [splits, T, H] and [splits, T, H, D] fp32;
  // read and written only when splits > 1
  float* part_m;
  float* part_l;
  float* part_acc;
  // incoming flash carry, [T, H] and [T, H, D] fp32, or all null
  const float* carry_m;
  const float* carry_l;
  const float* carry_acc;
  int T, H, Hkv, S, pp, page, window;  // window <= 0: none
  int splits, split_stages, log_page;  // page == 1 << log_page
  float scale;
};

// Page element types: the element C++ type and whether it carries scales
struct PBf16 { using T = __nv_bfloat16; static constexpr bool quant = false; };
struct PF32 { using T = float; static constexpr bool quant = false; };
struct PI8 { using T = int8_t; static constexpr bool quant = true; };
struct PE4M3 { using T = uint8_t; static constexpr bool quant = true; };

__device__ __forceinline__ float byte_to_float(int8_t x, PI8) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float byte_to_float(uint8_t x, PE4M3) {
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x, __NV_E4M3)));
}

__device__ __forceinline__ float elem_to_float(const float* p, PF32) {
  return *p;
}
__device__ __forceinline__ float elem_to_float(const int8_t* p, PI8 tag) {
  return byte_to_float(*p, tag);
}
__device__ __forceinline__ float elem_to_float(const uint8_t* p, PE4M3 tag) {
  return byte_to_float(*p, tag);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes global -> shared; `valid` false writes zeros instead
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b for one 16x8x16 tile; a row-major, b column-major
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

// ---------------------------------------------------------------------------
// Work assignment, shared by both kernels
// ---------------------------------------------------------------------------

// One block's work: `ntok` tokens of sequence `seq` starting at global
// token `t0`, whose first token sits at absolute position `qbase`.
struct Work {
  int seq, t0, ntok, qbase, kv_len;
};

// Tile `tile` (of tq tokens) of sequence j
__device__ __forceinline__ void tile_work(const Args& a, int j, int tile,
                                          int tq, Work& w) {
  const int c0 = a.cu_q_lens[j], qlen = a.cu_q_lens[j + 1] - c0;
  w.seq = j;
  w.t0 = c0 + tile * tq;
  w.ntok = min(tq, qlen - tile * tq);
  w.kv_len = a.kv_lens[j];
  w.qbase = w.kv_len - qlen + tile * tq;
}

// Sequence j owns ceil(q_len_j / tq) tiles; block x takes the x-th tile
// in sequence order.  Each warp walks the metadata 32 sequences at a
// time (one load each, a prefix sum by shuffles), so the walk costs one
// memory latency per 32 sequences; every warp finds the same answer.
__device__ __forceinline__ bool find_work(const Args& a, int tq, Work& w) {
  const int ns = min(a.num_seqs[0], a.S);
  const int lane = threadIdx.x % 32;
  int tile = blockIdx.x;
  for (int j0 = 0; j0 < ns; j0 += 32) {
    const int j = j0 + lane;
    int nt = 0;
    if (j < ns) {
      const int qlen = a.cu_q_lens[j + 1] - a.cu_q_lens[j];
      nt = qlen > 0 ? (qlen + tq - 1) / tq : 0;
    }
    int incl = nt;  // tiles of sequences j0..j
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(FULL, incl, off);
      if (lane >= off) incl += y;
    }
    const int total = __shfl_sync(FULL, incl, 31);
    if (tile < total) {
      const int hit = __ffs(__ballot_sync(FULL, incl > tile)) - 1;
      const int before = __shfl_sync(FULL, incl - nt, hit);
      tile_work(a, j0 + hit, tile - before, tq, w);
      return true;
    }
    tile -= total;
  }
  return false;
}

// Padding tokens (past cu_q_lens[num_seqs]) write 0 for this block's KV
// head: a grid-stride loop over every block of the same blockIdx.y.
template <typename QT, int D>
__device__ __forceinline__ void zero_padding(const Args& a, int groups) {
  const int ns = min(a.num_seqs[0], a.S);
  const int t_end = min(max(a.cu_q_lens[ns], 0), a.T);
  constexpr int VEC = 16 / sizeof(QT);
  constexpr int CPR = D / VEC;  // 16-byte chunks per row
  const int64_t total = (int64_t)(a.T - t_end) * groups * CPR;
  QT* o = static_cast<QT*>(a.o);
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < total;
       i += (int64_t)gridDim.x * THREADS) {
    const int c = (int)(i % CPR);
    const int64_t rest = i / CPR;
    const int g = (int)(rest % groups);
    const int64_t t = t_end + rest / groups;
    *reinterpret_cast<uint4*>(
        o + (t * a.H + (int64_t)blockIdx.y * groups + g) * D + c * VEC) =
        make_uint4(0u, 0u, 0u, 0u);
  }
}

// Keys this block needs: [kstart, kend), as 64-key tiles
__device__ __forceinline__ void key_range(const Args& a, const Work& w,
                                          int& kt_begin, int& kt_end) {
  const int kend = min(min(w.kv_len, w.qbase + w.ntok), a.pp * a.page);
  const int kstart = a.window > 0 ? max(0, w.qbase - a.window + 1) : 0;
  kt_end = kend > 0 ? (kend + BN - 1) / BN : 0;
  kt_begin = min(kstart / BN, kt_end);
}

// The splits that a tile's stages [kt_begin, kt_end) overlap: the first,
// z0, and their count n (1 for an empty range: that unit writes zeros)
__device__ __forceinline__ void split_span(const Args& a, int kt_begin,
                                           int kt_end, int& z0, int& n) {
  z0 = kt_begin / a.split_stages;
  n = kt_end > kt_begin ? (kt_end - 1) / a.split_stages - z0 + 1 : 1;
}

// The first tile at or after `kt` that holds a valid page (-1 entries
// are padding or holes: a tile made only of them is skipped)
__device__ __forceinline__ int next_tile(const Args& a, const int* prow,
                                         int kt, int kt_end) {
  for (; kt < kt_end; ++kt) {
    const int c0 = kt * BN / a.page;
    const int c1 = min((kt * BN + BN - 1) / a.page, a.pp - 1);
    for (int c = c0; c <= c1; ++c)
      if (prow[c] >= 0) return kt;
  }
  return kt_end;
}

// Start the copy of tile `kt` of this (sequence, KV head): K and V rows
// gathered through the page table into shared rows of LDB bytes, rows of
// invalid pages zero-filled; `kok` marks the keys that exist (valid page,
// below kv_len); quantized pages also bring each key's K and V scale.
template <typename P, int D, int LDB>
__device__ __forceinline__ void load_kv_tile(uint8_t* Kd, uint8_t* Vd,
                                             int* kok, float* ksc, float* vsc,
                                             const Args& a, const int* prow,
                                             const Work& w, int kt, int kvh) {
  using T = typename P::T;
  constexpr int CPR = D * (int)sizeof(T) / 16;
  const int combined = 2 * a.Hkv;
  const T* base = static_cast<const T*>(a.pages);
  for (int idx = threadIdx.x; idx < BN * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const int key = kt * BN + r;
    const int col = key / a.page;
    const int pg = col < a.pp ? prow[col] : -1;
    const bool ok = pg >= 0;
    const int64_t row = ok ? ((int64_t)pg * a.page + key % a.page) : 0;
    const T* krow = base + (row * combined + 2 * kvh) * D;
    cp_async16(Kd + r * LDB + c * 16,
               reinterpret_cast<const uint8_t*>(krow) + c * 16, ok);
    cp_async16(Vd + r * LDB + c * 16,
               reinterpret_cast<const uint8_t*>(krow + D) + c * 16, ok);
  }
  if (threadIdx.x < BN) {
    const int r = threadIdx.x;
    const int key = kt * BN + r;
    const int col = key / a.page;
    const int pg = col < a.pp ? prow[col] : -1;
    const bool ok = pg >= 0;
    kok[r] = ok && key < w.kv_len;
    if constexpr (P::quant) {
      const int64_t row = ok ? ((int64_t)pg * a.page + key % a.page) : 0;
      const float* srow = a.scales + row * combined + 2 * kvh;
      cp_async4(ksc + r, srow, ok);
      cp_async4(vsc + r, srow + 1, ok);
    }
  }
}

// Start the copy of this block's q rows: row r is (token r / groups, q
// head kvh * groups + r % groups); rows past the tile are zero-filled.
template <typename QT, int D, int LDQ>
__device__ __forceinline__ void load_q_tile(QT* Qs, const Args& a,
                                            const Work& w, int groups,
                                            int kvh) {
  constexpr int CPR = D * (int)sizeof(QT) / 16;
  const QT* q = static_cast<const QT*>(a.q);
  const int live = w.ntok * groups;
  for (int idx = threadIdx.x; idx < BM * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const bool ok = r < live;
    const int64_t t = w.t0 + (ok ? r / groups : 0);
    const QT* src = q + (t * a.H + (int64_t)kvh * groups + (ok ? r % groups : 0)) * D;
    cp_async16(reinterpret_cast<uint8_t*>(Qs + r * LDQ) + c * 16,
               reinterpret_cast<const uint8_t*>(src) + c * 16, ok);
  }
}

__device__ __forceinline__ bool key_visible(int key, int qpos, int window) {
  return key <= qpos && (window <= 0 || key > qpos - window);
}

// Whether carry row `row` (token * H + head) holds stats: l > 0 (the
// neutral carry has l == 0 and m = MASK)
__device__ __forceinline__ bool carry_live(const Args& a, int64_t row) {
  return a.carry_m != nullptr && a.carry_l[row] > 0.f &&
         a.carry_m[row] > MASK * 0.5f;
}

// ---------------------------------------------------------------------------
// bf16 queries: split-KV units over a cp.async page ring, mma.sync
// ---------------------------------------------------------------------------

constexpr int PT_MAX = 1024;  // page-table entries one unit holds

// Stages of the ring: all but one in flight behind the one computed.
// Sized so that two blocks fit an SM at D = 128.
template <typename P>
struct Ring {
  static constexpr int STAGES = sizeof(typename P::T) == 2 ? 3 : 4;
};

template <typename P, int D>
struct SmemMma {
  static constexpr bool BF = sizeof(typename P::T) == 2;
  static constexpr int STAGES = Ring<P>::STAGES;
  // bf16 elements per row of a K or V tile that ldmatrix reads: 16 bytes
  // of pad keep its 8-row reads off each other's banks
  static constexpr int LDT = D + 8;
  // bytes per row in the ring: bf16 rows padded, 1-byte rows dense (the
  // conversion reads them 16 bytes a thread, row after row)
  static constexpr int LDR = BF ? 2 * LDT : D;
  static constexpr size_t tile_bytes = (size_t)BN * LDR;  // K or V, a stage
  static constexpr size_t stage_bytes = 2 * tile_bytes;
  static constexpr size_t ring_off = 0;
  // 1-byte pages: the stage being computed, as bf16 K and V tiles
  static constexpr size_t conv_off = ring_off + STAGES * stage_bytes;
  static constexpr size_t conv_bytes = BF ? 0 : 2 * (size_t)BN * LDT * 2;
  // 1-byte pages: (K scale, V scale) of every key of every stage
  static constexpr size_t sc_off = conv_off + conv_bytes;
  static constexpr size_t sc_bytes = BF ? 0 : (size_t)STAGES * BN * 8;
  static constexpr size_t pt_off = sc_off + sc_bytes;
  static constexpr size_t bytes = pt_off + PT_MAX * 4;
  // the warps' fold at the end of a unit reuses the ring: up to 3 warps'
  // 16 rows x (D acc, m, l)
  static constexpr int LDF = D + 2;
  static_assert(3 * 16 * LDF * 4 <= STAGES * stage_bytes, "fold area");
};

// One unit's place: its (sequence, q tile) work, KV head, split and
// stages [s_begin, s_end), and its page-table slice: columns c_lo ..
// c_lo + ncols - 1, copied to shared memory
struct Unit {
  Work w;
  int kvh, groups, live_rows, z, s_begin, s_end, c_lo, ncols;
  bool direct;  // the tile's only split: write o, not stats
};

// Whether stage kt holds a valid page (uniform over the block)
__device__ __forceinline__ bool stage_live(const int* pt, const Unit& u,
                                           int log_page, int kt) {
  const int c0 = ((kt * BN) >> log_page) - u.c_lo;
  const int c1 = min(((kt * BN + BN - 1) >> log_page) - u.c_lo, u.ncols - 1);
  for (int c = c0; c <= c1; ++c)
    if (pt[c] >= 0) return true;
  return false;
}

// Start the copy of stage kt into a ring slot: K rows then V rows, each
// gathered through the shared page-table slice; rows of holes zero-fill
// and read nothing.  1-byte pages also bring each key's (K, V) scales.
template <typename P, int D>
__device__ __forceinline__ void load_stage(uint8_t* slot, float2* sc,
                                           const int* pt, const Args& a,
                                           const Unit& u, int kt) {
  using L = SmemMma<P, D>;
  constexpr int RB = D * (int)sizeof(typename P::T);  // bytes of a row
  constexpr int CPR = RB / 16;                        // 16-byte chunks
  const int64_t combined = 2 * a.Hkv;
  const uint8_t* base = static_cast<const uint8_t*>(a.pages);
  const int in_page = a.page - 1;
  for (int idx = threadIdx.x; idx < BN * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;
    const int key = kt * BN + r;
    const int col = (key >> a.log_page) - u.c_lo;
    const int pg = col < u.ncols ? pt[col] : -1;
    const bool ok = pg >= 0;
    const int64_t row = ok ? (int64_t)pg * a.page + (key & in_page) : 0;
    const uint8_t* src = base + (row * combined + 2 * u.kvh) * RB + c * 16;
    cp_async16(slot + r * L::LDR + c * 16, src, ok);
    cp_async16(slot + L::tile_bytes + r * L::LDR + c * 16, src + RB, ok);
  }
  if constexpr (P::quant) {
    if (threadIdx.x < BN) {
      const int key = kt * BN + threadIdx.x;
      const int col = (key >> a.log_page) - u.c_lo;
      const int pg = col < u.ncols ? pt[col] : -1;
      const int64_t row =
          pg >= 0 ? (int64_t)pg * a.page + (key & in_page) : 0;
      cp_async8(sc + threadIdx.x, a.scales + row * combined + 2 * u.kvh,
                pg >= 0);
    }
  }
}

// four 1-byte values -> two bf16x2, exactly.  int8: x + 128 goes into
// the low byte of the float 2^23 + (x + 128), and subtracting 2^23 + 128
// leaves x; e4m3: the hardware's e4m3x2 -> f16x2, then f32.  Both have
// at most 8 significant bits, so the bf16 is the float's high half.
__device__ __forceinline__ uint32_t high_halves(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632);
}
template <typename P>
__device__ __forceinline__ void word_to_bf16(uint32_t w, uint32_t& lo,
                                             uint32_t& hi);
template <>
__device__ __forceinline__ void word_to_bf16<PI8>(uint32_t w, uint32_t& lo,
                                                  uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;  // x + 128 in every byte
  constexpr float BIAS = 8388736.f;    // 2^23 + 128
  float f[4];
  for (int i = 0; i < 4; ++i)
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | i)) - BIAS;
  lo = high_halves(f[0], f[1]);
  hi = high_halves(f[2], f[3]);
}
template <>
__device__ __forceinline__ void word_to_bf16<PE4M3>(uint32_t w, uint32_t& lo,
                                                    uint32_t& hi) {
  const float2 a = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w & 0xffff), __NV_E4M3)));
  const float2 b = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(w >> 16), __NV_E4M3)));
  lo = high_halves(a.x, a.y);
  hi = high_halves(b.x, b.y);
}

// A ring slot of 1-byte K and V rows -> the bf16 tiles ldmatrix reads;
// every thread converts 16 bytes at a time
template <typename P, int D>
__device__ __forceinline__ void convert_stage(__nv_bfloat16* conv,
                                              const uint8_t* slot) {
  using L = SmemMma<P, D>;
  constexpr int CPR = D / 16;
  for (int idx = threadIdx.x; idx < 2 * BN * CPR; idx += THREADS) {
    const int r = idx / CPR, c = idx % CPR;  // rows 0..63 K, 64..127 V
    const uint4 v = *reinterpret_cast<const uint4*>(slot + r * D + c * 16);
    uint4 lo, hi;
    word_to_bf16<P>(v.x, lo.x, lo.y);
    word_to_bf16<P>(v.y, lo.z, lo.w);
    word_to_bf16<P>(v.z, hi.x, hi.y);
    word_to_bf16<P>(v.w, hi.z, hi.w);
    uint4* dst = reinterpret_cast<uint4*>(conv + r * L::LDT + c * 16);
    dst[0] = lo;
    dst[1] = hi;
  }
}

// One unit with KW warps on each row tile, each taking BN / KW keys of
// every stage.  Register layout of a warp's 16 rows (m16n8k16
// fragments): lane (g = lane/4, t = lane%4) holds rows g and g+8, and in
// every 8-wide column tile the columns 2t and 2t+1.
template <typename P, int D, int KW>
__device__ __forceinline__ void run_unit(const Args& a, const Unit& u,
                                         unsigned char* smem) {
  using L = SmemMma<P, D>;
  constexpr int STAGES = L::STAGES, LDT = L::LDT;
  constexpr int RW = WARPS / KW;  // row tiles
  constexpr int KN = BN / KW;     // keys of a stage per warp
  constexpr int NSW = KN / 8;     // 8-key score tiles per warp
  constexpr int KQ = KN / 16;     // 16-key steps of P V
  constexpr int KD = D / 16;      // k-steps over the head dim
  constexpr int ND = D / 8;       // 8-wide output column tiles
  uint8_t* ring = smem + L::ring_off;
  __nv_bfloat16* conv = reinterpret_cast<__nv_bfloat16*>(smem + L::conv_off);
  float2* scs = reinterpret_cast<float2*>(smem + L::sc_off);
  const int* pt = reinterpret_cast<const int*>(smem + L::pt_off);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int rt = warp % RW, ks = warp / RW;
  const int kbase = ks * KN;
  const bool warp_live = rt * WM < u.live_rows;

  for (int i = 0; i < STAGES - 1; ++i) {  // the ring's first stages
    const int kt = u.s_begin + i;
    if (kt < u.s_end && stage_live(pt, u, a.log_page, kt))
      load_stage<P, D>(ring + i * L::stage_bytes, scs + i * BN, pt, a, u,
                       kt);
    cp_async_commit();
  }

  // Q fragments straight from global memory; rows past the tile are 0
  int qpos[2];
  bool row_ok[2];
  const uint32_t* qrow[2];
  for (int r = 0; r < 2; ++r) {
    const int row = rt * WM + g + r * 8;
    row_ok[r] = row < u.live_rows;
    qpos[r] = u.w.qbase + row / u.groups;
    qrow[r] = reinterpret_cast<const uint32_t*>(
        static_cast<const __nv_bfloat16*>(a.q) +
        ((int64_t)(u.w.t0 + row / u.groups) * a.H + u.kvh * u.groups +
         row % u.groups) * D);
  }
  uint32_t qf[KD][4];
  for (int k = 0; k < KD; ++k) {
    qf[k][0] = row_ok[0] ? __ldg(qrow[0] + k * 8 + t) : 0u;
    qf[k][1] = row_ok[1] ? __ldg(qrow[1] + k * 8 + t) : 0u;
    qf[k][2] = row_ok[0] ? __ldg(qrow[0] + k * 8 + 4 + t) : 0u;
    qf[k][3] = row_ok[1] ? __ldg(qrow[1] + k * 8 + 4 + t) : 0u;
  }

  const float scale2 = a.scale * LOG2E;  // scores in the log2 domain
  float acc[ND][4];
  for (int n = 0; n < ND; ++n)
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums

  for (int kt = u.s_begin, it = 0; kt < u.s_end; ++kt, ++it) {
    cp_async_wait<STAGES - 2>();  // stage kt has landed
    __syncthreads();              // ... for all, and stage kt-1 is done
    {  // refill the slot stage kt-1 held
      const int kn = kt + STAGES - 1, slot = (it + STAGES - 1) % STAGES;
      if (kn < u.s_end && stage_live(pt, u, a.log_page, kn))
        load_stage<P, D>(ring + slot * L::stage_bytes, scs + slot * BN, pt,
                         a, u, kn);
      cp_async_commit();
    }
    if (!stage_live(pt, u, a.log_page, kt)) continue;  // only holes
    const uint8_t* cur = ring + (it % STAGES) * L::stage_bytes;
    const float2* sc = scs + (it % STAGES) * BN;
    const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(cur);
    const __nv_bfloat16* Vt =
        reinterpret_cast<const __nv_bfloat16*>(cur + L::tile_bytes);
    if constexpr (!L::BF) {
      convert_stage<P, D>(conv, cur);
      __syncthreads();
      Kt = conv;
      Vt = conv + BN * LDT;
    }
    if (!warp_live) continue;

    // S = Q K^T over this warp's keys: 16 rows x KN keys, unscaled, fp32
    float s[NSW][4];
    for (int n = 0; n < NSW; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int k = 0; k < KD; ++k) {
      for (int np = 0; np < NSW / 2; ++np) {  // two key tiles per ldmatrix
        uint32_t kr[4];
        ldmatrix_x4(kr, Kt + (kbase + np * 16 + lane % 8 + lane / 16 * 8) *
                                 LDT + k * 16 + (lane / 8) % 2 * 8);
        mma_bf16(s[2 * np], qf[k], kr[0], kr[1]);
        mma_bf16(s[2 * np + 1], qf[k], kr[2], kr[3]);
      }
    }

    // scale, mask, and the running row max
    float mx[2] = {m_r[0], m_r[1]};
    for (int n = 0; n < NSW; ++n) {
      for (int e2 = 0; e2 < 2; ++e2) {
        const int kl = kbase + n * 8 + 2 * t + e2;  // key in the stage
        const int key = kt * BN + kl;
        const int col = (key >> a.log_page) - u.c_lo;
        const bool ok = col < u.ncols && pt[col] >= 0 && key < u.w.kv_len;
        for (int r = 0; r < 2; ++r) {
          float x = s[n][2 * r + e2] * scale2;
          if constexpr (P::quant) x *= sc[kl].x;
          if (!ok || !key_visible(key, qpos[r], a.window)) x = MASK;
          s[n][2 * r + e2] = x;
          mx[r] = fmaxf(mx[r], x);
        }
      }
    }
    float alpha[2];
    for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row hold its columns
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);
      m_r[r] = mx[r];
      l_r[r] *= alpha[r];
    }
    for (int n = 0; n < ND; ++n) {
      acc[n][0] *= alpha[0];
      acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1];
      acc[n][3] *= alpha[1];
    }

    // p = exp(s - m), summed in fp32, repacked as the bf16 A operand of
    // the PV product; a quantized page's V scale folds into p there
    uint32_t pf[KQ][4];
    for (int n = 0; n < NSW; ++n) {
      const float p0 = exp2f(s[n][0] - m_r[0]), p1 = exp2f(s[n][1] - m_r[0]);
      const float p2 = exp2f(s[n][2] - m_r[1]), p3 = exp2f(s[n][3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      float v0 = 1.f, v1 = 1.f;
      if constexpr (P::quant) {
        v0 = sc[kbase + n * 8 + 2 * t].y;
        v1 = sc[kbase + n * 8 + 2 * t + 1].y;
      }
      pf[n / 2][(n % 2) * 2] = pack_bf16(p0 * v0, p1 * v1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2 * v0, p3 * v1);
    }

    // acc += P V
    for (int kq = 0; kq < KQ; ++kq) {
      for (int dp = 0; dp < ND / 2; ++dp) {  // two column tiles per ldmatrix
        uint32_t vr[4];
        ldmatrix_x4_trans(vr, Vt + (kbase + kq * 16 + lane % 8 +
                                    (lane / 8) % 2 * 8) * LDT +
                                  dp * 16 + lane / 16 * 8);
        mma_bf16(acc[2 * dp], pf[kq], vr[0], vr[1]);
        mma_bf16(acc[2 * dp + 1], pf[kq], vr[2], vr[3]);
      }
    }
  }
  cp_async_wait<0>();  // nothing left in flight; the ring is free
  __syncthreads();
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
  }

  // warps that shared rows fold into the first of them, in warp order
  if constexpr (KW > 1) {
    constexpr int LDF = L::LDF;
    float* fold = reinterpret_cast<float*>(ring);
    if (ks > 0 && warp_live) {
      float* f = fold + ((ks - 1) * RW + rt) * WM * LDF;
      for (int r = 0; r < 2; ++r) {
        float* fr = f + (g + r * 8) * LDF;
        if (t == 0) {
          fr[D] = m_r[r];
          fr[D + 1] = l_r[r];
        }
        for (int n = 0; n < ND; ++n)
          *reinterpret_cast<float2*>(fr + n * 8 + 2 * t) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
    __syncthreads();
    if (ks == 0 && warp_live) {
      for (int j = 1; j < KW; ++j) {
        const float* f = fold + ((j - 1) * RW + rt) * WM * LDF;
        for (int r = 0; r < 2; ++r) {
          const float* fr = f + (g + r * 8) * LDF;
          const float mj = fr[D], lj = fr[D + 1];
          const float mn = fmaxf(m_r[r], mj);
          if (mn == -INFINITY) continue;  // no stage ran
          const float a0 = exp2f(m_r[r] - mn), a1 = exp2f(mj - mn);
          m_r[r] = mn;
          l_r[r] = a0 * l_r[r] + a1 * lj;
          for (int n = 0; n < ND; ++n) {
            const float2 v =
                *reinterpret_cast<const float2*>(fr + n * 8 + 2 * t);
            acc[n][2 * r] = a0 * acc[n][2 * r] + a1 * v.x;
            acc[n][2 * r + 1] = a0 * acc[n][2 * r + 1] + a1 * v.y;
          }
        }
      }
    }
  }
  if (ks != 0 || !warp_live) return;

  // o = acc / l (rows that never saw a valid key give 0), or the raw
  // stats of this split for rpa_combine
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    const int row = rt * WM + g + r * 8;
    const int64_t tok = u.w.t0 + row / u.groups;
    const int h = u.kvh * u.groups + row % u.groups;
    if (u.direct) {
      const bool valid = m_r[r] > MASK * 0.5f;
      const float l = fmaxf(l_r[r], 1e-30f);
      __nv_bfloat16* orow =
          static_cast<__nv_bfloat16*>(a.o) + (tok * a.H + h) * D;
      for (int n = 0; n < ND; ++n) {
        const float x0 = valid ? acc[n][2 * r] / l : 0.f;
        const float x1 = valid ? acc[n][2 * r + 1] / l : 0.f;
        *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
            __floats2bfloat162_rn(x0, x1);
      }
    } else {
      const int64_t sr = ((int64_t)u.z * a.T + tok) * a.H + h;
      if (t == 0) {
        a.part_m[sr] = m_r[r];
        a.part_l[sr] = l_r[r];
      }
      float* pa = a.part_acc + sr * D;
      for (int n = 0; n < ND; ++n)
        *reinterpret_cast<float2*>(pa + n * 8 + 2 * t) =
            make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
    }
  }
}

// One block per unit (blockIdx: q tile slot, KV head, split)
template <typename P, int D>
__global__ void __launch_bounds__(THREADS) rpa_mma(const Args a) {
  using L = SmemMma<P, D>;
  extern __shared__ __align__(128) unsigned char smem[];
  int* pt = reinterpret_cast<int*>(smem + L::pt_off);
  Unit u;
  u.groups = a.H / a.Hkv;
  u.kvh = blockIdx.y;
  u.z = blockIdx.z;
  if (u.z == 0) zero_padding<__nv_bfloat16, D>(a, u.groups);
  if (!find_work(a, BM / u.groups, u.w)) return;
  // the split's page-table columns, copied while kv_lens is in flight
  const int split_keys = a.split_stages * BN;
  u.c_lo = (u.z * split_keys) >> a.log_page;
  u.ncols = max(0, min(((u.z + 1) * split_keys - 1) >> a.log_page,
                       a.pp - 1) - u.c_lo + 1);
  const int* prow = a.page_indices + (int64_t)u.w.seq * a.pp;
  for (int i = threadIdx.x; i < u.ncols; i += THREADS)
    pt[i] = prow[u.c_lo + i];
  int kt_begin, kt_end, z0, n;
  key_range(a, u.w, kt_begin, kt_end);
  split_span(a, kt_begin, kt_end, z0, n);
  if (u.z < z0 || u.z >= z0 + n) return;  // outside the tile's keys
  u.direct = n == 1 && a.carry_m == nullptr;
  u.s_begin = max(kt_begin, u.z * a.split_stages);
  u.s_end = min(kt_end, (u.z + 1) * a.split_stages);
  u.live_rows = u.w.ntok * u.groups;
  __syncthreads();
  // warps per row tile: all four at decode (at most 16 live rows)
  const int kw = u.live_rows <= WM ? 4 : u.live_rows <= 2 * WM ? 2 : 1;
  if (kw == 4) {
    run_unit<P, D, 4>(a, u, smem);
  } else if (kw == 2) {
    run_unit<P, D, 2>(a, u, smem);
  } else {
    run_unit<P, D, 1>(a, u, smem);
  }
}

// The second kernel of a split call (or of any call with a carry): one
// warp per (token, q head) row folds the raw stats of the row's splits
// (the reference's fold_stats, in split order, in its closed form: m =
// the largest m_z, and split z weighs exp(m_z - m) in l and in acc) and
// writes o.  A live carry row comes first, as a split before split 0.
// Lanes load the splits' (m, l) together and sum l in a fixed tree; acc
// is summed in split order.  Without a carry, rows of a tile with one
// split were written by rpa_mma; padding tokens always were.
template <int D>
__global__ void __launch_bounds__(THREADS) rpa_combine(const Args a) {
  constexpr int V = D / 32;  // values per lane
  const int64_t rowid = (int64_t)blockIdx.x * WARPS + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (rowid >= (int64_t)a.T * a.H) return;
  const int tok = (int)(rowid / a.H), h = (int)(rowid % a.H);
  const int ns = min(a.num_seqs[0], a.S);
  if (ns <= 0 || tok >= a.cu_q_lens[ns]) return;
  int lo = 0, hi = ns - 1;  // the last sequence starting at or before tok
  while (lo < hi) {
    const int mid = (lo + hi + 1) / 2;
    if (a.cu_q_lens[mid] <= tok) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  const int tq = BM / (a.H / a.Hkv);
  Work w;
  tile_work(a, lo, (tok - a.cu_q_lens[lo]) / tq, tq, w);
  int kt_begin, kt_end, z0, n;
  key_range(a, w, kt_begin, kt_end);
  split_span(a, kt_begin, kt_end, z0, n);
  const int64_t crow = (int64_t)tok * a.H + h;
  const bool carry = carry_live(a, crow);
  if (n == 1 && a.carry_m == nullptr) return;
  const int64_t stride = (int64_t)a.T * a.H;  // from split z to z + 1
  const int64_t row0 = (int64_t)z0 * stride + crow;
  // the carry's m in the kernel's log2 units (finite: l > 0)
  const float cm = carry ? a.carry_m[crow] * LOG2E : -INFINITY;
  // m = max over the carry and the splits that ran a stage (l > 0; a
  // split of holes only ran none)
  float m = cm;
  for (int z = lane; z < n; z += 32)
    if (a.part_l[row0 + z * stride] > 0.f)
      m = fmaxf(m, a.part_m[row0 + z * stride]);
  m = warp_max(m);
  float l = 0.f, acc[V];
  for (int i = 0; i < V; ++i) acc[i] = 0.f;
  if (m != -INFINITY) {
    if (carry) {  // the carry first: lane 0 adds its l, every lane its acc
      const float c = exp2f(cm - m);
      if (lane == 0) l = c * a.carry_l[crow];
      const float* ca = a.carry_acc + crow * D + lane * V;
      for (int i = 0; i < V; ++i) acc[i] = c * ca[i];
    }
    for (int z0l = 0; z0l < n; z0l += 32) {
      const int z = z0l + lane;
      float c = 0.f;  // split z's weight
      if (z < n) {
        const float lz = a.part_l[row0 + z * stride];
        if (lz > 0.f) {
          c = exp2f(a.part_m[row0 + z * stride] - m);
          l += c * lz;
        }
      }
      const int cnt = min(32, n - z0l);
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        const float ck = __shfl_sync(FULL, c, k);
        const float* pa =
            a.part_acc + (row0 + (int64_t)(z0l + k) * stride) * D + lane * V;
        if (ck == 0.f) continue;
        if constexpr (V == 4) {
          const float4 v = *reinterpret_cast<const float4*>(pa);
          acc[0] += ck * v.x;
          acc[1] += ck * v.y;
          acc[2] += ck * v.z;
          acc[3] += ck * v.w;
        } else {
          const float2 v = *reinterpret_cast<const float2*>(pa);
          acc[0] += ck * v.x;
          acc[1] += ck * v.y;
        }
      }
    }
    l = warp_sum(l);
  }
  const bool valid = m > MASK * 0.5f;
  l = fmaxf(l, 1e-30f);
  __nv_bfloat16* orow = static_cast<__nv_bfloat16*>(a.o) +
                        ((int64_t)tok * a.H + h) * D + lane * V;
  for (int i = 0; i < V; i += 2)
    *reinterpret_cast<__nv_bfloat162*>(orow + i) = __floats2bfloat162_rn(
        valid ? acc[i] / l : 0.f, valid ? acc[i + 1] / l : 0.f);
}

// ---------------------------------------------------------------------------
// fp32 queries: SIMT, full fp32 products, softmax state in shared memory
// ---------------------------------------------------------------------------

template <typename P, int D>
struct SmemSimt {
  using T = typename P::T;
  static constexpr int LDQ = D + 4;  // floats
  static constexpr int LDB = D * (int)sizeof(T) + 16;  // bytes per K/V row
  static constexpr int LDS = BN + 4;  // p row, floats
  static constexpr size_t k_off = sizeof(float) * BM * LDQ;
  static constexpr size_t v_off = k_off + (size_t)BN * LDB;
  static constexpr size_t s_off = v_off + (size_t)BN * LDB;
  static constexpr size_t o_off = s_off + sizeof(float) * BM * LDS;
  static constexpr size_t stat_off = o_off + sizeof(float) * BM * LDQ;
  // m, l, alpha [BM]; kok, ksc, vsc [BN]
  static constexpr size_t bytes = stat_off + 4 * (3 * BM + 3 * BN);
};

template <typename P, int D>
__global__ void __launch_bounds__(THREADS) rpa_simt(const Args a) {
  using L = SmemSimt<P, D>;
  using T = typename P::T;
  constexpr int LDQ = L::LDQ, LDB = L::LDB, LDS = L::LDS;
  constexpr int LDK = LDB / (int)sizeof(T);  // elements per K/V row
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  uint8_t* Kb = smem + L::k_off;
  uint8_t* Vb = smem + L::v_off;
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::stat_off);
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;
  int* kok = reinterpret_cast<int*>(a_s + BM);
  float* ksc = reinterpret_cast<float*>(kok + BN);
  float* vsc = ksc + BN;
  const T* Ks = reinterpret_cast<const T*>(Kb);
  const T* Vs = reinterpret_cast<const T*>(Vb);

  const int groups = a.H / a.Hkv;
  const int kvh = blockIdx.y;
  zero_padding<float, D>(a, groups);
  const int tq = BM / groups;
  Work w;
  if (!find_work(a, tq, w)) return;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int live_rows = w.ntok * groups;
  const int* prow = a.page_indices + (int64_t)w.seq * a.pp;
  int kt_begin, kt_end;
  key_range(a, w, kt_begin, kt_end);

  load_q_tile<float, D, LDQ>(Qs, a, w, groups, kvh);
  cp_async_commit();
  // the softmax state starts empty, or at a live carry row's stats
  auto carry_row = [&](int r) -> int64_t {
    return (int64_t)(w.t0 + r / groups) * a.H + kvh * groups + r % groups;
  };
  for (int idx = threadIdx.x; idx < BM * LDQ; idx += THREADS) {
    const int r = idx / LDQ, d = idx % LDQ;
    const bool seed = r < live_rows && d < D && carry_live(a, carry_row(r));
    Os[idx] = seed ? a.carry_acc[carry_row(r) * D + d] : 0.f;
  }
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    const bool seed = r < live_rows && carry_live(a, carry_row(r));
    m_s[r] = seed ? a.carry_m[carry_row(r)] : -INFINITY;
    l_s[r] = seed ? a.carry_l[carry_row(r)] : 0.f;
  }

  for (int kt = next_tile(a, prow, kt_begin, kt_end); kt < kt_end;
       kt = next_tile(a, prow, kt + 1, kt_end)) {
    load_kv_tile<P, D, LDB>(Kb, Vb, kok, ksc, vsc, a, prow, w, kt, kvh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // each warp works on its own WM rows from here to the next tile
    const int k0 = kt * BN;
    for (int rr = 0; rr < WM; ++rr) {
      const int r = warp * WM + rr;
      if (r >= live_rows) break;  // warp-uniform
      const int qpos = w.qbase + r / groups;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < D; ++d) {
        const float qd = Qs[r * LDQ + d];
        s0 = fmaf(qd, elem_to_float(Ks + lane * LDK + d, P{}), s0);
        s1 = fmaf(qd, elem_to_float(Ks + (lane + 32) * LDK + d, P{}), s1);
      }
      s0 *= a.scale;
      s1 *= a.scale;
      if constexpr (P::quant) {
        s0 *= ksc[lane];
        s1 *= ksc[lane + 32];
      }
      if (!kok[lane] || !key_visible(k0 + lane, qpos, a.window)) s0 = MASK;
      if (!kok[lane + 32] || !key_visible(k0 + lane + 32, qpos, a.window))
        s1 = MASK;
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      float v0 = 1.f, v1 = 1.f;
      if constexpr (P::quant) {
        v0 = vsc[lane];
        v1 = vsc[lane + 32];
      }
      Ss[r * LDS + lane] = p0 * v0;
      Ss[r * LDS + lane + 32] = p1 * v1;
      __syncwarp();  // every lane has read m_s[r] before lane 0 writes it
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        m_s[r] = m_new;
        l_s[r] = l_s[r] * alpha + sum;
        a_s[r] = alpha;
      }
      __syncwarp();
      const float alpha = a_s[r];
      for (int d = lane; d < D; d += 32) {
        float acc = Os[r * LDQ + d] * alpha;
        for (int k = 0; k < BN; ++k)
          acc = fmaf(Ss[r * LDS + k], elem_to_float(Vs + k * LDK + d, P{}),
                     acc);
        Os[r * LDQ + d] = acc;
      }
    }
    __syncthreads();  // K and V are overwritten by the next tile
  }
  cp_async_wait<0>();  // the q copy when no tile ran
  __syncthreads();     // the row state when no tile ran

  float* o = static_cast<float*>(a.o);
  for (int rr = 0; rr < WM; ++rr) {
    const int r = warp * WM + rr;
    if (r >= live_rows) break;
    const float m = m_s[r];
    const float l = fmaxf(l_s[r], 1e-30f);
    const bool valid = m > MASK * 0.5f;
    float* orow = o + ((int64_t)(w.t0 + r / groups) * a.H + kvh * groups +
                       r % groups) * D;
    for (int d = lane; d < D; d += 32)
      orow[d] = valid ? Os[r * LDQ + d] / l : 0.f;
  }
}

// ---------------------------------------------------------------------------

template <typename K>
cudaError_t launch(K kernel, size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tq = BM / (a.H / a.Hkv);
  const dim3 grid((a.T + tq - 1) / tq + a.S, a.Hkv);
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// rpa_mma over (q tile slots, KV heads, splits), then rpa_combine when
// there is more than one split or a carry.  The split plan must cover the
// page table and keep a unit's slice of it within PT_MAX entries.
template <typename P, int D>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  using L = SmemMma<P, D>;
  const int64_t stages = ((int64_t)a.pp * a.page + BN - 1) / BN;
  if (a.splits < 1 || a.split_stages < 1 ||
      (int64_t)a.splits * a.split_stages < stages ||
      (((int64_t)a.split_stages * BN) >> a.log_page) + 1 > PT_MAX ||
      ((a.splits > 1 || a.carry_m != nullptr) &&
       (a.part_m == nullptr || a.part_l == nullptr ||
        a.part_acc == nullptr)))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      rpa_mma<P, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)L::bytes);
  if (err != cudaSuccess) return err;
  const int tq = BM / (a.H / a.Hkv);
  const dim3 grid((a.T + tq - 1) / tq + a.S, a.Hkv, a.splits);
  rpa_mma<P, D><<<grid, THREADS, L::bytes, stream>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || (a.splits == 1 && a.carry_m == nullptr))
    return err;
  const int64_t rows = (int64_t)a.T * a.H;
  rpa_combine<D><<<(unsigned)((rows + WARPS - 1) / WARPS), THREADS, 0,
                   stream>>>(a);
  return cudaGetLastError();
}

template <typename P, int D>
cudaError_t dispatch_q(int q_dtype, const Args& a, cudaStream_t st) {
  if (q_dtype == 0) {
    if constexpr (std::is_same<P, PF32>::value) {
      return cudaErrorInvalidValue;  // bf16 queries over fp32 pages
    } else {
      return launch_mma<P, D>(a, st);
    }
  }
  if constexpr (std::is_same<P, PBf16>::value) {
    return cudaErrorInvalidValue;  // fp32 queries over bf16 pages
  } else {
    return launch(rpa_simt<P, D>, SmemSimt<P, D>::bytes, a, st);
  }
}

template <int D>
cudaError_t dispatch_page(int q_dtype, int page_dtype, const Args& a,
                          cudaStream_t st) {
  switch (page_dtype) {
    case 0: return dispatch_q<PBf16, D>(q_dtype, a, st);
    case 1: return dispatch_q<PF32, D>(q_dtype, a, st);
    case 2: return dispatch_q<PI8, D>(q_dtype, a, st);
    case 3: return dispatch_q<PE4M3, D>(q_dtype, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q_dtype: 0 = bfloat16, 1 = float32 (o has q's dtype).  page_dtype:
// 0 = bfloat16, 1 = float32, 2 = int8, 3 = float8_e4m3fn (2 and 3 read
// `scales`).  bf16 queries take bf16, int8 or e4m3 pages; fp32 queries
// take fp32, int8 or e4m3 pages.  All tensors contiguous; the caller has
// checked shapes, D in {64, 128}, page in {16, 32, 64, 128} and
// H / Hkv <= 64.  window <= 0 means no sliding window.  bf16 queries run
// `splits` key splits of `split_stages` 64-key stages each (the
// wrapper's split_plan); with splits > 1 or a carry, part_m and part_l
// [splits, T, H] and part_acc [splits, T, H, D] (fp32) are scratch.
// fp32 queries ignore the three and the plan.  carry_m, carry_l [T, H]
// and carry_acc [T, H, D] (fp32, m in natural-log units) are the
// incoming flash carry, or all null.  Returns a cudaError_t (0 on
// success).
int dstpu_ragged_paged_attn(const void* q, const void* pages,
                            const float* scales, void* o, const int* kv_lens,
                            const int* page_indices, const int* cu_q_lens,
                            const int* num_seqs, float* part_m, float* part_l,
                            float* part_acc, const float* carry_m,
                            const float* carry_l, const float* carry_acc,
                            int q_dtype, int page_dtype,
                            int T, int H, int Hkv, int D, int S, int pp,
                            int page, int window, int splits,
                            int split_stages, float scale, void* stream) {
  int log_page = 0;
  while ((1 << log_page) < page) ++log_page;
  if ((1 << log_page) != page) return cudaErrorInvalidValue;
  const Args a{q, pages, scales, o, kv_lens, page_indices, cu_q_lens,
               num_seqs, part_m, part_l, part_acc, carry_m, carry_l,
               carry_acc, T, H, Hkv, S, pp, page, window, splits,
               split_stages, log_page, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return dispatch_page<64>(q_dtype, page_dtype, a, st);
  if (D == 128) return dispatch_page<128>(q_dtype, page_dtype, a, st);
  return cudaErrorInvalidValue;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
