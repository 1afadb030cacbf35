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
// What bounds it on this card: bytes.  Decode reads every attended page
// once per tick (page * 2 * Hkv * D * elem bytes per page) for 4 * D
// operations per (query head, key) pair, so a decode tick at 16
// sequences x ~1000 keys is ~32 MiB for ~1 GFLOP: ~10 us of HBM against
// ~1 us of tensor-core time.  A prefill chunk (512 tokens on ~1500 keys)
// has ~400x the operations per byte and is bound by operations.
//
// What this design does about it (split-KV, wgmma and TMA come later):
// - One block (4 warps) per (tile of query rows of ONE sequence, KV
//   head).  The rows of a block are (token, q head of the GQA group)
//   pairs, 64 of them: all H/Hkv q heads that share a KV head sit in one
//   block, so each K/V page is read once per (sequence, KV head, q tile)
//   and not once per q head.  In decode a sequence has one token: 4 live
//   rows of 64, the rest padding; warps without a live row skip the
//   products but still share the loads.
// - The grid is sized from host-known bounds only, ceil(T / tokens per
//   tile) + max_seqs blocks by Hkv: each block reads cu_q_lens, kv_lens
//   and its page-table row from device memory, finds its (sequence,
//   tile) and exits early when it has none.  No device value is read on
//   the host, so the launch can sit inside a captured decode block.
// - Pages are key tiles: a 64-key tile gathers its rows through the page
//   table (pages of 16, 32, 64 or 128 rows), 16-byte cp.async chunks out
//   of the [2*Hkv, D]-strided page rows, double-buffered so the next
//   tile is in flight behind this one's math.  Tiles with no valid page
//   are skipped, as are tiles wholly outside the causal bound or the
//   window.
// - bf16 queries: mma.sync m16n8k16 (bf16 in, fp32 accumulate), the
//   FlashAttention-2 register layout of flash_fwd.cu: scores, row max
//   and sum and the output accumulator stay in registers.
// - Quantized pages stay 1 byte in HBM and in shared memory.  int8 and
//   e4m3 convert to bf16 exactly (both fit bf16's 8 significant bits)
//   while the mma fragments are built from shared memory; each key's K
//   scale multiplies the fp32 score, and each key's V scale folds into
//   p before the PV product (the row sum takes p unscaled).
// - fp32 queries take a SIMT kernel in full fp32 over fp32, int8 or e4m3
//   pages, so a float32 model matches the CPU without TF32 rounding.
// - Masks use the finite -0.7 * FLT_MAX of the reference, so a wholly
//   masked tile folds away exactly once a valid key arrives.
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
  int T, H, Hkv, S, pp, page, window;  // window <= 0: none
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

// two 1-byte values -> bf16x2 (exact for int8 and e4m3)
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint8_t lo, uint8_t hi,
                                                     PI8 tag) {
  return pack_bf16(byte_to_float(static_cast<int8_t>(lo), tag),
                   byte_to_float(static_cast<int8_t>(hi), tag));
}
__device__ __forceinline__ uint32_t bytes_to_bf16x2(uint8_t lo, uint8_t hi,
                                                     PE4M3) {
  const __nv_fp8x2_storage_t pair =
      static_cast<__nv_fp8x2_storage_t>(lo | (hi << 8));
  const float2 f = __half22float2(__half2(__nv_cvt_fp8x2_to_halfraw2(
      pair, __NV_E4M3)));
  return pack_bf16(f.x, f.y);
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

// Sequence j owns ceil(q_len_j / tq) tiles; block x takes the x-th tile
// in sequence order.  Every thread walks the same metadata.
__device__ __forceinline__ bool find_work(const Args& a, int tq, Work& w) {
  const int ns = min(a.num_seqs[0], a.S);
  int tile = blockIdx.x;
  for (int j = 0; j < ns; ++j) {
    const int c0 = a.cu_q_lens[j], qlen = a.cu_q_lens[j + 1] - c0;
    const int nt = qlen > 0 ? (qlen + tq - 1) / tq : 0;
    if (tile < nt) {
      w.seq = j;
      w.t0 = c0 + tile * tq;
      w.ntok = min(tq, qlen - tile * tq);
      w.kv_len = a.kv_lens[j];
      w.qbase = w.kv_len - qlen + tile * tq;
      return true;
    }
    tile -= nt;
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

// ---------------------------------------------------------------------------
// bf16 queries: mma.sync with register-resident softmax state
// ---------------------------------------------------------------------------

template <typename P, int D>
struct SmemMma {
  static constexpr int LDQ = D + 8;  // bf16 elements: 16 bytes of pad
  static constexpr int LDB = D * (int)sizeof(typename P::T) + 16;  // bytes
  static constexpr size_t q_bytes = sizeof(__nv_bfloat16) * BM * LDQ;
  static constexpr size_t kv_bytes = (size_t)BN * LDB;   // one K or V tile
  static constexpr size_t k_off = q_bytes;               // K[2]
  static constexpr size_t v_off = k_off + 2 * kv_bytes;  // V[2]
  static constexpr size_t aux_off = v_off + 2 * kv_bytes;
  // kok[2][BN] ints, ksc[2][BN], vsc[2][BN] floats
  static constexpr size_t bytes = aux_off + 3 * 2 * BN * 4;
};

// Register layout of one warp's 16 rows (m16n8k16 fragments): lane
// (g = lane/4, t = lane%4) holds rows g and g+8, and in every 8-wide
// column tile the columns 2t and 2t+1.
template <typename P, int D>
__global__ void __launch_bounds__(THREADS) rpa_mma(const Args a) {
  using L = SmemMma<P, D>;
  using T = typename P::T;
  constexpr bool BF = sizeof(T) == 2;  // bf16 pages: ldmatrix operands
  constexpr int LDQ = L::LDQ, LDB = L::LDB;
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int ND = D / 8;   // 8-wide output column tiles
  constexpr int NS = BN / 8;  // 8-wide score column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* Kb = smem + L::k_off;
  uint8_t* Vb = smem + L::v_off;
  int* kok = reinterpret_cast<int*>(smem + L::aux_off);
  float* ksc = reinterpret_cast<float*>(kok + 2 * BN);
  float* vsc = ksc + 2 * BN;

  const int groups = a.H / a.Hkv;
  const int kvh = blockIdx.y;
  zero_padding<__nv_bfloat16, D>(a, groups);
  const int tq = BM / groups;  // tokens per tile
  Work w;
  if (!find_work(a, tq, w)) return;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int live_rows = w.ntok * groups;
  const bool warp_live = warp * WM < live_rows;
  int qpos[2];
  bool row_ok[2];
  for (int r = 0; r < 2; ++r) {
    const int row = warp * WM + g + r * 8;
    row_ok[r] = row < live_rows;
    qpos[r] = w.qbase + row / groups;
  }
  const int* prow = a.page_indices + (int64_t)w.seq * a.pp;
  int kt_begin, kt_end;
  key_range(a, w, kt_begin, kt_end);
  int kt = next_tile(a, prow, kt_begin, kt_end);

  load_q_tile<__nv_bfloat16, D, LDQ>(Qs, a, w, groups, kvh);
  if (kt < kt_end)
    load_kv_tile<P, D, LDB>(Kb, Vb, kok, ksc, vsc, a, prow, w, kt, kvh);
  cp_async_commit();

  const float scale2 = a.scale * LOG2E;  // scores in the log2 domain
  float acc[ND][4];
  for (int n = 0; n < ND; ++n)
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums
  uint32_t qf[KD][4];

  for (int it = 0; kt < kt_end; ++it) {
    const int cur = it & 1;
    const int nxt = next_tile(a, prow, kt + 1, kt_end);
    if (nxt < kt_end) {  // next tile in flight behind this one's math
      const int o = cur ^ 1;
      load_kv_tile<P, D, LDB>(Kb + o * L::kv_bytes, Vb + o * L::kv_bytes,
                              kok + o * BN, ksc + o * BN, vsc + o * BN, a,
                              prow, w, nxt, kvh);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (warp_live) {
      if (it == 0) {
        for (int k = 0; k < KD; ++k)
          ldmatrix_x4(qf[k], Qs + (warp * WM + lane % 16) * LDQ + k * 16 +
                                 lane / 16 * 8);
      }
      const uint8_t* Kt = Kb + cur * L::kv_bytes;
      const uint8_t* Vt = Vb + cur * L::kv_bytes;
      const int* kk = kok + cur * BN;
      const float* ks = ksc + cur * BN;
      const float* vs = vsc + cur * BN;

      // S = Q K^T: 16 rows x 64 keys, unscaled, fp32
      float s[NS][4];
      for (int n = 0; n < NS; ++n)
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
      for (int k = 0; k < KD; ++k) {
        if constexpr (BF) {
          const __nv_bfloat16* Kh = reinterpret_cast<const __nv_bfloat16*>(Kt);
          constexpr int LDK = LDB / 2;
          for (int np = 0; np < NS / 2; ++np) {  // two key tiles per ldmatrix
            uint32_t kr[4];
            ldmatrix_x4(kr, Kh + (np * 16 + lane % 8 + lane / 16 * 8) * LDK +
                                k * 16 + (lane / 8) % 2 * 8);
            mma_bf16(s[2 * np], qf[k], kr[0], kr[1]);
            mma_bf16(s[2 * np + 1], qf[k], kr[2], kr[3]);
          }
        } else {
          for (int n = 0; n < NS; ++n) {
            // B[k][n] = K[key n*8+g][d k*16+2t(+1)] and [d +8]
            const uint8_t* kp = Kt + (n * 8 + g) * LDB + k * 16 + 2 * t;
            const uint32_t b0 = bytes_to_bf16x2(kp[0], kp[1], P{});
            const uint32_t b1 = bytes_to_bf16x2(kp[8], kp[9], P{});
            mma_bf16(s[n], qf[k], b0, b1);
          }
        }
      }

      // scale, mask, and the running row max
      const int k0 = kt * BN;
      float mx[2] = {m_r[0], m_r[1]};
      for (int n = 0; n < NS; ++n) {
        for (int e = 0; e < 4; ++e) {
          const int kl = n * 8 + 2 * t + (e & 1);
          float x = s[n][e] * scale2;
          if constexpr (P::quant) x *= ks[kl];
          if (!kk[kl] || !key_visible(k0 + kl, qpos[e / 2], a.window))
            x = MASK;
          s[n][e] = x;
          mx[e / 2] = fmaxf(mx[e / 2], x);
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
      uint32_t pf[BN / 16][4];
      for (int n = 0; n < NS; ++n) {
        const float p0 = exp2f(s[n][0] - m_r[0]), p1 = exp2f(s[n][1] - m_r[0]);
        const float p2 = exp2f(s[n][2] - m_r[1]), p3 = exp2f(s[n][3] - m_r[1]);
        l_r[0] += p0 + p1;
        l_r[1] += p2 + p3;
        float v0 = 1.f, v1 = 1.f;
        if constexpr (P::quant) {
          v0 = vs[n * 8 + 2 * t];
          v1 = vs[n * 8 + 2 * t + 1];
        }
        pf[n / 2][(n % 2) * 2] = pack_bf16(p0 * v0, p1 * v1);
        pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2 * v0, p3 * v1);
      }

      // acc += P V
      for (int kq = 0; kq < BN / 16; ++kq) {
        if constexpr (BF) {
          const __nv_bfloat16* Vh = reinterpret_cast<const __nv_bfloat16*>(Vt);
          constexpr int LDV = LDB / 2;
          for (int dp = 0; dp < ND / 2; ++dp) {  // two column tiles per ldmatrix
            uint32_t vr[4];
            ldmatrix_x4_trans(
                vr, Vh + (kq * 16 + lane % 8 + (lane / 8) % 2 * 8) * LDV +
                        dp * 16 + lane / 16 * 8);
            mma_bf16(acc[2 * dp], pf[kq], vr[0], vr[1]);
            mma_bf16(acc[2 * dp + 1], pf[kq], vr[2], vr[3]);
          }
        } else {
          // B[k][n] = V[key kq*16+2t(+1) (+8)][d n*8+g]
          const uint8_t* v0p = Vt + (kq * 16 + 2 * t) * LDB + g;
          for (int n = 0; n < ND; ++n) {
            const uint8_t* vp = v0p + n * 8;
            const uint32_t b0 = bytes_to_bf16x2(vp[0], vp[LDB], P{});
            const uint32_t b1 =
                bytes_to_bf16x2(vp[8 * LDB], vp[9 * LDB], P{});
            mma_bf16(acc[n], pf[kq], b0, b1);
          }
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
    kt = nxt;
  }
  cp_async_wait<0>();  // nothing left in flight when no tile ran

  // finalize: o = acc / l; rows that never saw a valid key give 0
  __nv_bfloat16* o = static_cast<__nv_bfloat16*>(a.o);
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
    if (!row_ok[r]) continue;
    const int row = warp * WM + g + r * 8;
    const bool valid = m_r[r] > MASK * 0.5f;
    const float l = fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* orow =
        o + ((int64_t)(w.t0 + row / groups) * a.H + kvh * groups +
             row % groups) * D;
    for (int n = 0; n < ND; ++n) {
      const float x0 = valid ? acc[n][2 * r] / l : 0.f;
      const float x1 = valid ? acc[n][2 * r + 1] / l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
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
  for (int idx = threadIdx.x; idx < BM * LDQ; idx += THREADS) Os[idx] = 0.f;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
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

template <typename P, int D>
cudaError_t dispatch_q(int q_dtype, const Args& a, cudaStream_t st) {
  if (q_dtype == 0) {
    if constexpr (std::is_same<P, PF32>::value) {
      return cudaErrorInvalidValue;  // bf16 queries over fp32 pages
    } else {
      return launch(rpa_mma<P, D>, SmemMma<P, D>::bytes, a, st);
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
// H / Hkv <= 64.  window <= 0 means no sliding window.  Returns a
// cudaError_t (0 on success).
int dstpu_ragged_paged_attn(const void* q, const void* pages,
                            const float* scales, void* o, const int* kv_lens,
                            const int* page_indices, const int* cu_q_lens,
                            const int* num_seqs, int q_dtype, int page_dtype,
                            int T, int H, int Hkv, int D, int S, int pp,
                            int page, int window, float scale, void* stream) {
  const Args a{q, pages, scales, o, kv_lens, page_indices, cu_q_lens,
               num_seqs, T, H, Hkv, S, pp, page, window, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return dispatch_page<64>(q_dtype, page_dtype, a, st);
  if (D == 128) return dispatch_page<128>(q_dtype, page_dtype, a, st);
  return cudaErrorInvalidValue;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
