// Flash-attention forward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (deepspeed_tpu_torch/ops/flash_attention.py).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py::_flash_fwd_kernel, the
// Pallas TPU kernel launched by _flash_fwd_pallas.  Same function: online-
// softmax attention over q [B,H,S,D] and k, v [B,Hkv,Sk,D] (kv head =
// h / (H/Hkv)), causal alignment bottom-right (offset Sk - S), returning
// o in q's dtype and the per-row log-sum-exp in fp32.  Rows that see no
// valid key give o = 0 and lse = +inf.
//
// What bounds it on this card: two chained matrix products per key tile,
// 4*B*H*D*(valid q-k pairs) operations against (q + k + v + o) bytes.  At
// the serving shape (B=4, H=32, S=Sk=1000, D=128, causal) that is about
// 33 GFLOP against 82 MB, i.e. ~33 us at 989 TFLOP/s bf16 versus ~25 us at
// 3.35 TB/s: compute-bound, so the tensor cores must do the products and
// nothing else may stall them.  Only wgmma reaches Hopper's full tensor-
// core rate, and only TMA feeds it without spending the math warps'
// issue slots on copies.
//
// The bf16 kernel (flash_fwd_hopper), built on hopper.cuh:
// - Tiles.  Persistent blocks of three warpgroups, one per SM, each
//   walking (128-row q tile, head, batch) tiles in a fixed order that
//   puts the heaviest causal q tiles first.  Warpgroup 0 is the
//   producer; warpgroups 1 and 2 are consumers of 64 q rows each, so
//   every K/V tile in shared memory feeds 128 rows.  Key tiles are 128
//   rows.  The TPU kernel carries m, l and acc across a sequential grid
//   axis in VMEM scratch; here a loop inside the block walks the key
//   tiles, and key tiles past the q tile's causal diagonal are never
//   loaded.  Only tiles that cross the diagonal or the ragged key edge
//   pay for the mask.  Persistence lets the producer load the next
//   tile's Q and first K/V while the consumers finish this one.
// - Shared memory (128-byte swizzle, 64 bf16 columns a row): Q, an
//   output staging tile, then a ring of K and V stages.  D=128: Q 32 KB
//   + O 32 KB + 2 stages x (K 32 KB + V 32 KB) = 192 KB; D=64: 16 + 16
//   + 4 x 32 = 160 KB.  One block per SM (the register file is the limit
//   anyway).
// - TMA.  One thread of the producer loads each tile's Q once and K and
//   V stage by stage through 4-D tensor maps (D, seq, heads, batch) over the
//   caller's strides, so [B,S,H,D] projections need no copy; the k and v
//   maps run over Hkv heads and the block reads kv head h / groups.  A
//   D=128 tile is two boxes of 64 columns (the swizzle's limit).  Rows
//   past S or Sk arrive as zeros; the expected byte count is always the
//   full box.  Q has a "full" and an "empty" barrier (freed after the
//   tile's last Q K^T); each stage has a "full" barrier for K and one for
//   V (Q K^T starts before V lands), and an "empty" barrier for each that
//   all 256 consumer threads arrive on: K once Q K^T is done, V once P V
//   is.
// - wgmma.  S = Q K^T is m64n128k16 with both operands in shared memory
//   (K-major descriptors, 32 bytes further per k16 step).  O += P V is
//   m64nDk16 with P from registers: the fp32 scores become bf16 pairs in
//   place, since a wgmma accumulator has, warp by warp, the layout of an
//   m16n8k16 A fragment; V is the MN-major B operand (transpose-B), lbo =
//   the 16 KB between its 64-column halves.  The softmax state (row max
//   and sum) and O stay in registers; each row lives in one quad of
//   lanes; scores are in the log2 domain with sm_scale applied to the
//   fp32 score.
// - Overlap inside a warpgroup: tile j's Q K^T is issued, then tile
//   j-1's P V; tile j's softmax (max, exp, sum) runs while that P V is on
//   the tensor cores, and only the bf16 packing of p waits for it.
//   exp2 is ex2.approx.ftz.  The two consumer warpgroups interleave on
//   their own: making them take turns (ping-pong over named barriers)
//   measured slower here once blocks were persistent.
// - setmaxnreg: the producer drops to 24 registers a thread, the
//   consumers rise to 240 (128 x 24 + 256 x 240 = 64,512 of 65,536).
// - Epilogue.  o = acc / l (0 for rows that saw no valid key) is written
//   as bf16 into the warpgroup's rows of the staging tile in the swizzled
//   layout, and one TMA store per 64 columns writes it to the [B,S,H,D]
//   output, dropping rows past S; lse (+inf for those rows) is stored
//   directly.
//
// fp32 inputs take a SIMT kernel in full fp32, so a float32 model matches
// the CPU without TF32 rounding.  It is slow and off the serving path.
// It keeps its 64-row tiles, plain loads and its shared-memory softmax
// state, addressing q, k, v and o through batch, head and sequence
// strides.
//
// Shared memory is above the 48 KB static limit, so the launcher raises
// the dynamic limit first, and it returns cudaGetLastError() so that a
// refused launch is seen.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BM = 64;             // fp32 kernel: q rows per block
constexpr int BN = 64;             // fp32 kernel: key rows per tile
constexpr int WARPS = 4;           // each warp owns WM q rows
constexpr int WM = BM / WARPS;
constexpr int THREADS = WARPS * 32;
constexpr unsigned FULL = 0xffffffffu;
// DEFAULT_MASK_VALUE of the reference kernel
constexpr float MASK = -0.7f * FLT_MAX;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Args {
  const void *q, *k, *v;
  void* o;
  float* lse;
  int B, H, Hkv, S, Sk;
  int64_t qs[3], ks[3], vs[3], os[3];
  float scale;
  int causal;
};

// Key tiles of TN rows that a q tile of TM rows needs: causal rows see no
// key past the diagonal of the tile's last row.
template <int TM = BM, int TN = BN>
__device__ __forceinline__ int key_tiles(int q0, int S, int Sk, int causal) {
  const int nk = (Sk + TN - 1) / TN;
  if (!causal) return nk;
  const int last = min(q0 + TM, S) - 1 + (Sk - S);
  return last < 0 ? 0 : min(nk, last / TN + 1);
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, warp-specialized wgmma
// ---------------------------------------------------------------------------

constexpr int HM = 128;            // q rows per tile (two warpgroups of 64)
constexpr int HN = 128;            // key rows per tile
constexpr int HTHREADS = 3 * 128;  // producer + two consumer warpgroups
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 240;

template <int D>
struct Hopper {
  static constexpr int STAGES = D == 128 ? 2 : 4;
  static constexpr int HALVES = D / 64;            // 64-column boxes a tile
  static constexpr uint32_t HALF = 128 * 128;      // bytes: 128 rows x 64
  static constexpr uint32_t TILE = HALVES * HALF;  // Q, O, or K or V
  static constexpr uint32_t Q_OFF = 0;
  static constexpr uint32_t O_OFF = TILE;          // output staging
  static constexpr uint32_t K_OFF = 2 * TILE;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * TILE;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * TILE;
  // barriers: q_full, q_empty, then k_full, v_full, k_empty and v_empty
  // per stage; 1 KB of slack to align the base to the swizzle's 1024
  static constexpr size_t bytes = BAR_OFF + 8 * (2 + 4 * STAGES) + 1024;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// 2^x on the special-function unit, denormal results flushed to 0 (p
// below 2^-126 is lost in bf16 anyway)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t x) {
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(x) : "memory");
}

// S = Q K^T for one key tile, 64 rows x 128 keys, unscaled fp32: issued,
// not committed
template <int D>
__device__ __forceinline__ void qk_issue(float (&sc)[64], uint32_t qa,
                                         uint32_t kt) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint32_t off = (kd / 4) * Hopper<D>::HALF + (kd % 4) * 32;
    hopper::wgmma_m64n128k16_ss(sc, hopper::wgmma_desc(qa + off, 16, 1024),
                                hopper::wgmma_desc(kt + off, 16, 1024),
                                kd > 0);
  }
}

// acc += P V for one key tile: issued, not committed
template <int D>
__device__ __forceinline__ void pv_issue(float (&acc)[D / 2],
                                         const uint32_t (&pf)[HN / 16][4],
                                         uint32_t vt) {
#pragma unroll
  for (int kk = 0; kk < HN / 16; ++kk) {
    const uint64_t desc =
        hopper::wgmma_desc(vt + kk * 16 * 128, Hopper<D>::HALF, 1024);
    if constexpr (D == 128)
      hopper::wgmma_m64n128k16_rs(acc, pf[kk], desc, 1);
    else
      hopper::wgmma_m64n64k16_rs(acc, pf[kk], desc, 1);
  }
}

// The online softmax of one score tile, in place: scale, mask, the new
// row max (alpha rescales what came before), p = exp(s - m) in fp32 and
// its row sum.  `edge`: the tile crosses the causal diagonal or the
// ragged key edge.  Lane (g, t) holds rows row0 and row0 + 8.
__device__ __forceinline__ void softmax_tile(float (&sc)[64], float (&m_r)[2],
                                             float (&l_r)[2],
                                             float (&alpha)[2], int k0,
                                             bool edge, int row0, int t,
                                             int Sk, int offset, int causal,
                                             float scale2) {
  float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
  for (int n = 0; n < HN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = sc[4 * n + e] * scale2;
      if (edge) {
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        const int lim = causal ? row0 + (e / 2) * 8 + offset : Sk - 1;
        if (key >= Sk || key > lim) x = MASK;
      }
      sc[4 * n + e] = x;
      mx[e / 2] = fmaxf(mx[e / 2], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {  // the 4 lanes of a row hold its columns
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(FULL, mx[r], 2));
    alpha[r] = fast_exp2(m_r[r] - mx[r]);
    m_r[r] = mx[r];
    l_r[r] *= alpha[r];
  }
#pragma unroll
  for (int n = 0; n < HN / 8; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[4 * n + e] = fast_exp2(sc[4 * n + e] - m_r[e / 2]);
      l_r[e / 2] += sc[4 * n + e];
    }
  }
}

// p in bf16 pairs (p enters the PV product in v's dtype, as in the
// reference), as the A fragments of the PV product
__device__ __forceinline__ void pack_p(const float (&sc)[64],
                                       uint32_t (&pf)[HN / 16][4]) {
#pragma unroll
  for (int n = 0; n < HN / 8; ++n) {
    pf[n / 2][(n % 2) * 2] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
    pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
  }
}

template <int D>
__device__ __forceinline__ void rescale(float (&acc)[D / 2],
                                        const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    acc[4 * n] *= alpha[0];
    acc[4 * n + 1] *= alpha[0];
    acc[4 * n + 2] *= alpha[1];
    acc[4 * n + 3] *= alpha[1];
  }
}

// Tile t of the run, heaviest first: every head's and batch's last q tile
// (the most causal work), then the next-to-last ones, and so on.
struct TileCoord {
  int i, h, b;
};
__device__ __forceinline__ TileCoord tile_coord(int t, int H, int B,
                                                int q_tiles) {
  const int r = t % (H * B);
  return {q_tiles - 1 - t / (H * B), r % H, r / H};
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
flash_fwd_hopper(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap to,
                 float* __restrict__ lse, int B, int H, int groups, int S,
                 int Sk, float scale, int causal) {
  using C = Hopper<D>;
  constexpr int ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  // barriers: q_full, q_empty, then per stage k_full, v_full, k_empty,
  // v_empty
  const uint32_t q_full = base + C::BAR_OFF, q_empty = q_full + 8;
  auto bar = [&](int kind, int s) {
    return q_full + 8u * (2 + kind * ST + s);
  };
  auto k_full = [&](int s) { return bar(0, s); };
  auto v_full = [&](int s) { return bar(1, s); };
  auto k_empty = [&](int s) { return bar(2, s); };
  auto v_empty = [&](int s) { return bar(3, s); };
  auto k_tile = [&](int s) { return base + C::K_OFF + s * C::TILE; };
  auto v_tile = [&](int s) { return base + C::V_OFF + s * C::TILE; };
  const int q_tiles = (S + HM - 1) / HM;
  const int tiles = q_tiles * H * B;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
    hopper::mbar_init(q_empty, 256);  // every consumer thread
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(k_full(s), 1);
      hopper::mbar_init(v_full(s), 1);
      hopper::mbar_init(k_empty(s), 256);
      hopper::mbar_init(v_empty(s), 256);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread keeps Q and the K/V ring full, running ahead
    // into the block's next tile.  Consumers free Q after a tile's last
    // Q K^T, K of tile j once Q K_j^T is done and V only after P V_j.
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0, nq = 0;  // key tiles and q tiles loaded so far
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const TileCoord c = tile_coord(t, H, B, q_tiles);
        const int nk = key_tiles<HM, HN>(c.i * HM, S, Sk, causal);
        if (nk == 0) continue;
        hopper::mbar_wait(q_empty, (nq++ & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, C::TILE);
        for (int x = 0; x < C::HALVES; ++x)
          hopper::tma_load_4d(base + C::Q_OFF + x * C::HALF, &tq, q_full,
                              x * 64, c.i * HM, c.h, c.b);
        const int hk = c.h / groups;
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % ST;
          const uint32_t free_parity = ((it / ST) & 1) ^ 1;
          hopper::mbar_wait(k_empty(s), free_parity);
          hopper::mbar_expect_tx(k_full(s), C::TILE);
          for (int x = 0; x < C::HALVES; ++x)
            hopper::tma_load_4d(k_tile(s) + x * C::HALF, &tk, k_full(s),
                                x * 64, j * HN, hk, c.b);
          hopper::mbar_wait(v_empty(s), free_parity);
          hopper::mbar_expect_tx(v_full(s), C::TILE);
          for (int x = 0; x < C::HALVES; ++x)
            hopper::tma_load_4d(v_tile(s) + x * C::HALF, &tv, v_full(s),
                                x * 64, j * HN, hk, c.b);
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns rows 64cw..64cw+63 of each q tile
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  constexpr int ND = D / 8;    // 8-wide output column groups
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int offset = Sk - S;           // bottom-right causal alignment
  const float scale2 = scale * LOG2E;  // scores in the log2 domain
  // this warpgroup's 64 rows inside each 64-column half of Q and of the
  // output staging tile
  const uint32_t qa = base + C::Q_OFF + cw * 64 * 128;
  const uint32_t oa = base + C::O_OFF + cw * 64 * 128;

  // Tile j's Q K^T runs on the tensor cores beside tile j-1's P V, and
  // tile j's softmax (max, exp, sum) beside that P V.
  int it = 0, nq = 0;  // key tiles and q tiles consumed so far
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const TileCoord c = tile_coord(t, H, B, q_tiles);
    const int nk = key_tiles<HM, HN>(c.i * HM, S, Sk, causal);
    const int wq0 = c.i * HM + 64 * cw;    // the warpgroup's first row
    const int row0 = wq0 + 16 * warp + g;  // this lane's rows: row0, +8
    auto edge = [&](int j) {
      return (j + 1) * HN > Sk ||
             (causal && (j + 1) * HN - 1 > wq0 + offset);
    };
    float acc[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) acc[n] = 0.f;
    float m_r[2] = {-INFINITY, -INFINITY};
    float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums
    float alpha[2];
    float sc[64];
    uint32_t pf[HN / 16][4];

    if (nk > 0) {
      const int s = it % ST;
      hopper::mbar_wait(q_full, nq++ & 1);
      hopper::mbar_wait(k_full(s), (it / ST) & 1);
      hopper::wgmma_fence();
      qk_issue<D>(sc, qa, k_tile(s));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(sc);
      hopper::mbar_arrive(k_empty(s));
      if (nk == 1) hopper::mbar_arrive(q_empty);
      softmax_tile(sc, m_r, l_r, alpha, 0, edge(0), row0, t4, Sk, offset,
                   causal, scale2);
      pack_p(sc, pf);
    }
    for (int j = 1; j < nk; ++j) {
      const int s = (it + j) % ST, sp = (it + j - 1) % ST;
      hopper::mbar_wait(k_full(s), ((it + j) / ST) & 1);
      hopper::wgmma_fence();
      qk_issue<D>(sc, qa, k_tile(s));
      hopper::wgmma_commit();
      rescale<D>(acc, alpha);  // alpha of tile j-1, before its P V adds in
      hopper::mbar_wait(v_full(sp), ((it + j - 1) / ST) & 1);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
      pv_issue<D>(acc, pf, v_tile(sp));
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // Q K_j^T is in
      hopper::fence_operands(sc);
      hopper::mbar_arrive(k_empty(s));
      if (j == nk - 1) hopper::mbar_arrive(q_empty);
      softmax_tile(sc, m_r, l_r, alpha, j * HN, edge(j), row0, t4, Sk,
                   offset, causal, scale2);
      hopper::wgmma_wait<0>();  // P V_{j-1} is in: pf and V_{j-1} are free
      hopper::fence_operands(acc);
      hopper::mbar_arrive(v_empty(sp));
      pack_p(sc, pf);
    }
    if (nk > 0) {
      const int s = (it + nk - 1) % ST;
      rescale<D>(acc, alpha);
      hopper::mbar_wait(v_full(s), ((it + nk - 1) / ST) & 1);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
      pv_issue<D>(acc, pf, v_tile(s));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(acc);
      hopper::mbar_arrive(v_empty(s));
    }
    it += nk;

    // finalize: o = acc / l; rows that never saw a valid key give 0, +inf
    bool valid[2];
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
      l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
      valid[r] = m_r[r] > MASK * 0.5f;
      l_r[r] = fmaxf(l_r[r], 1e-30f);
      inv[r] = 1.f / l_r[r];
    }
    // o in bf16 into the staging tile, in the swizzled layout of a 64 x 64
    // box, once the previous tile's store has read it
    if (tid == 0) hopper::tma_store_wait();
    hopper::named_barrier_sync(1 + cw, 128);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int rr = 16 * warp + g + 8 * r;  // row within the warpgroup
        const uint32_t addr = oa + (n / 8) * C::HALF + rr * 128 +
                              (((n % 8) ^ (rr % 8)) << 4) + 4 * t4;
        st_shared_u32(addr,
                      valid[r] ? pack_bf16(acc[4 * n + 2 * r] * inv[r],
                                           acc[4 * n + 2 * r + 1] * inv[r])
                               : 0u);
      }
    }
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + cw, 128);
    if (tid == 0) {
      for (int x = 0; x < C::HALVES; ++x)
        hopper::tma_store_4d(&to, oa + x * C::HALF, x * 64, wq0, c.h, c.b);
      hopper::tma_store_commit();
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = row0 + r * 8;
      if (t4 == 0 && qpos < S)
        lse[((int64_t)c.b * H + c.h) * S + qpos] =
            valid[r] ? m_r[r] * LN2 + logf(l_r[r]) : INFINITY;
    }
  }
  if (tid == 0) hopper::tma_store_wait();
}

// ---------------------------------------------------------------------------
// fp32: SIMT, full fp32 products, softmax state in shared memory
// ---------------------------------------------------------------------------

template <int D>
struct SmemF32 {
  static constexpr int LDT = D + 4;        // q, k, v rows
  static constexpr int LDS = BN + 4;       // scores, then probabilities
  static constexpr size_t k_off = sizeof(float) * BM * LDT;
  static constexpr size_t v_off = k_off + sizeof(float) * BN * LDT;
  static constexpr size_t s_off = v_off + sizeof(float) * BN * LDT;
  static constexpr size_t o_off = s_off + sizeof(float) * BM * LDS;
  static constexpr size_t stat_off = o_off + sizeof(float) * BM * LDT;
  static constexpr size_t bytes = stat_off + sizeof(float) * 3 * BM;
};

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(FULL, x, off));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(FULL, x, off);
  return x;
}

template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t stride, int rows) {
  constexpr int CPR = D / 4;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      val = *reinterpret_cast<const float4*>(src + (int64_t)r * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, float* __restrict__ o,
              float* __restrict__ lse, int H, int groups, int S, int Sk,
              int64_t qsb, int64_t qsh, int64_t qss, int64_t ksb,
              int64_t ksh, int64_t kss, int64_t vsb, int64_t vsh,
              int64_t vss, int64_t osb, int64_t osh, int64_t oss,
              float scale, int causal) {
  using L = SmemF32<D>;
  constexpr int LDT = L::LDT, LDS = L::LDS;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = reinterpret_cast<float*>(smem + L::k_off);
  float* Vs = reinterpret_cast<float*>(smem + L::v_off);
  float* Ss = reinterpret_cast<float*>(smem + L::s_off);
  float* Os = reinterpret_cast<float*>(smem + L::o_off);
  float* m_s = reinterpret_cast<float*>(smem + L::stat_off);
  float* l_s = m_s + BM;
  float* a_s = l_s + BM;

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = i * BM;
  const int offset = Sk - S;
  const float* kb = k + b * ksb + (h / groups) * ksh;
  const float* vb = v + b * vsb + (h / groups) * vsh;
  const int nk = key_tiles(q0, S, Sk, causal);

  load_tile_f32<D, LDT>(Qs, q + b * qsb + h * qsh + q0 * qss, qss,
                        min(BM, S - q0));
  for (int idx = threadIdx.x; idx < BM * LDT; idx += THREADS) Os[idx] = 0.f;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    m_s[r] = -INFINITY;
    l_s[r] = 0.f;
  }
  __syncthreads();

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BN;
    load_tile_f32<D, LDT>(Ks, kb + k0 * kss, kss, min(BN, Sk - k0));
    load_tile_f32<D, LDT>(Vs, vb + k0 * vss, vss, min(BN, Sk - k0));
    __syncthreads();
    // each warp works on its own WM rows from here to the next tile
    const bool edge = (k0 + BN > Sk) || (causal && k0 + BN - 1 > q0 + offset);
    for (int rr = 0; rr < WM; ++rr) {
      const int r = warp * WM + rr;
      float s0 = 0.f, s1 = 0.f;
      for (int d = 0; d < D; ++d) {
        s0 = fmaf(Qs[r * LDT + d], Ks[lane * LDT + d], s0);
        s1 = fmaf(Qs[r * LDT + d], Ks[(lane + 32) * LDT + d], s1);
      }
      s0 *= scale;
      s1 *= scale;
      if (edge) {
        const int lim = causal ? q0 + r + offset : Sk - 1;
        const int kp0 = k0 + lane, kp1 = k0 + lane + 32;
        if (kp0 >= Sk || kp0 > lim) s0 = MASK;
        if (kp1 >= Sk || kp1 > lim) s1 = MASK;
      }
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      const float sum = warp_sum(p0 + p1);
      Ss[r * LDS + lane] = p0;
      Ss[r * LDS + lane + 32] = p1;
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
        float a = Os[r * LDT + d] * alpha;
        for (int kk = 0; kk < BN; ++kk)
          a = fmaf(Ss[r * LDS + kk], Vs[kk * LDT + d], a);
        Os[r * LDT + d] = a;
      }
    }
    __syncthreads();  // K and V are overwritten by the next tile
  }

  for (int rr = 0; rr < WM; ++rr) {
    const int r = warp * WM + rr;
    const int qpos = q0 + r;
    if (qpos >= S) break;
    const float m = m_s[r];
    const float l = fmaxf(l_s[r], 1e-30f);
    const bool valid = m > MASK * 0.5f;
    float* orow = o + b * osb + h * osh + qpos * oss;
    for (int d = lane; d < D; d += 32)
      orow[d] = valid ? Os[r * LDT + d] / l : 0.f;
    if (lane == 0)
      lse[((int64_t)b * H + h) * S + qpos] = valid ? m + logf(l) : INFINITY;
  }
}

// ---------------------------------------------------------------------------

template <int D>
int launch_hopper(const Args& a, cudaStream_t stream) {
  hopper::EncodeTiled encode;
  cudaError_t err = hopper::encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];  // q, k, v, o
  const void* ptrs[4] = {a.q, a.k, a.v, a.o};
  const int64_t* strides[4] = {a.qs, a.ks, a.vs, a.os};
  const int rows[4] = {a.S, a.Sk, a.Sk, a.S};
  const int heads[4] = {a.H, a.Hkv, a.Hkv, a.H};
  const uint32_t box_rows[4] = {HM, HN, HN, 64};  // o: one warpgroup's rows
  for (int m = 0; m < 4; ++m) {
    const CUresult r = hopper::encode_bf16_4d(
        encode, &maps[m], ptrs[m], D, rows[m], heads[m], a.B,
        strides[m][2], strides[m][1], strides[m][0], box_rows[m]);
    if (r != CUDA_SUCCESS) return -(static_cast<int>(r) * 4 + m);
  }
  auto kernel = flash_fwd_hopper<D>;
  const size_t smem = Hopper<D>::bytes;
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  // persistent: one block per SM walks the tiles
  const int64_t tiles = (int64_t)((a.S + HM - 1) / HM) * a.H * a.B;
  const int grid = (int)(tiles < sms ? tiles : sms);
  kernel<<<grid, HTHREADS, smem, stream>>>(maps[0], maps[1], maps[2],
                                           maps[3], a.lse, a.B, a.H,
                                           a.H / a.Hkv, a.S, a.Sk, a.scale,
                                           a.causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(void (*kernel)(const T*, const T*, const T*, T*, float*,
                                  int, int, int, int, int64_t, int64_t,
                                  int64_t, int64_t, int64_t, int64_t, int64_t,
                                  int64_t, int64_t, int64_t, int64_t, int64_t,
                                  float, int),
                   size_t smem, const Args& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.S + BM - 1) / BM, a.H, a.B);
  kernel<<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<T*>(a.o), a.lse, a.H,
      a.H / a.Hkv, a.S, a.Sk, a.qs[0], a.qs[1], a.qs[2], a.ks[0], a.ks[1],
      a.ks[2], a.vs[0], a.vs[1], a.vs[2], a.os[0], a.os[1], a.os[2], a.scale,
      a.causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float32.  Strides are in elements, ordered
// (batch, head, sequence); the head dim is contiguous.  The caller has
// checked shapes, 16-byte alignment and D in {64, 128}.  Returns a
// cudaError_t (0 on success), or, when cuTensorMapEncodeTiled refuses the
// tensor map of q, k, v or o (m = 0..3), -(CUresult * 4 + m); nothing is
// launched then.
int dstpu_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    float* lse, int dtype, int B, int H, int Hkv, int S,
                    int Sk, int D, long long qsb, long long qsh,
                    long long qss, long long ksb, long long ksh,
                    long long kss, long long vsb, long long vsh,
                    long long vss, long long osb, long long osh,
                    long long oss, float scale, int causal, void* stream) {
  const Args a{q, k, v, o, lse, B, H, Hkv, S, Sk,
               {qsb, qsh, qss}, {ksb, ksh, kss}, {vsb, vsh, vss},
               {osb, osh, oss}, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64) return launch_hopper<64>(a, st);
  if (dtype == 0 && D == 128) return launch_hopper<128>(a, st);
  if (dtype == 1 && D == 64)
    return launch(flash_fwd_f32<64>, SmemF32<64>::bytes, a, st);
  if (dtype == 1 && D == 128)
    return launch(flash_fwd_f32<128>, SmemF32<128>::bytes, a, st);
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of the bf16 kernel at head dim D, in bytes.
int dstpu_flash_fwd_smem_bytes(int D) {
  return D == 64 ? (int)Hopper<64>::bytes
                 : D == 128 ? (int)Hopper<128>::bytes : 0;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
