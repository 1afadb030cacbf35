// Flash-attention backward for Hopper (sm_90a), bound through a plain C
// interface and loaded with ctypes (deepspeed_tpu_torch/ops/flash_attention.py).
//
// Replaces: deepspeed_tpu/ops/flash_attention.py::_flash_bwd_dq_kernel and
// ::_flash_bwd_dkv_kernel (the Pallas TPU kernels launched by
// _flash_bwd_pallas), together with the GQA group sum of _flash_vjp_bwd.
// Same function: with P recomputed from the forward's log-sum-exp,
// P = exp(scale * Q K^T - lse), and dS = P * (dO V^T - delta) where
// delta = rowsum(dO * O) (computed by the launcher),
//   dQ = scale * dS K,   dK = scale * dS^T Q,   dV = P^T dO,
// with dK and dV summed over the q heads of each KV head's group.  Causal
// alignment is bottom-right (offset Sk - S); rows that see no key have
// lse = +inf, so their p, dS and dQ are exactly 0.
//
// What bounds it on this card: five matrix products per (q tile, key
// tile) pair across the two kernels (dQ: Q K^T, dO V^T, dS K; dK/dV:
// K Q^T, V dO^T, P^T dO, dS^T Q, i.e. 6*D and 8*D operations per valid
// pair) against q, k, v, dO, dq, dk, dv bytes.  At the training shape
// (B=4, H=32, Hkv=4, S=2048, D=64, causal) that is ~0.10 ms and ~0.14 ms
// of tensor-core time versus ~0.05 ms of memory: compute-bound, so the
// tensor cores must run the products back to back.  Only wgmma reaches
// their full rate, and only TMA feeds them without spending the math
// warps' issue slots on copies.
//
// The bf16 kernels (dkv_hopper, dq_hopper), built on hopper.cuh in the
// shape of flash_fwd_hopper:
// - Blocks.  Persistent, one per SM, of three warpgroups: warpgroup 0 is
//   the producer (one thread issues every TMA copy; setmaxnreg 40),
//   warpgroups 1 and 2 are wgmma consumers (setmaxnreg 232) owning 64
//   rows each of the block's 128-row tile.  The TPU kernels carry their
//   sums across a sequential grid axis in VMEM scratch; here a loop
//   inside the block walks the other operand's tiles and the sums stay
//   in registers.
// - Schedule.  A dK/dV unit is (128-row key tile, KV head, batch); a dQ
//   unit is (128-row q tile, q head, batch).  Units run heaviest first
//   (under bottom-right causal, key tile 0 meets every q tile and the
//   last q tile every key tile), dealt to the blocks in a snake: block b
//   takes unit b of the first round, unit 2G-1-b of the second, and so
//   on, so the heaviest first-round units get the lightest second-round
//   ones.
// - dK/dV.  K and V land once per unit (4-D tensor maps over the caller's
//   [B,Sk,Hkv,D] strides).  A ring of stages brings, for every q head of
//   the group and every q tile from the first that reaches the key tile,
//   Q and dO (4-D maps, BQ rows); a second producer warp copies that
//   tile's lse (times log2 e) and delta beside them with plain loads (a
//   head's rows start at any element, which TMA does not take; rows past
//   S get lse = +inf, so p = 0).  Per stage, all in registers, no round
//   trip through shared memory:
//     S^T  = K Q^T         ss, both K-major           m64 n BQ
//     P^T  = ex2(S^T * scale*log2e - lse*log2e)      lse per column
//     dP^T = V dO^T        ss                         (runs while P^T is
//                                                      computed)
//     dS^T = P^T (dP^T - delta)
//     dV  += P^T dO        rs: P^T packed in place as the A fragment,
//                          dO the MN-major B (transpose-B)
//     dK  += dS^T Q        rs, likewise
//   At D=64 a stage is 128 q rows (S^T and dP^T m64n128, dK and dV
//   m64n64: 64 + 64 + 32 + 32 accumulator registers); at D=128 it is 64
//   (m64n64 scores, m64n128 gradients: 32 + 32 + 64 + 64), so neither
//   spills under 232 registers.  The group sum happens in the dK and dV
//   accumulators.
// - dQ.  Q, dO, lse and delta land once per unit (lse and delta from the
//   second producer warp); K and V come through a
//   ring with separate full and empty barriers (S = Q K^T starts before
//   V lands; V is freed once dO V^T is done, K once dS K is):
//     S  = Q K^T, dP = dO V^T   ss
//     dS = P (dP - delta), packed in place
//     dQ += dS K                rs, K the MN-major B
//   Key tiles are 128 rows at D=64 and 64 at D=128.
// - Masks.  Only tiles that cross the causal diagonal or the ragged edge
//   of the other operand pay for the mask, and a consumer skips a tile
//   that is masked for all its 64 rows.  exp2 is ex2.approx.ftz.
// - Epilogue.  dK*scale and dV (dQ*scale) become bf16 in a staging tile
//   in the swizzled layout, and one TMA store per 64 columns writes each
//   warpgroup's rows to the [B,S,heads,D] outputs, dropping rows past S
//   or Sk.
// - Deterministic: no atomics.  Every block owns its output tiles and
//   sums in a fixed order, so two identical calls give bit-identical
//   gradients.  (Producing dQ inside the dK/dV kernel through an fp32
//   accumulator shared across key tiles would save the recomputation of
//   S and dP, but needs atomics or a reduction pass.)
//
// fp32 inputs take SIMT kernels in full fp32 (no TF32), off the training
// path, so an fp32 model matches the CPU.  They keep 64-row tiles and
// plain loads, addressing q, k, v, dO and the outputs through (batch,
// head, sequence) strides with a contiguous head dim.
//
// Shared memory exceeds 48 KB, so the launcher raises the dynamic limit
// first, and it returns cudaGetLastError() so that a refused launch is
// seen.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

// The launch arguments, passed by pointer through the C interface (and so
// outside the anonymous namespace, which would hide the entry point).
struct BwdArgs {
  const void *q, *k, *v, *dout;
  const float *lse, *delta;  // [B, H, S], contiguous
  void *dq, *dk, *dv;
  int B, H, Hkv, S, Sk;
  int causal;
  float scale;
  int pad;
  // element strides (batch, head, sequence); the head dim is contiguous
  long long qs[3], ks[3], vs[3], dos[3], dqs[3], dks[3], dvs[3];
};

namespace {

constexpr int BM = 64;  // fp32 kernels: q rows per tile
constexpr int BN = 64;  // fp32 kernels: key rows per tile
constexpr int WARPS = 4;
constexpr int WM = 16;  // rows per warp
constexpr int THREADS = WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ int key_tiles(int q0, int S, int Sk, int causal) {
  const int nk = (Sk + BN - 1) / BN;
  if (!causal) return nk;
  const int last = min(q0 + BM, S) - 1 + (Sk - S);
  return last < 0 ? 0 : min(nk, last / BN + 1);
}

// first q tile that reaches key k0 (causal), 0 otherwise
__device__ __forceinline__ int first_q_tile(int k0, int S, int Sk,
                                            int causal) {
  if (!causal) return 0;
  const int x = k0 - (Sk - S);
  return x <= 0 ? 0 : x / BM;
}

// ---------------------------------------------------------------------------
// bf16: TMA ring, warp-specialized wgmma
// ---------------------------------------------------------------------------

constexpr int TILE = 128;          // rows of a unit's own tile (2 x 64)
constexpr int HTHREADS = 3 * 128;  // producer + two consumer warpgroups
// the producer's two loops need 40 registers without spilling; the
// consumers then get 232 (128 x 40 + 256 x 232 = 64,512 of 65,536)
constexpr int PRODUCER_REGS = 40;
constexpr int CONSUMER_REGS = 232;
constexpr uint32_t ROW = 128;      // bytes of a swizzled row: 64 bf16

// dK/dV: a unit's K, V and the dK, dV staging tiles (128 rows each), then
// a ring of stages of Q, dO (BQ rows each), lse and delta (BQ fp32 each)
template <int D>
struct Dkv {
  static constexpr int BQ = D == 64 ? 128 : 64;
  static constexpr int STAGES = D == 64 ? 4 : 2;
  static constexpr int HALVES = D / 64;           // 64-column boxes a tile
  static constexpr uint32_t KHALF = TILE * ROW;   // 128 rows x 64 columns
  static constexpr uint32_t KTILE = HALVES * KHALF;
  static constexpr uint32_t QHALF = BQ * ROW;
  static constexpr uint32_t QTILE = HALVES * QHALF;
  static constexpr uint32_t VEC = BQ * 4;         // lse or delta
  static constexpr uint32_t K_OFF = 0, V_OFF = KTILE;
  static constexpr uint32_t DK_OFF = 2 * KTILE, DV_OFF = 3 * KTILE;
  static constexpr uint32_t RING = 4 * KTILE;
  // within a stage: Q, dO, then lse and delta
  static constexpr uint32_t ST_DO = QTILE, ST_LSE = 2 * QTILE,
                            ST_DELTA = 2 * QTILE + VEC;
  static constexpr uint32_t STAGE = (2 * QTILE + 2 * VEC + 1023) / 1024 * 1024;
  static constexpr uint32_t BAR_OFF = RING + STAGES * STAGE;
  // barriers: kv_full, kv_empty, then full and empty per stage; 1 KB of
  // slack to align the base to the swizzle's 1024
  static constexpr size_t bytes = BAR_OFF + 8 * (2 + 2 * STAGES) + 1024;
};

// dQ: a unit's Q, dO, the dQ staging tile (128 rows each), its lse and
// delta, then a ring of K and V stages of BK rows
template <int D>
struct Dq {
  static constexpr int BK = D == 64 ? 128 : 64;
  static constexpr int STAGES = D == 64 ? 4 : 3;
  static constexpr int HALVES = D / 64;
  static constexpr uint32_t QHALF = TILE * ROW;
  static constexpr uint32_t QTILE = HALVES * QHALF;
  static constexpr uint32_t KHALF = BK * ROW;
  static constexpr uint32_t KTILE = HALVES * KHALF;
  static constexpr uint32_t Q_OFF = 0, DO_OFF = QTILE, DQ_OFF = 2 * QTILE;
  static constexpr uint32_t LSE_OFF = 3 * QTILE, DELTA_OFF = LSE_OFF + 512;
  static constexpr uint32_t K_OFF = LSE_OFF + 1024;
  static constexpr uint32_t V_OFF = K_OFF + STAGES * KTILE;
  static constexpr uint32_t BAR_OFF = V_OFF + STAGES * KTILE;
  // barriers: q_full, q_empty, then k_full, v_full, k_empty, v_empty per
  // stage
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

// d (+)= A B, m64 x N x k16, both operands from shared memory
template <int N>
__device__ __forceinline__ void mma_ss(float (&d)[N / 2], uint64_t a,
                                       uint64_t b, int scale_d) {
  if constexpr (N == 128)
    hopper::wgmma_m64n128k16_ss(d, a, b, scale_d);
  else
    hopper::wgmma_m64n64k16_ss(d, a, b, scale_d);
}

// d += A B, m64 x N x k16, A from registers, B MN-major in shared memory
template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 128)
    hopper::wgmma_m64n128k16_rs(d, a, b, 1);
  else
    hopper::wgmma_m64n64k16_rs(d, a, b, 1);
}

// d = A B^T over the head dim: A is 64 rows at `a` in tiles whose 64-column
// halves are `a_half` bytes apart, B is N rows at `b` (halves `b_half`
// apart), both K-major.  Issued, not committed.
template <int D, int N>
__device__ __forceinline__ void rows_dot_issue(float (&d)[N / 2], uint32_t a,
                                               uint32_t a_half, uint32_t b,
                                               uint32_t b_half) {
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    const uint32_t k = (kd % 4) * 32;
    mma_ss<N>(d, hopper::wgmma_desc(a + (kd / 4) * a_half + k, 16, 1024),
              hopper::wgmma_desc(b + (kd / 4) * b_half + k, 16, 1024),
              kd > 0);
  }
}

// d += F X over K rows of X: F the packed A fragments (K/16 of them), X
// K rows x D columns at `x` (64-column halves `x_half` apart), MN-major.
// Issued, not committed.
template <int D, int K>
__device__ __forceinline__ void frag_mul_issue(float (&d)[D / 2],
                                               const uint32_t (&f)[K / 16][4],
                                               uint32_t x, uint32_t x_half) {
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk)
    mma_rs<D>(d, f[kk], hopper::wgmma_desc(x + kk * 16 * ROW, x_half, 1024));
}

// fp32 accumulator of m64nN as the bf16 A fragments of the next product
template <int N>
__device__ __forceinline__ void pack_frag(const float (&x)[N / 2],
                                          uint32_t (&f)[N / 16][4]) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    f[n / 2][(n % 2) * 2] = pack_bf16(x[4 * n], x[4 * n + 1]);
    f[n / 2][(n % 2) * 2 + 1] = pack_bf16(x[4 * n + 2], x[4 * n + 3]);
  }
}

// One warpgroup's 64 rows of an accumulator (times `mul`) as bf16 into a
// staging tile in the swizzled layout; `dst` is the warpgroup's first row
// in the tile's first 64-column half, halves `half` bytes apart.
template <int D>
__device__ __forceinline__ void stage_rows(const float (&x)[D / 2], float mul,
                                           uint32_t dst, uint32_t half,
                                           int warp, int g, int t4) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int rr = 16 * warp + g + 8 * r;  // row within the warpgroup
      const uint32_t addr = dst + (n / 8) * half + rr * ROW +
                            (((n % 8) ^ (rr % 8)) << 4) + 4 * t4;
      st_shared_u32(addr, pack_bf16(x[4 * n + 2 * r] * mul,
                                    x[4 * n + 2 * r + 1] * mul));
    }
  }
}

// Warp 1 of the producer copies the lse (times log2 e) and delta of q
// rows q0..q0+n-1 of one head, whose row 0 is element `bh` of the [B,H,S]
// vectors, into shared memory: lse at dst[0..n), delta at dst[n..2n).
// Rows past S get lse = +inf and delta = 0, so their p and dS are exactly
// 0.  Plain loads: a head's rows start at any element, and a TMA box that
// starts off 16 bytes faults.
__device__ __forceinline__ void copy_rows(float* dst,
                                          const float* __restrict__ lse,
                                          const float* __restrict__ delta,
                                          int bh, int q0, int S, int n) {
  for (int r = threadIdx.x % 32; r < n; r += 32) {
    const bool ok = q0 + r < S;
    dst[r] = ok ? lse[bh + q0 + r] * LOG2E : INFINITY;
    dst[n + r] = ok ? delta[bh + q0 + r] : 0.f;
  }
}

// The unit a block takes in round r: heaviest first, dealt in a snake.
__device__ __forceinline__ int unit_at(int r, int blocks) {
  return r * blocks + ((r & 1) ? blocks - 1 - (int)blockIdx.x
                               : (int)blockIdx.x);
}

// dK/dV unit u: key tile j (ascending: under causal, key tile 0 meets the
// most q tiles), KV head hk, batch b
struct DkvUnit {
  int j, hk, b;
};
__device__ __forceinline__ DkvUnit dkv_unit(int u, int Hkv, int B) {
  const int r = u % (Hkv * B);
  return {u / (Hkv * B), r % Hkv, r / Hkv};
}

// first q tile of BQ rows that reaches key k0 (bottom-right causal)
template <int BQ>
__device__ __forceinline__ int first_q(int k0, int offset, int causal) {
  const int x = k0 - offset;
  return (!causal || x <= 0) ? 0 : x / BQ;
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
dkv_hopper(const __grid_constant__ CUtensorMap tq,
           const __grid_constant__ CUtensorMap tk,
           const __grid_constant__ CUtensorMap tv,
           const __grid_constant__ CUtensorMap tdo,
           const __grid_constant__ CUtensorMap tdk,
           const __grid_constant__ CUtensorMap tdv,
           const float* __restrict__ lse, const float* __restrict__ delta,
           int B, int H, int Hkv, int S, int Sk, float scale, int causal) {
  using C = Dkv<D>;
  constexpr int BQ = C::BQ, ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t kv_full = base + C::BAR_OFF, kv_empty = kv_full + 8;
  auto full = [&](int s) { return kv_full + 16u + 8u * s; };
  auto empty = [&](int s) { return kv_full + 16u + 8u * (ST + s); };
  auto stage = [&](int s) { return C::RING + s * C::STAGE; };
  const int groups = H / Hkv;
  const int q_tiles = (S + BQ - 1) / BQ;
  const int units = (Sk + TILE - 1) / TILE * Hkv * B;
  const int offset = Sk - S;  // bottom-right causal alignment
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(kv_full, 1);
    hopper::mbar_init(kv_empty, 256);  // every consumer thread
    for (int s = 0; s < ST; ++s) {
      hopper::mbar_init(full(s), 1 + 32);  // the TMA thread, the row warp
      hopper::mbar_init(empty(s), 256);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // producer: one thread loads each unit's K and V once the previous
    // unit is done with them, and keeps the Q/dO ring full, running ahead
    // into the next unit; warp 1 fills each stage's lse and delta
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // stages loaded so far
      for (int r = 0; r * (int)gridDim.x < units; ++r) {
        const int u = unit_at(r, gridDim.x);
        if (u >= units) continue;  // only in the last round
        const DkvUnit c = dkv_unit(u, Hkv, B);
        hopper::mbar_wait(kv_empty, (r & 1) ^ 1);
        hopper::mbar_expect_tx(kv_full, 2 * C::KTILE);
        for (int x = 0; x < C::HALVES; ++x) {
          hopper::tma_load_4d(base + C::K_OFF + x * C::KHALF, &tk, kv_full,
                              x * 64, c.j * TILE, c.hk, c.b);
          hopper::tma_load_4d(base + C::V_OFF + x * C::KHALF, &tv, kv_full,
                              x * 64, c.j * TILE, c.hk, c.b);
        }
        const int i0 = first_q<BQ>(c.j * TILE, offset, causal);
        for (int h = c.hk * groups; h < (c.hk + 1) * groups; ++h) {
          for (int i = i0; i < q_tiles; ++i, ++it) {
            const int s = it % ST;
            const uint32_t st = base + stage(s);
            hopper::mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
            hopper::mbar_expect_tx(full(s), 2 * C::QTILE);
            for (int x = 0; x < C::HALVES; ++x) {
              hopper::tma_load_4d(st + x * C::QHALF, &tq, full(s), x * 64,
                                  i * BQ, h, c.b);
              hopper::tma_load_4d(st + C::ST_DO + x * C::QHALF, &tdo,
                                  full(s), x * 64, i * BQ, h, c.b);
            }
          }
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      int it = 0;
      for (int r = 0; r * (int)gridDim.x < units; ++r) {
        const int u = unit_at(r, gridDim.x);
        if (u >= units) continue;
        const DkvUnit c = dkv_unit(u, Hkv, B);
        const int i0 = first_q<BQ>(c.j * TILE, offset, causal);
        for (int h = c.hk * groups; h < (c.hk + 1) * groups; ++h) {
          for (int i = i0; i < q_tiles; ++i, ++it) {
            const int s = it % ST;
            hopper::mbar_wait(empty(s), ((it / ST) & 1) ^ 1);
            copy_rows(reinterpret_cast<float*>(gbase + stage(s) + C::ST_LSE),
                      lse, delta, (c.b * H + h) * S, i * BQ, S, BQ);
            hopper::mbar_arrive(full(s));
          }
        }
      }
    }
    return;
  }

  // consumers: warpgroup cw owns key rows 64cw..64cw+63 of each key tile
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale2 = scale * LOG2E;  // scores in the log2 domain
  const uint32_t ka = base + C::K_OFF + cw * 64 * ROW;
  const uint32_t va = base + C::V_OFF + cw * 64 * ROW;

  // this lane holds key rows 16 warp + g (+8) of the warpgroup's 64 and
  // columns 8n + 2 t4 (+1) of a stage: the key is past the q row's
  // diagonal where kfirst + lane_kq + 8 (e/2) > q0 + 8n + (e&1)
  const int lane_kq = 16 * warp + g - 2 * t4;
  int it = 0;  // stages consumed so far
  for (int r = 0; r * (int)gridDim.x < units; ++r) {
    const int u = unit_at(r, gridDim.x);
    if (u >= units) continue;  // only in the last round: r counts units
    const DkvUnit c = dkv_unit(u, Hkv, B);
    // the warpgroup's first key less the causal offset; far below every
    // q row when not causal, so that nothing is masked
    const int kfirst =
        causal ? c.j * TILE + 64 * cw - offset : -(1 << 30);
    const int i0 = first_q<BQ>(c.j * TILE, offset, causal);
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) dk[n] = dv[n] = 0.f;
    hopper::mbar_wait(kv_full, r & 1);

    for (int gq = 0; gq < groups; ++gq) {
      for (int i = i0; i < q_tiles; ++i, ++it) {
        const int s = it % ST;
        const uint32_t st = base + stage(s);
        const float* lse_s = reinterpret_cast<const float*>(
            gbase + stage(s) + C::ST_LSE);
        const float* dl_s = reinterpret_cast<const float*>(
            gbase + stage(s) + C::ST_DELTA);
        const int q0 = i * BQ;
        hopper::mbar_wait(full(s), (it / ST) & 1);
        // every key of this warpgroup is past every q row's diagonal
        if (kfirst > q0 + BQ - 1) {
          hopper::mbar_arrive(empty(s));
          continue;
        }
        // rows past S carry lse = +inf: only the diagonal needs a mask,
        // p = 0 where key > q + offset, in kq's terms below
        const bool edge = kfirst + 63 > q0;
        const int kq = kfirst + lane_kq - q0;
        float sc[BQ / 2], dp[BQ / 2];
        hopper::wgmma_fence();
        rows_dot_issue<D, BQ>(sc, ka, C::KHALF, st, C::QHALF);
        hopper::wgmma_commit();
        rows_dot_issue<D, BQ>(dp, va, C::KHALF, st + C::ST_DO, C::QHALF);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S^T is in; V dO^T still runs
        hopper::fence_operands(sc);
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 l =
              *reinterpret_cast<const float2*>(lse_s + n * 8 + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float p =
                fast_exp2(sc[4 * n + e] * scale2 - ((e & 1) ? l.y : l.x));
            if (edge && kq + (e / 2) * 8 > n * 8 + (e & 1)) p = 0.f;
            sc[4 * n + e] = p;
          }
        }
        hopper::wgmma_wait<0>();
        hopper::fence_operands(dp);
        // dS^T, and both packed as bf16 A fragments column group by
        // column group, so that the fp32 values die as they are packed
        uint32_t pf[BQ / 16][4], dsf[BQ / 16][4];
#pragma unroll
        for (int n = 0; n < BQ / 8; ++n) {
          const float2 d2 =
              *reinterpret_cast<const float2*>(dl_s + n * 8 + 2 * t4);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - ((e & 1) ? d2.y
                                                                   : d2.x));
          pf[n / 2][(n % 2) * 2] = pack_bf16(sc[4 * n], sc[4 * n + 1]);
          pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(sc[4 * n + 2], sc[4 * n + 3]);
          dsf[n / 2][(n % 2) * 2] = pack_bf16(dp[4 * n], dp[4 * n + 1]);
          dsf[n / 2][(n % 2) * 2 + 1] =
              pack_bf16(dp[4 * n + 2], dp[4 * n + 3]);
        }
        hopper::fence_operands(dv);
        hopper::fence_operands(dk);
        hopper::wgmma_fence();
        frag_mul_issue<D, BQ>(dv, pf, st + C::ST_DO, C::QHALF);
        frag_mul_issue<D, BQ>(dk, dsf, st, C::QHALF);
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
        hopper::fence_operands(dv);
        hopper::fence_operands(dk);
        hopper::mbar_arrive(empty(s));
      }
    }
    hopper::mbar_arrive(kv_empty);

    // dK * scale and dV in bf16 into the staging tiles, once the previous
    // unit's stores have read them; one TMA store per 64 columns
    const int k0w = c.j * TILE + 64 * cw;  // the warpgroup's first key
    const uint32_t dka = base + C::DK_OFF + cw * 64 * ROW;
    const uint32_t dva = base + C::DV_OFF + cw * 64 * ROW;
    if (tid == 0) hopper::tma_store_wait();
    hopper::named_barrier_sync(1 + cw, 128);
    stage_rows<D>(dk, scale, dka, C::KHALF, warp, g, t4);
    stage_rows<D>(dv, 1.f, dva, C::KHALF, warp, g, t4);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + cw, 128);
    if (tid == 0) {
      for (int x = 0; x < C::HALVES; ++x) {
        hopper::tma_store_4d(&tdk, dka + x * C::KHALF, x * 64, k0w, c.hk,
                             c.b);
        hopper::tma_store_4d(&tdv, dva + x * C::KHALF, x * 64, k0w, c.hk,
                             c.b);
      }
      hopper::tma_store_commit();
    }
  }
  if (tid == 0) hopper::tma_store_wait();
}

// dQ unit u: q tile i (descending: under causal, the last q tile meets
// the most key tiles), q head h, batch b
struct DqUnit {
  int i, h, b;
};
__device__ __forceinline__ DqUnit dq_unit(int u, int H, int B, int q_tiles) {
  const int r = u % (H * B);
  return {q_tiles - 1 - u / (H * B), r % H, r / H};
}

// key tiles of BK rows that the 128 q rows from q0 need
template <int BK>
__device__ __forceinline__ int dq_key_tiles(int q0, int S, int Sk,
                                            int causal) {
  const int nk = (Sk + BK - 1) / BK;
  if (!causal) return nk;
  const int last = min(q0 + TILE, S) - 1 + (Sk - S);
  return last < 0 ? 0 : min(nk, last / BK + 1);
}

template <int D>
__global__ void __launch_bounds__(HTHREADS, 1)
dq_hopper(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const __grid_constant__ CUtensorMap tdq,
          const float* __restrict__ lse, const float* __restrict__ delta,
          int B, int H, int Hkv, int S, int Sk, float scale, int causal) {
  using C = Dq<D>;
  constexpr int BK = C::BK, ST = C::STAGES;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t base = (hopper::smem_u32(smem_raw) + 1023u) & ~1023u;
  unsigned char* gbase = smem_raw + (base - hopper::smem_u32(smem_raw));
  const uint32_t q_full = base + C::BAR_OFF, q_empty = q_full + 8;
  auto bar = [&](int kind, int s) {
    return q_full + 8u * (2 + kind * ST + s);
  };
  auto k_full = [&](int s) { return bar(0, s); };
  auto v_full = [&](int s) { return bar(1, s); };
  auto k_empty = [&](int s) { return bar(2, s); };
  auto v_empty = [&](int s) { return bar(3, s); };
  auto k_tile = [&](int s) { return base + C::K_OFF + s * C::KTILE; };
  auto v_tile = [&](int s) { return base + C::V_OFF + s * C::KTILE; };
  const int groups = H / Hkv;
  const int q_tiles = (S + TILE - 1) / TILE;
  const int units = q_tiles * H * B;
  const int offset = Sk - S;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1 + 32);  // the TMA thread, the row warp
    hopper::mbar_init(q_empty, 256);
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
    // producer: Q and dO once per unit (freed after the unit's last
    // dO V^T), K and V through the ring; warp 1 fills the unit's lse and
    // delta
    hopper::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      int it = 0;  // key tiles loaded so far
      for (int r = 0, nq = 0; r * (int)gridDim.x < units; ++r) {
        const int u = unit_at(r, gridDim.x);
        if (u >= units) continue;
        const DqUnit c = dq_unit(u, H, B, q_tiles);
        const int nk = dq_key_tiles<BK>(c.i * TILE, S, Sk, causal);
        if (nk == 0) continue;
        hopper::mbar_wait(q_empty, (nq++ & 1) ^ 1);
        hopper::mbar_expect_tx(q_full, 2 * C::QTILE);
        for (int x = 0; x < C::HALVES; ++x) {
          hopper::tma_load_4d(base + C::Q_OFF + x * C::QHALF, &tq, q_full,
                              x * 64, c.i * TILE, c.h, c.b);
          hopper::tma_load_4d(base + C::DO_OFF + x * C::QHALF, &tdo, q_full,
                              x * 64, c.i * TILE, c.h, c.b);
        }
        const int hk = c.h / groups;
        for (int j = 0; j < nk; ++j, ++it) {
          const int s = it % ST;
          const uint32_t free_parity = ((it / ST) & 1) ^ 1;
          hopper::mbar_wait(k_empty(s), free_parity);
          hopper::mbar_expect_tx(k_full(s), C::KTILE);
          for (int x = 0; x < C::HALVES; ++x)
            hopper::tma_load_4d(k_tile(s) + x * C::KHALF, &tk, k_full(s),
                                x * 64, j * BK, hk, c.b);
          hopper::mbar_wait(v_empty(s), free_parity);
          hopper::mbar_expect_tx(v_full(s), C::KTILE);
          for (int x = 0; x < C::HALVES; ++x)
            hopper::tma_load_4d(v_tile(s) + x * C::KHALF, &tv, v_full(s),
                                x * 64, j * BK, hk, c.b);
        }
      }
    } else if (threadIdx.x / 32 == 1) {
      for (int r = 0, nq = 0; r * (int)gridDim.x < units; ++r) {
        const int u = unit_at(r, gridDim.x);
        if (u >= units) continue;
        const DqUnit c = dq_unit(u, H, B, q_tiles);
        if (dq_key_tiles<BK>(c.i * TILE, S, Sk, causal) == 0) continue;
        hopper::mbar_wait(q_empty, (nq++ & 1) ^ 1);
        copy_rows(reinterpret_cast<float*>(gbase + C::LSE_OFF), lse, delta,
                  (c.b * H + c.h) * S, c.i * TILE, S, TILE);
        hopper::mbar_arrive(q_full);
      }
    }
    return;
  }

  // consumers: warpgroup cw owns q rows 64cw..64cw+63 of each q tile
  hopper::setmaxnreg_inc<CONSUMER_REGS>();
  const int cw = wg - 1;
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const float scale2 = scale * LOG2E;
  const uint32_t qa = base + C::Q_OFF + cw * 64 * ROW;
  const uint32_t doa = base + C::DO_OFF + cw * 64 * ROW;
  const uint32_t dqa = base + C::DQ_OFF + cw * 64 * ROW;
  const float* lse_s = reinterpret_cast<const float*>(gbase + C::LSE_OFF);
  const float* dl_s = reinterpret_cast<const float*>(gbase + C::DELTA_OFF);

  int nq = 0, it = 0;  // units and key tiles consumed so far
  for (int r = 0; r * (int)gridDim.x < units; ++r) {
    const int u = unit_at(r, gridDim.x);
    if (u >= units) continue;
    const DqUnit c = dq_unit(u, H, B, q_tiles);
    const int nk = dq_key_tiles<BK>(c.i * TILE, S, Sk, causal);
    const int wq0 = c.i * TILE + 64 * cw;  // the warpgroup's first row
    const int rw = 64 * cw + 16 * warp + g;  // this lane's rows in the tile
    const int row0 = c.i * TILE + rw;        // and in the sequence: +8
    float dq[D / 2];
#pragma unroll
    for (int n = 0; n < D / 2; ++n) dq[n] = 0.f;
    float lse2[2] = {0.f, 0.f}, dl[2] = {0.f, 0.f};

    if (nk > 0) {
      hopper::mbar_wait(q_full, nq++ & 1);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        lse2[e] = lse_s[rw + 8 * e];
        dl[e] = dl_s[rw + 8 * e];
      }
    }
    for (int j = 0; j < nk; ++j, ++it) {
      const int s = it % ST;
      const uint32_t parity = (it / ST) & 1;
      const int k0 = j * BK;
      hopper::mbar_wait(k_full(s), parity);
      // every key of the tile is past every row's diagonal
      if (causal && k0 > wq0 + 63 + offset) {
        hopper::mbar_wait(v_full(s), parity);
        hopper::mbar_arrive(v_empty(s));
        hopper::mbar_arrive(k_empty(s));
        if (j == nk - 1) hopper::mbar_arrive(q_empty);
        continue;
      }
      const bool edge = k0 + BK > Sk || (causal && k0 + BK - 1 > wq0 + offset);
      float sc[BK / 2], dp[BK / 2];
      hopper::wgmma_fence();
      rows_dot_issue<D, BK>(sc, qa, C::QHALF, k_tile(s), C::KHALF);
      hopper::wgmma_commit();
      hopper::mbar_wait(v_full(s), parity);
      hopper::wgmma_fence();
      rows_dot_issue<D, BK>(dp, doa, C::QHALF, v_tile(s), C::KHALF);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();  // S is in; dO V^T still runs
      hopper::fence_operands(sc);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float p = fast_exp2(sc[4 * n + e] * scale2 - lse2[e / 2]);
          if (edge) {
            const int key = k0 + n * 8 + 2 * t4 + (e & 1);
            if (key >= Sk || (causal && key > row0 + (e / 2) * 8 + offset))
              p = 0.f;
          }
          sc[4 * n + e] = p;
        }
      }
      hopper::wgmma_wait<0>();
      hopper::fence_operands(dp);
      hopper::mbar_arrive(v_empty(s));
      if (j == nk - 1) hopper::mbar_arrive(q_empty);
#pragma unroll
      for (int n = 0; n < BK / 8; ++n) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * n + e] = sc[4 * n + e] * (dp[4 * n + e] - dl[e / 2]);
      }
      uint32_t dsf[BK / 16][4];
      pack_frag<BK>(dp, dsf);
      hopper::fence_operands(dq);
      hopper::wgmma_fence();
      frag_mul_issue<D, BK>(dq, dsf, k_tile(s), C::KHALF);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_operands(dq);
      hopper::mbar_arrive(k_empty(s));
    }

    // dQ * scale in bf16 into the staging tile (zeros for a tile that
    // sees no key), once the previous unit's store has read it
    if (tid == 0) hopper::tma_store_wait();
    hopper::named_barrier_sync(1 + cw, 128);
    stage_rows<D>(dq, scale, dqa, C::QHALF, warp, g, t4);
    hopper::fence_proxy_async();
    hopper::named_barrier_sync(1 + cw, 128);
    if (tid == 0) {
      for (int x = 0; x < C::HALVES; ++x)
        hopper::tma_store_4d(&tdq, dqa + x * C::QHALF, x * 64, wq0, c.h,
                             c.b);
      hopper::tma_store_commit();
    }
  }
  if (tid == 0) hopper::tma_store_wait();
}

// ---------------------------------------------------------------------------
// fp32: SIMT, full fp32 products
// ---------------------------------------------------------------------------

template <int D>
struct SmemF32 {
  static constexpr int LDT = D + 4;
  static constexpr size_t tile = sizeof(float) * 64 * LDT;
  // dq: Q, dO, K, V, dQ; dkv: K, V, Q, dO, dK, dV; then per-warp rows
  // (two of 64) and the tile's lse and delta
  static constexpr size_t dq_bytes = 5 * tile + sizeof(float) * (8 * 64 + 128);
  static constexpr size_t dkv_bytes =
      6 * tile + sizeof(float) * (8 * 64 + 128);
};

template <int D, int LD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* src,
                                              int64_t stride, int rows) {
  constexpr int CPR = D / 4;
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < rows)
      val = *reinterpret_cast<const float4*>(src + (int64_t)r * stride + c);
    *reinterpret_cast<float4*>(dst + r * LD + c) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dq_f32(const BwdArgs a) {
  using L = SmemF32<D>;
  constexpr int LDT = L::LDT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* dOs = Qs + 64 * LDT;
  float* Ks = dOs + 64 * LDT;
  float* Vs = Ks + 64 * LDT;
  float* dQs = Vs + 64 * LDT;
  float* Dw = dQs + 64 * LDT;  // [WARPS][64]: one row of dS per warp
  float* lse_s = Dw + 8 * 64;
  float* dl_s = lse_s + 64;

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, Sk = a.Sk, causal = a.causal;
  const int kvh = h / (a.H / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int q0 = i * BM, offset = Sk - S, qrows = min(BM, S - q0);
  const float* kb = static_cast<const float*>(a.k) + b * a.ks[0] +
                    kvh * a.ks[1];
  const float* vb = static_cast<const float*>(a.v) + b * a.vs[0] +
                    kvh * a.vs[1];
  const int nk = key_tiles(q0, S, Sk, causal);

  load_tile_f32<D, LDT>(Qs, static_cast<const float*>(a.q) + b * a.qs[0] +
                                h * a.qs[1] + q0 * a.qs[2],
                        a.qs[2], qrows);
  load_tile_f32<D, LDT>(dOs, static_cast<const float*>(a.dout) +
                                 b * a.dos[0] + h * a.dos[1] + q0 * a.dos[2],
                        a.dos[2], qrows);
  for (int idx = threadIdx.x; idx < 64 * LDT; idx += THREADS) dQs[idx] = 0.f;
  const int64_t base = ((int64_t)b * a.H + h) * S + q0;
  for (int r = threadIdx.x; r < BM; r += THREADS) {
    lse_s[r] = r < qrows ? a.lse[base + r] : INFINITY;
    dl_s[r] = r < qrows ? a.delta[base + r] : 0.f;
  }
  float* Dr = Dw + warp * 64;

  for (int j = 0; j < nk; ++j) {
    const int k0 = j * BN;
    __syncthreads();  // the previous tile's K and V are no longer read
    load_tile_f32<D, LDT>(Ks, kb + k0 * a.ks[2], a.ks[2], min(BN, Sk - k0));
    load_tile_f32<D, LDT>(Vs, vb + k0 * a.vs[2], a.vs[2], min(BN, Sk - k0));
    __syncthreads();
    for (int rr = 0; rr < WM; ++rr) {
      const int r = warp * WM + rr, qpos = q0 + r;
      for (int half = 0; half < 2; ++half) {
        const int c = lane + 32 * half, key = k0 + c;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(Qs[r * LDT + d], Ks[c * LDT + d], s);
          dp = fmaf(dOs[r * LDT + d], Vs[c * LDT + d], dp);
        }
        const bool ok = key < Sk && (!causal || key <= qpos + offset);
        const float p = ok ? expf(s * a.scale - lse_s[r]) : 0.f;
        Dr[c] = p * (dp - dl_s[r]);
      }
      __syncwarp();
      for (int d = lane; d < D; d += 32) {
        float acc = dQs[r * LDT + d];
        for (int c = 0; c < BN; ++c) acc = fmaf(Dr[c], Ks[c * LDT + d], acc);
        dQs[r * LDT + d] = acc;
      }
      __syncwarp();
    }
  }
  __syncthreads();
  for (int rr = 0; rr < WM; ++rr) {
    const int r = warp * WM + rr;
    if (r >= qrows) break;
    float* orow = static_cast<float*>(a.dq) + b * a.dqs[0] + h * a.dqs[1] +
                  (q0 + r) * a.dqs[2];
    for (int d = lane; d < D; d += 32) orow[d] = dQs[r * LDT + d] * a.scale;
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dkv_f32(const BwdArgs a) {
  using L = SmemF32<D>;
  constexpr int LDT = L::LDT;
  extern __shared__ __align__(128) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);
  float* Vs = Ks + 64 * LDT;
  float* Qs = Vs + 64 * LDT;
  float* dOs = Qs + 64 * LDT;
  float* dKs = dOs + 64 * LDT;
  float* dVs = dKs + 64 * LDT;
  float* Pw = dVs + 64 * LDT;   // [WARPS][64] rows of P^T
  float* Dw = Pw + 4 * 64;      // [WARPS][64] rows of dS^T
  float* lse_s = Dw + 4 * 64;
  float* dl_s = lse_s + 64;

  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, Sk = a.Sk, causal = a.causal, H = a.H;
  const int groups = H / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int k0 = j * BN, offset = Sk - S, krows = min(BN, Sk - k0);
  const int nq = (S + BM - 1) / BM;
  const int i0 = first_q_tile(k0, S, Sk, causal);

  load_tile_f32<D, LDT>(Ks, static_cast<const float*>(a.k) + b * a.ks[0] +
                                kvh * a.ks[1] + k0 * a.ks[2],
                        a.ks[2], krows);
  load_tile_f32<D, LDT>(Vs, static_cast<const float*>(a.v) + b * a.vs[0] +
                                kvh * a.vs[1] + k0 * a.vs[2],
                        a.vs[2], krows);
  for (int idx = threadIdx.x; idx < 64 * LDT; idx += THREADS)
    dKs[idx] = dVs[idx] = 0.f;
  float* Pr = Pw + warp * 64;
  float* Dr = Dw + warp * 64;

  for (int gq = 0; gq < groups; ++gq) {
    const int h = kvh * groups + gq;
    for (int i = i0; i < nq; ++i) {
      const int q0 = i * BM, qrows = min(BM, S - q0);
      __syncthreads();  // the previous Q and dO are no longer read
      load_tile_f32<D, LDT>(Qs, static_cast<const float*>(a.q) +
                                    b * a.qs[0] + h * a.qs[1] + q0 * a.qs[2],
                            a.qs[2], qrows);
      load_tile_f32<D, LDT>(dOs, static_cast<const float*>(a.dout) +
                                     b * a.dos[0] + h * a.dos[1] +
                                     q0 * a.dos[2],
                            a.dos[2], qrows);
      const int64_t base = ((int64_t)b * H + h) * S + q0;
      for (int r = threadIdx.x; r < BM; r += THREADS) {
        lse_s[r] = r < qrows ? a.lse[base + r] : INFINITY;
        dl_s[r] = r < qrows ? a.delta[base + r] : 0.f;
      }
      __syncthreads();
      for (int rr = 0; rr < WM; ++rr) {
        const int r = warp * WM + rr, key = k0 + r;
        for (int half = 0; half < 2; ++half) {
          const int c = lane + 32 * half;
          float s = 0.f, dp = 0.f;
          for (int d = 0; d < D; ++d) {
            s = fmaf(Ks[r * LDT + d], Qs[c * LDT + d], s);
            dp = fmaf(Vs[r * LDT + d], dOs[c * LDT + d], dp);
          }
          const bool ok = key < Sk && (!causal || key <= q0 + c + offset);
          const float p = ok ? expf(s * a.scale - lse_s[c]) : 0.f;
          Pr[c] = p;
          Dr[c] = p * (dp - dl_s[c]);
        }
        __syncwarp();
        for (int d = lane; d < D; d += 32) {
          float accv = dVs[r * LDT + d], acck = dKs[r * LDT + d];
          for (int c = 0; c < BM; ++c) {
            accv = fmaf(Pr[c], dOs[c * LDT + d], accv);
            acck = fmaf(Dr[c], Qs[c * LDT + d], acck);
          }
          dVs[r * LDT + d] = accv;
          dKs[r * LDT + d] = acck;
        }
        __syncwarp();
      }
    }
  }
  __syncthreads();
  for (int rr = 0; rr < WM; ++rr) {
    const int r = warp * WM + rr;
    if (r >= krows) break;
    float* krow = static_cast<float*>(a.dk) + b * a.dks[0] + kvh * a.dks[1] +
                  (k0 + r) * a.dks[2];
    float* vrow = static_cast<float*>(a.dv) + b * a.dvs[0] + kvh * a.dvs[1] +
                  (k0 + r) * a.dvs[2];
    for (int d = lane; d < D; d += 32) {
      krow[d] = dKs[r * LDT + d] * a.scale;
      vrow[d] = dVs[r * LDT + d];
    }
  }
}


// ---------------------------------------------------------------------------

cudaError_t launch(void (*kernel)(const BwdArgs), size_t smem, dim3 grid,
                   const BwdArgs& a, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

// Tensor maps of a bf16 launch, in this order: q, k, v, dO (boxes of
// `q_box`, `k_box`, `k_box` and `q_box` rows), then the outputs (boxes of
// 64 rows): dq, or dk and dv.  Returns 0, a cudaError_t, or
// -(CUresult * 8 + m) when map m is refused.
int encode_maps(const BwdArgs& a, int which, int D, uint32_t q_box,
                uint32_t k_box, CUtensorMap* maps) {
  hopper::EncodeTiled encode;
  cudaError_t err = hopper::encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  const bool dq = which == 0;
  const void* ptrs[6] = {a.q, a.k, a.v, a.dout, dq ? a.dq : a.dk, a.dv};
  const long long* strides[6] = {a.qs, a.ks, a.vs, a.dos,
                                 dq ? a.dqs : a.dks, a.dvs};
  const int rows[6] = {a.S, a.Sk, a.Sk, a.S, dq ? a.S : a.Sk, a.Sk};
  const int heads[6] = {a.H, a.Hkv, a.Hkv, a.H, dq ? a.H : a.Hkv, a.Hkv};
  const uint32_t boxes[6] = {q_box, k_box, k_box, q_box, 64, 64};
  for (int m = 0; m < (dq ? 5 : 6); ++m) {
    const CUresult r = hopper::encode_bf16_4d(
        encode, &maps[m], ptrs[m], D, rows[m], heads[m], a.B, strides[m][2],
        strides[m][1], strides[m][0], boxes[m]);
    if (r != CUDA_SUCCESS) return -(static_cast<int>(r) * 8 + m);
  }
  return 0;
}

// Persistent grid: one block per SM, at most one per unit.
int persistent_grid(int64_t units, int* grid) {
  int device, sms;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  *grid = (int)(units < sms ? units : sms);
  return 0;
}

template <int D>
int launch_dkv_hopper(const BwdArgs& a, cudaStream_t stream) {
  CUtensorMap maps[6];
  int err = encode_maps(a, 1, D, Dkv<D>::BQ, TILE, maps);
  if (err) return err;
  auto kernel = dkv_hopper<D>;
  const size_t smem = Dkv<D>::bytes;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  int grid;
  if ((err = persistent_grid(
           (int64_t)((a.Sk + TILE - 1) / TILE) * a.Hkv * a.B, &grid)))
    return err;
  kernel<<<grid, HTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], maps[5], a.lse, a.delta,
      a.B, a.H, a.Hkv, a.S, a.Sk, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D>
int launch_dq_hopper(const BwdArgs& a, cudaStream_t stream) {
  CUtensorMap maps[5];
  int err = encode_maps(a, 0, D, TILE, Dq<D>::BK, maps);
  if (err) return err;
  auto kernel = dq_hopper<D>;
  const size_t smem = Dq<D>::bytes;
  if ((err = cudaFuncSetAttribute(
           kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem)))
    return err;
  int grid;
  if ((err = persistent_grid(
           (int64_t)((a.S + TILE - 1) / TILE) * a.H * a.B, &grid)))
    return err;
  kernel<<<grid, HTHREADS, smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a.lse, a.delta, a.B, a.H,
      a.Hkv, a.S, a.Sk, a.scale, a.causal);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// which: 0 = dQ, 1 = dK/dV.  dtype: 0 = bfloat16, 1 = float32.  The caller
// has checked shapes, 16-byte alignment, D in {64, 128}, and that lse and
// delta are contiguous fp32 [B, H, S].  Returns a cudaError_t (0 on
// success), or, when cuTensorMapEncodeTiled refuses a tensor map of the
// bf16 kernels, -(CUresult * 8 + m) with m = 0..3 for q, k, v, dO, 4
// for dq or dk and 5 for dv; nothing is launched then.
int dstpu_flash_bwd(const BwdArgs* a, int which, int dtype, int D,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 gq((a->S + BM - 1) / BM, a->H, a->B);
  const dim3 gk((a->Sk + BN - 1) / BN, a->Hkv, a->B);
  if (which == 0) {
    if (dtype == 0 && D == 64) return launch_dq_hopper<64>(*a, st);
    if (dtype == 0 && D == 128) return launch_dq_hopper<128>(*a, st);
    if (dtype == 1 && D == 64)
      return launch(dq_f32<64>, SmemF32<64>::dq_bytes, gq, *a, st);
    if (dtype == 1 && D == 128)
      return launch(dq_f32<128>, SmemF32<128>::dq_bytes, gq, *a, st);
  } else if (which == 1) {
    if (dtype == 0 && D == 64) return launch_dkv_hopper<64>(*a, st);
    if (dtype == 0 && D == 128) return launch_dkv_hopper<128>(*a, st);
    if (dtype == 1 && D == 64)
      return launch(dkv_f32<64>, SmemF32<64>::dkv_bytes, gk, *a, st);
    if (dtype == 1 && D == 128)
      return launch(dkv_f32<128>, SmemF32<128>::dkv_bytes, gk, *a, st);
  }
  return cudaErrorInvalidValue;
}

// Dynamic shared memory of a bf16 kernel (which as above) at head dim D,
// in bytes.
int dstpu_flash_bwd_smem_bytes(int which, int D) {
  if (which == 0)
    return D == 64 ? (int)Dq<64>::bytes : D == 128 ? (int)Dq<128>::bytes : 0;
  return D == 64 ? (int)Dkv<64>::bytes : D == 128 ? (int)Dkv<128>::bytes : 0;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
