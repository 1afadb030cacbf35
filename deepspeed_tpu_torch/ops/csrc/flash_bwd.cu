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
// tile) pair across the two kernels (dQ: QK^T, dO V^T, dS K; dK/dV:
// KQ^T, V dO^T, P^T dO, dS^T Q, i.e. 6*D and 8*D operations per valid
// pair) against q, k, v, dO, dq, dk, dv bytes.  At the training shape
// (B=4, H=32, Hkv=4, S=2048, D=64, causal) that is ~0.10 ms and ~0.14 ms
// of tensor-core time versus ~0.05 ms of memory: compute-bound.
//
// What this design does about it (a simple kernel first; wgmma and TMA
// come later):
// - dQ: one block of 4 warps per (64-row q tile, q head, batch), each warp
//   owning 16 rows.  A loop inside the block walks the key tiles up to
//   the causal bound (the TPU's sequential grid axis) and keeps dQ in fp32
//   registers; K and V tiles are double-buffered with cp.async.
// - dK/dV: one block per (64-row key tile, KV head, batch), each warp
//   owning 16 key rows.  It loops over the group's q heads and their q
//   tiles (double-buffered Q, dO, lse and delta) and keeps dK and dV in
//   fp32 registers, so the GQA group sum happens in registers and the
//   [B,H,Sk,D] fp32 intermediate of the TPU version never exists.
// - Products are mma.sync m16n8k16 (bf16 in, fp32 accumulate); P and dS
//   are rounded to bf16 as the A operand of the next product, as the TPU
//   kernels cast them to the input dtype.  Q, dO, K and V fragments are
//   re-read from shared memory (ldmatrix) rather than held in registers,
//   to leave the registers to the accumulators.
// - No atomics: every block owns its output tile, so two identical calls
//   give bit-identical gradients.
// - fp32 inputs take SIMT kernels in full fp32 (no TF32), off the
//   training path, so an fp32 model matches the CPU.
// - q, k, v, dO and the outputs are addressed through (batch, head,
//   sequence) strides with a contiguous head dim: the [B,S,H,D]
//   projections and the [B,S,H,D] gradient buffers need no transpose copy.
// - Shared memory exceeds 48 KB at D=128 (and for fp32), so the launcher
//   raises the dynamic limit and returns cudaGetLastError().
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

constexpr int BM = 64;  // q rows per tile
constexpr int BN = 64;  // key rows per tile
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
// bf16: mma.sync
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start the copy of `rows` rows (row stride `stride`) into a 64-row tile;
// the rest is zero-filled, so padded rows add nothing and hold no NaN.
template <int D, int LD>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int64_t stride, int rows) {
  constexpr int CPR = D / 8;
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + c, src + (ok ? (int64_t)r * stride + c : 0), ok);
  }
}

// A operand (16 rows of this warp x 16 columns at kt) from a row-major tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int LD, int warp, int lane, int kt) {
  ldmatrix_x4(a, tile + (warp * WM + lane % 16) * LD + kt * 16 + lane / 16 * 8);
}
// B operand of X Y^T: rows np*16.. of Y (two 8-column score tiles), k-step kt
__device__ __forceinline__ void load_bt(uint32_t (&b)[4], const bf16* tile,
                                        int LD, int lane, int np, int kt) {
  ldmatrix_x4(b, tile + (np * 16 + lane % 8 + lane / 16 * 8) * LD + kt * 16 +
                     (lane / 8) % 2 * 8);
}
// B operand of X Y with Y [k rows, D]: rows kk*16.., output columns dp*16..
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int LD, int lane, int kk, int dp) {
  ldmatrix_x4_trans(b, tile + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) * LD +
                           dp * 16 + lane / 16 * 8);
}

template <int D>
struct SmemBf16 {
  static constexpr int LD = D + 8;  // 16 bytes of pad per row
  static constexpr size_t tile = sizeof(bf16) * 64 * LD;
  static constexpr size_t dq_bytes = 6 * tile;              // Q, dO, K[2], V[2]
  static constexpr size_t dkv_bytes = 6 * tile + 4 * 64 * 4;  // + lse, delta
};

// Register layout of a warp's 16 rows (m16n8k16 fragments): lane
// (g = lane/4, t = lane%4) holds rows g and g+8 and, in every 8-wide
// column tile, the columns 2t and 2t+1.
template <int D>
__global__ void __launch_bounds__(THREADS) dq_bf16(const BwdArgs a) {
  using L = SmemBf16<D>;
  constexpr int LD = L::LD, KD = D / 16, ND = D / 8, NS = BN / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* dOs = Qs + 64 * LD;
  bf16* Ks = dOs + 64 * LD;      // two buffers
  bf16* Vs = Ks + 2 * 64 * LD;   // two buffers

  // the last q tiles do the most causal work: start them first
  const int i = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int S = a.S, Sk = a.Sk, causal = a.causal;
  const int kvh = h / (a.H / a.Hkv);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = i * BM, offset = Sk - S;
  const int row0 = q0 + warp * WM + g;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.ks[0] + kvh * a.ks[1];
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.vs[0] + kvh * a.vs[1];
  const int nk = key_tiles(q0, S, Sk, causal);
  const int qrows = min(BM, S - q0);

  load_tile_async<D, LD>(Qs, static_cast<const bf16*>(a.q) + b * a.qs[0] +
                                 h * a.qs[1] + q0 * a.qs[2],
                         a.qs[2], qrows);
  load_tile_async<D, LD>(dOs, static_cast<const bf16*>(a.dout) +
                                  b * a.dos[0] + h * a.dos[1] + q0 * a.dos[2],
                         a.dos[2], qrows);
  if (nk > 0) {
    load_tile_async<D, LD>(Ks, kb, a.ks[2], min(BN, Sk));
    load_tile_async<D, LD>(Vs, vb, a.vs[2], min(BN, Sk));
  }
  cp_async_commit();

  float lse2[2], dl[2];  // this lane's rows: lse in the log2 domain, delta
  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    const int64_t idx = ((int64_t)b * a.H + h) * S + qpos;
    lse2[r] = qpos < S ? a.lse[idx] * LOG2E : INFINITY;
    dl[r] = qpos < S ? a.delta[idx] : 0.f;
  }
  const float scale2 = a.scale * LOG2E;
  float acc[ND][4];
  for (int n = 0; n < ND; ++n)
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int cur = j & 1;
    if (j + 1 < nk) {
      const int k1 = (j + 1) * BN, rows = min(BN, Sk - k1);
      load_tile_async<D, LD>(Ks + (cur ^ 1) * 64 * LD, kb + k1 * a.ks[2],
                             a.ks[2], rows);
      load_tile_async<D, LD>(Vs + (cur ^ 1) * 64 * LD, vb + k1 * a.vs[2],
                             a.vs[2], rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* Kt = Ks + cur * 64 * LD;
    const bf16* Vt = Vs + cur * 64 * LD;

    // S = Q K^T and dP = dO V^T: 16 rows x 64 keys each, fp32
    float s[NS][4], dp[NS][4];
    for (int n = 0; n < NS; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
    for (int kt = 0; kt < KD; ++kt) {
      uint32_t qa[4], da[4];
      load_a(qa, Qs, LD, warp, lane, kt);
      load_a(da, dOs, LD, warp, lane, kt);
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t kr[4], vr[4];
        load_bt(kr, Kt, LD, lane, np, kt);
        mma_bf16(s[2 * np], qa, kr[0], kr[1]);
        mma_bf16(s[2 * np + 1], qa, kr[2], kr[3]);
        load_bt(vr, Vt, LD, lane, np, kt);
        mma_bf16(dp[2 * np], da, vr[0], vr[1]);
        mma_bf16(dp[2 * np + 1], da, vr[2], vr[3]);
      }
    }

    // p from the saved lse, dS = p (dP - delta), repacked as bf16 A operand
    const int k0 = j * BN;
    const bool edge = (k0 + BN > Sk) || (causal && k0 + BN - 1 > q0 + offset);
    uint32_t dsf[BN / 16][4];
    for (int n = 0; n < NS; ++n) {
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int lim = causal ? row0 + (e / 2) * 8 + offset : Sk - 1;
          if (key >= Sk || key > lim) x = -INFINITY;
        }
        const float p = exp2f(x - lse2[e / 2]);
        s[n][e] = p * (dp[n][e] - dl[e / 2]);
      }
      dsf[n / 2][(n % 2) * 2] = pack_bf16(s[n][0], s[n][1]);
      dsf[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
    }

    // dQ += dS K
    for (int kk = 0; kk < BN / 16; ++kk) {
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t kr[4];
        load_b(kr, Kt, LD, lane, kk, d2);
        mma_bf16(acc[2 * d2], dsf[kk], kr[0], kr[1]);
        mma_bf16(acc[2 * d2 + 1], dsf[kk], kr[2], kr[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

  for (int r = 0; r < 2; ++r) {
    const int qpos = row0 + r * 8;
    if (qpos >= S) continue;
    bf16* orow = static_cast<bf16*>(a.dq) + b * a.dqs[0] + h * a.dqs[1] +
                 qpos * a.dqs[2];
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[n][2 * r] * a.scale,
                                acc[n][2 * r + 1] * a.scale);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS) dkv_bf16(const BwdArgs a) {
  using L = SmemBf16<D>;
  constexpr int LD = L::LD, KD = D / 16, ND = D / 8, NS = BM / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + 64 * LD;
  bf16* Qs = Vs + 64 * LD;       // two buffers
  bf16* dOs = Qs + 2 * 64 * LD;  // two buffers
  float* lse_s = reinterpret_cast<float*>(dOs + 2 * 64 * LD);  // [2][64]
  float* dl_s = lse_s + 2 * 64;                                 // [2][64]

  const int j = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int S = a.S, Sk = a.Sk, causal = a.causal, H = a.H;
  const int groups = H / a.Hkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int k0 = j * BN, offset = Sk - S;
  const int krow0 = k0 + warp * WM + g;  // this lane's keys: krow0, +8
  const int nq = (S + BM - 1) / BM;
  const int i0 = first_q_tile(k0, S, Sk, causal);
  const int per = max(nq - i0, 0);
  const int total = groups * per;

  const int krows = min(BN, Sk - k0);
  load_tile_async<D, LD>(Ks, static_cast<const bf16*>(a.k) + b * a.ks[0] +
                                 kvh * a.ks[1] + k0 * a.ks[2],
                         a.ks[2], krows);
  load_tile_async<D, LD>(Vs, static_cast<const bf16*>(a.v) + b * a.vs[0] +
                                 kvh * a.vs[1] + k0 * a.vs[2],
                         a.vs[2], krows);

  // iteration `it` is q head kvh*groups + it/per, q tile i0 + it%per
  auto issue = [&](int it, int buf) {
    const int h = kvh * groups + it / per;
    const int q0 = (i0 + it % per) * BM, rows = min(BM, S - q0);
    load_tile_async<D, LD>(Qs + buf * 64 * LD,
                           static_cast<const bf16*>(a.q) + b * a.qs[0] +
                               h * a.qs[1] + q0 * a.qs[2],
                           a.qs[2], rows);
    load_tile_async<D, LD>(dOs + buf * 64 * LD,
                           static_cast<const bf16*>(a.dout) + b * a.dos[0] +
                               h * a.dos[1] + q0 * a.dos[2],
                           a.dos[2], rows);
    const int64_t base = ((int64_t)b * H + h) * S + q0;
    for (int r = threadIdx.x; r < BM; r += THREADS) {
      lse_s[buf * 64 + r] = r < rows ? a.lse[base + r] * LOG2E : INFINITY;
      dl_s[buf * 64 + r] = r < rows ? a.delta[base + r] : 0.f;
    }
  };
  if (total > 0) issue(0, 0);
  cp_async_commit();

  const float scale2 = a.scale * LOG2E;
  float dk[ND][4], dv[ND][4];
  for (int n = 0; n < ND; ++n)
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  for (int it = 0; it < total; ++it) {
    const int cur = it & 1;
    if (it + 1 < total) {
      issue(it + 1, cur ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = (i0 + it % per) * BM;
    const bf16* Qt = Qs + cur * 64 * LD;
    const bf16* dOt = dOs + cur * 64 * LD;
    const float* lse2 = lse_s + cur * 64;
    const float* dlt = dl_s + cur * 64;

    // S^T = K Q^T: 16 keys x 64 queries, fp32; P^T = exp(S^T - lse)
    float s[NS][4];
    for (int n = 0; n < NS; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kt = 0; kt < KD; ++kt) {
      uint32_t ka[4];
      load_a(ka, Ks, LD, warp, lane, kt);
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t qr[4];
        load_bt(qr, Qt, LD, lane, np, kt);
        mma_bf16(s[2 * np], ka, qr[0], qr[1]);
        mma_bf16(s[2 * np + 1], ka, qr[2], qr[3]);
      }
    }
    const bool edge = (k0 + BN > Sk) || (causal && k0 + BN - 1 > q0 + offset);
    uint32_t pf[BM / 16][4];
    for (int n = 0; n < NS; ++n) {
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * scale2;
        if (edge) {
          const int key = krow0 + (e / 2) * 8;
          if (key >= Sk || (causal && key > q0 + c + offset)) x = -INFINITY;
        }
        s[n][e] = exp2f(x - lse2[c]);
      }
      pf[n / 2][(n % 2) * 2] = pack_bf16(s[n][0], s[n][1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(s[n][2], s[n][3]);
    }
    // dV += P^T dO
    for (int kk = 0; kk < BM / 16; ++kk) {
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t r[4];
        load_b(r, dOt, LD, lane, kk, d2);
        mma_bf16(dv[2 * d2], pf[kk], r[0], r[1]);
        mma_bf16(dv[2 * d2 + 1], pf[kk], r[2], r[3]);
      }
    }
    // dP^T = V dO^T; dS^T = P^T (dP^T - delta)
    float dp[NS][4];
    for (int n = 0; n < NS; ++n)
      for (int e = 0; e < 4; ++e) dp[n][e] = 0.f;
    for (int kt = 0; kt < KD; ++kt) {
      uint32_t va[4];
      load_a(va, Vs, LD, warp, lane, kt);
      for (int np = 0; np < NS / 2; ++np) {
        uint32_t dr[4];
        load_bt(dr, dOt, LD, lane, np, kt);
        mma_bf16(dp[2 * np], va, dr[0], dr[1]);
        mma_bf16(dp[2 * np + 1], va, dr[2], dr[3]);
      }
    }
    for (int n = 0; n < NS; ++n) {
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + 2 * t + (e & 1);
        dp[n][e] = s[n][e] * (dp[n][e] - dlt[c]);
      }
      pf[n / 2][(n % 2) * 2] = pack_bf16(dp[n][0], dp[n][1]);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(dp[n][2], dp[n][3]);
    }
    // dK += dS^T Q
    for (int kk = 0; kk < BM / 16; ++kk) {
      for (int d2 = 0; d2 < ND / 2; ++d2) {
        uint32_t r[4];
        load_b(r, Qt, LD, lane, kk, d2);
        mma_bf16(dk[2 * d2], pf[kk], r[0], r[1]);
        mma_bf16(dk[2 * d2 + 1], pf[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two iterations on
  }
  cp_async_wait<0>();

  for (int r = 0; r < 2; ++r) {
    const int key = krow0 + r * 8;
    if (key >= Sk) continue;
    bf16* krow = static_cast<bf16*>(a.dk) + b * a.dks[0] + kvh * a.dks[1] +
                 key * a.dks[2];
    bf16* vrow = static_cast<bf16*>(a.dv) + b * a.dvs[0] + kvh * a.dvs[1] +
                 key * a.dvs[2];
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<__nv_bfloat162*>(krow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dk[n][2 * r] * a.scale,
                                dk[n][2 * r + 1] * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(vrow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
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

}  // namespace

extern "C" {

// which: 0 = dQ, 1 = dK/dV.  dtype: 0 = bfloat16, 1 = float32.  The caller
// has checked shapes, 16-byte alignment, D in {64, 128}, and that lse and
// delta are contiguous fp32 [B, H, S].  Returns a cudaError_t.
int dstpu_flash_bwd(const BwdArgs* a, int which, int dtype, int D,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 gq((a->S + BM - 1) / BM, a->H, a->B);
  const dim3 gk((a->Sk + BN - 1) / BN, a->Hkv, a->B);
  if (which == 0) {
    if (dtype == 0 && D == 64)
      return launch(dq_bf16<64>, SmemBf16<64>::dq_bytes, gq, *a, st);
    if (dtype == 0 && D == 128)
      return launch(dq_bf16<128>, SmemBf16<128>::dq_bytes, gq, *a, st);
    if (dtype == 1 && D == 64)
      return launch(dq_f32<64>, SmemF32<64>::dq_bytes, gq, *a, st);
    if (dtype == 1 && D == 128)
      return launch(dq_f32<128>, SmemF32<128>::dq_bytes, gq, *a, st);
  } else if (which == 1) {
    if (dtype == 0 && D == 64)
      return launch(dkv_bf16<64>, SmemBf16<64>::dkv_bytes, gk, *a, st);
    if (dtype == 0 && D == 128)
      return launch(dkv_bf16<128>, SmemBf16<128>::dkv_bytes, gk, *a, st);
    if (dtype == 1 && D == 64)
      return launch(dkv_f32<64>, SmemF32<64>::dkv_bytes, gk, *a, st);
    if (dtype == 1 && D == 128)
      return launch(dkv_f32<128>, SmemF32<128>::dkv_bytes, gk, *a, st);
  }
  return cudaErrorInvalidValue;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
