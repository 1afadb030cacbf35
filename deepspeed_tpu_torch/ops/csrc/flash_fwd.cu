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
// nothing else may stall them.
//
// What this design does about it (wgmma and TMA come later):
// - One block of 4 warps per (64-row q tile, head, batch); each warp owns
//   16 q rows.  The TPU kernel carries m, l and acc across a sequential
//   grid axis in VMEM scratch; blocks on the GPU run in no order, so a
//   loop inside the block walks the K/V tiles instead.
// - bf16: the products are mma.sync m16n8k16 (bf16 in, fp32 accumulate)
//   with every running value in registers, in the FlashAttention-2
//   layout: the score tile, the row max and sum, and the fp32 output
//   accumulator never touch shared memory, and the score accumulators are
//   repacked in registers as the bf16 A operand of the PV product.
//   Operands come from shared memory through ldmatrix (rows padded by 16
//   bytes, so its eight row reads hit eight different bank groups).
// - K and V tiles are double-buffered with cp.async: the next tile is in
//   flight while the tensor cores work on this one.
// - fp32 inputs take a SIMT kernel in full fp32, so a float32 model
//   matches the CPU without TF32 rounding.  It is slow and off the serving
//   path.
// - Causal block skip: key tiles past the diagonal of the tile's last row
//   are never loaded; only tiles that cross the diagonal or the ragged
//   key edge pay for the mask, and the heaviest q tiles are scheduled
//   first.
// - sm_scale multiplies the fp32 score inside the kernel (the TPU folds it
//   into q in q's dtype).
// - q, k, v and o are addressed through batch, head and sequence strides
//   (the head dim is contiguous), so the [B,S,H,D] projections reach the
//   kernel without a transpose copy.
// - Shared memory is above the 48 KB static limit (85 KB bf16, 150 KB
//   fp32 at D=128), so the launcher raises the dynamic limit first, and it
//   returns cudaGetLastError() so that a refused launch is seen.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>
#include <cstdint>

namespace {

constexpr int BM = 64;             // q rows per block
constexpr int BN = 64;             // key rows per tile
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

// Key tiles a q tile needs: causal rows see no key past the diagonal of
// the tile's last row.
__device__ __forceinline__ int key_tiles(int q0, int S, int Sk, int causal) {
  const int nk = (Sk + BN - 1) / BN;
  if (!causal) return nk;
  const int last = min(q0 + BM, S) - 1 + (Sk - S);
  return last < 0 ? 0 : min(nk, last / BN + 1);
}

// ---------------------------------------------------------------------------
// bf16: mma.sync with register-resident softmax state
// ---------------------------------------------------------------------------

template <int D>
struct SmemBf16 {
  static constexpr int LD = D + 8;  // elements per row: 16 bytes of pad
  static constexpr size_t tile = sizeof(__nv_bfloat16) * 64 * LD;
  static constexpr size_t bytes = 5 * tile;  // Q, K[2], V[2]
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; `valid` false writes 16 zero bytes instead
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
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // round to nearest even
  return *reinterpret_cast<uint32_t*>(&v);
}

// Start the copy of `rows` rows of D elements (row stride `stride`) into
// a 64-row shared tile; the rest of the tile is zero-filled, so padded
// keys and values contribute nothing and no NaN can reach the products.
template <int D, int LD>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst,
                                                const __nv_bfloat16* src,
                                                int64_t stride, int rows) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < 64 * CPR; idx += THREADS) {
    const int r = idx / CPR, c = (idx % CPR) * 8;
    const bool ok = r < rows;
    cp_async16(dst + r * LD + c, src + (ok ? (int64_t)r * stride + c : 0), ok);
  }
}

// Register layout of one warp's 16 rows (m16n8k16 fragments): lane
// (g = lane/4, t = lane%4) holds rows g and g+8, and in every 8-wide
// column tile the columns 2t and 2t+1.
template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_bf16(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int H,
               int groups, int S, int Sk, int64_t qsb, int64_t qsh,
               int64_t qss, int64_t ksb, int64_t ksh, int64_t kss,
               int64_t vsb, int64_t vsh, int64_t vss, int64_t osb,
               int64_t osh, int64_t oss, float scale, int causal) {
  using L = SmemBf16<D>;
  constexpr int LD = L::LD;
  constexpr int KD = D / 16;   // k-steps over the head dim
  constexpr int ND = D / 8;    // 8-wide output column tiles
  constexpr int NS = BN / 8;   // 8-wide score column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* Ks = Qs + 64 * LD;      // two buffers
  __nv_bfloat16* Vs = Ks + 2 * 64 * LD;  // two buffers

  // the last q tiles do the most causal work: start them first
  const int i = gridDim.x - 1 - blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int q0 = i * BM;
  const int offset = Sk - S;  // bottom-right causal alignment
  const int row0 = q0 + warp * WM + g;  // this lane's rows: row0, row0 + 8
  const __nv_bfloat16* kb = k + b * ksb + (h / groups) * ksh;
  const __nv_bfloat16* vb = v + b * vsb + (h / groups) * vsh;
  const int nk = key_tiles(q0, S, Sk, causal);

  load_tile_async<D, LD>(Qs, q + b * qsb + h * qsh + q0 * qss, qss,
                         min(BM, S - q0));
  if (nk > 0) {
    load_tile_async<D, LD>(Ks, kb, kss, min(BN, Sk));
    load_tile_async<D, LD>(Vs, vb, vss, min(BN, Sk));
  }
  cp_async_commit();

  const float scale2 = scale * LOG2E;  // scores in the log2 domain
  float acc[ND][4];
  for (int n = 0; n < ND; ++n)
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m_r[2] = {-INFINITY, -INFINITY};
  float l_r[2] = {0.f, 0.f};  // this lane's share of the row sums
  uint32_t qf[KD][4];

  for (int j = 0; j < nk; ++j) {
    const int cur = j & 1;
    if (j + 1 < nk) {  // next tile in flight behind this one's math
      const int k1 = (j + 1) * BN, rows = min(BN, Sk - k1);
      load_tile_async<D, LD>(Ks + (cur ^ 1) * 64 * LD, kb + k1 * kss, kss,
                             rows);
      load_tile_async<D, LD>(Vs + (cur ^ 1) * 64 * LD, vb + k1 * vss, vss,
                             rows);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
      for (int kt = 0; kt < KD; ++kt)
        ldmatrix_x4(qf[kt],
                    Qs + (warp * WM + lane % 16) * LD + kt * 16 + lane / 16 * 8);
    }
    const __nv_bfloat16* Kt = Ks + cur * 64 * LD;
    const __nv_bfloat16* Vt = Vs + cur * 64 * LD;

    // S = Q K^T: 16 rows x 64 keys, unscaled, fp32
    float s[NS][4];
    for (int n = 0; n < NS; ++n)
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
    for (int kt = 0; kt < KD; ++kt) {
      for (int np = 0; np < NS / 2; ++np) {  // two key tiles per ldmatrix
        uint32_t kr[4];
        ldmatrix_x4(kr, Kt + (np * 16 + lane % 8 + lane / 16 * 8) * LD +
                            kt * 16 + (lane / 8) % 2 * 8);
        mma_bf16(s[2 * np], qf[kt], kr[0], kr[1]);
        mma_bf16(s[2 * np + 1], qf[kt], kr[2], kr[3]);
      }
    }

    // scale, mask, and the running row max
    const int k0 = j * BN;
    const bool edge = (k0 + BN > Sk) || (causal && k0 + BN - 1 > q0 + offset);
    float mx[2] = {m_r[0], m_r[1]};
    for (int n = 0; n < NS; ++n) {
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * scale2;
        if (edge) {
          const int key = k0 + n * 8 + 2 * t + (e & 1);
          const int lim = causal ? row0 + (e / 2) * 8 + offset : Sk - 1;
          if (key >= Sk || key > lim) x = MASK;
        }
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

    // p = exp(s - m): summed in fp32, and repacked as the bf16 A operand
    // of the PV product (p enters it in v's dtype, as in the reference)
    uint32_t pf[BN / 16][4];
    for (int n = 0; n < NS; ++n) {
      const float p0 = exp2f(s[n][0] - m_r[0]), p1 = exp2f(s[n][1] - m_r[0]);
      const float p2 = exp2f(s[n][2] - m_r[1]), p3 = exp2f(s[n][3] - m_r[1]);
      l_r[0] += p0 + p1;
      l_r[1] += p2 + p3;
      pf[n / 2][(n % 2) * 2] = pack_bf16(p0, p1);
      pf[n / 2][(n % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // acc += P V
    for (int kk = 0; kk < BN / 16; ++kk) {
      for (int dp = 0; dp < ND / 2; ++dp) {  // two column tiles per ldmatrix
        uint32_t vr[4];
        ldmatrix_x4_trans(vr, Vt + (kk * 16 + lane % 8 + (lane / 8) % 2 * 8) *
                                       LD +
                                  dp * 16 + lane / 16 * 8);
        mma_bf16(acc[2 * dp], pf[kk], vr[0], vr[1]);
        mma_bf16(acc[2 * dp + 1], pf[kk], vr[2], vr[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();  // nothing left in flight when no tile ran

  // finalize: o = acc / l; rows that never saw a valid key give 0, +inf
  for (int r = 0; r < 2; ++r) {
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 1);
    l_r[r] += __shfl_xor_sync(FULL, l_r[r], 2);
    const int qpos = row0 + r * 8;
    if (qpos >= S) continue;
    const bool valid = m_r[r] > MASK * 0.5f;
    const float l = fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* orow = o + b * osb + h * osh + qpos * oss;
    for (int n = 0; n < ND; ++n) {
      const float x0 = valid ? acc[n][2 * r] / l : 0.f;
      const float x1 = valid ? acc[n][2 * r + 1] / l : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + n * 8 + 2 * t) =
          __floats2bfloat162_rn(x0, x1);
    }
    if (t == 0)
      lse[((int64_t)b * H + h) * S + qpos] =
          valid ? m_r[r] * LN2 + logf(l) : INFINITY;
  }
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
// cudaError_t (0 on success).
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
  if (dtype == 0 && D == 64)
    return launch(flash_fwd_bf16<64>, SmemBf16<64>::bytes, a, st);
  if (dtype == 0 && D == 128)
    return launch(flash_fwd_bf16<128>, SmemBf16<128>::bytes, a, st);
  if (dtype == 1 && D == 64)
    return launch(flash_fwd_f32<64>, SmemF32<64>::bytes, a, st);
  if (dtype == 1 && D == 128)
    return launch(flash_fwd_f32<128>, SmemF32<128>::bytes, a, st);
  return cudaErrorInvalidValue;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
