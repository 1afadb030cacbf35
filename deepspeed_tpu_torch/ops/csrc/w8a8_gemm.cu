// The W8A8 Linear for Hopper (sm_90a): y = x W^T with the activations
// quantized per row to int8, an int8 x int8 -> int32 product on the
// tensor cores (wgmma s8) and the rescale in the product's epilogue.  Two
// launches a call: the row pre-pass (w8a8_rows) and the GEMM (w8a8_gemm),
// which starts while the pre-pass runs.  A plain C interface, loaded with
// ctypes (deepspeed_tpu_torch/ops/quantization.py, w8a8_gemm).
//
// Replaces no Pallas kernel.  It is the card's version of the JAX
// w8a8_dot_general (deepspeed_tpu/inference/quantization.py:180-205),
// which XLA fuses around one dot, and it stands in for the three launches
// of the port's first design: K3 w8a8_quant_rows (of which w8a8_rows is
// the redesign), torch._int_mm (an int32 [M, N] matrix written to device
// memory; it refused 16 rows or fewer, so rows were padded to 17) and K4
// w8a8_epilogue (that matrix read back and rescaled).
//
// What it computes, bit for bit as the plain version
// (w8a8_linear_reference): for x [M, K] (bf16, fp16 or fp32), v int8
// [N, K] and s fp32 [N] (quantize_per_channel's payload and scales)
//   sx[m]  = max|x[m, :]| / 127, the max over |x|'s bits (it keeps a NaN
//            and does not depend on the order it is taken in)
//   xq     = clip(rint(x / max(sx, 1e-12)), -127, 127), a NaN quotient 0
//   acc    = sum_k xq[m, k] v[n, k], exact in int32 (127^2 x 14336 < 2^31)
//   y      = cast((float(acc) * sx[m]) * s[n])
// with __fdiv_rn (see quant_one), __fmul_rn and __int2float_rn: never an
// FMA.  Integer sums are exact and associative, so the order in which the
// kernel adds partial products (over k steps, blocks) cannot change a
// bit.
//
// What bounds it on this card.  Decode (16 rows): the int8 weight read,
// N x K bytes at 3.35 TB/s; llama3-8b's gate_proj [14336, 4096] is 58.7
// MB, 0.0177 ms.  512 rows: int8 operations, 2 M N K at 1,979 TOP/s;
// gate_proj 60 G operations, 0.0304 ms.  What the design does:
// - Orientation.  The weight is the 64-row wgmma operand and the tokens
//   the N side: y^T = v xq^T with wgmma.m64nNk32.s32.s8.s8.  Both operands
//   are K-major as 8-bit wgmma requires, and so are v's [out, in] rows and
//   xq's rows: no transpose.  At decode N is 16 tokens.  A tile is 128
//   output channels, two consumer warpgroups of 64; one producer warp
//   keeps a TMA ring of stages (a 128 x 128-byte weight panel and the
//   token tile's 128-byte panel of xq, the 128-byte swizzle) full.
// - Decode, M <= 64: a weight stream.  One block an SM with a ring of up
//   to 12 stages (216 KB in flight an SM); the work, tiles x K/128
//   panels, is cut into as many equal intervals as blocks (stream-K), so
//   every SM reads the same weight bytes whatever N is (k_proj's 8 tiles
//   or the head's 1002).  A tile split between blocks meets through int32
//   sums (red.global.add) and a ticket; the block that reaches it last
//   in its own run finishes it; sums and ticket reset themselves.
// - Larger M (the 512-token prefill chunk, the 80-row verify tick): 128-
//   or 256-token tiles, a block a tile and K range.
// - The row scales (what replaces K3): the pre-pass, a block a row, writes
//   xq and sx once.  The GEMM is launched with programmatic dependent
//   launch: its producer loads its first ring of weight panels while the
//   pre-pass runs and waits (griddepcontrol.wait) only before the xq
//   panels.  A design that quantized x inside the GEMM (each block taking
//   the row max of its rows, then quantizing its K panels into shared
//   memory) measured slower: the prologue every block repeated cost more
//   than the weight ring could hide (PERF.md, the W8A8 findings).
// - Epilogue (what replaces K4): each thread converts its accumulators,
//   multiplies by sx[token] and then s[channel], casts, and stores; the
//   int32 products never go through device memory.
//
// Shapes it refuses (the wrapper raises first): K not a multiple of 16
// (the int8 rows' pitch must be a multiple of 16 bytes for TMA), x, xq or
// v off 16 bytes.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;                    // output channels a tile
constexpr uint32_t PANEL_A = BM * 128;     // a weight panel: 128 x 128 B
constexpr float Q_MAX = 127.f;
constexpr float EPS = 1e-12f;

// the GEMM: two consumer warpgroups of 64 channels and a producer warp
constexpr int P_THREADS = 288;
// the row pre-pass: a block a row, of 512 threads where the rows are
// fewer than the SMs (so that a long row is read in few round trips), of
// 128 where they are many
constexpr int R_WIDE = 512, R_NARROW = 128;

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}

// max(s, eps) that keeps a NaN, as torch.clamp_min and jnp.maximum
__device__ __forceinline__ float divisor(float s) { return s < EPS ? EPS : s; }

// clip(rint(v / d), -127, 127) as an int8 byte, a NaN quotient 0, exactly
// as with __fdiv_rn, from r = 1/d (__frcp_rn): q = v r lies within 2^-16
// of v / d and of its rounding (|v / d| <= 127 and both round once at
// 2^-24 relative), so where q is 2^-10 or more from a half-integer both
// round to the same integer; nearer, the division decides.  NaN and inf
// give the division's result too (NaN q fails the test; inf clips).
__device__ __forceinline__ uint32_t quant_one(float v, float d, float r) {
  const float q = __fmul_rn(v, r);
  float t = rintf(q);
  if (fabsf(fabsf(q - t) - 0.5f) < 0.0009765625f) t = rintf(__fdiv_rn(v, d));
  if (t != t) return 0u;
  // the clipped integer's low byte: 1.5 x 2^23 + t holds t in its low bits
  return __float_as_uint(fminf(fmaxf(t, -Q_MAX), Q_MAX) + 12582912.f) &
         0xFFu;
}

// 16 values of a row as 16-byte vectors: 2 of bf16 or fp16, 4 of fp32
template <typename T>
struct Chunk {
  static constexpr int VEC = 16 / sizeof(T);
  Vec<T, VEC> a[16 / VEC];
};

template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c, const T* src) {
#pragma unroll
  for (int j = 0; j < 16 / Chunk<T>::VEC; ++j)
    c.a[j] = *reinterpret_cast<const Vec<T, Chunk<T>::VEC>*>(
        src + j * Chunk<T>::VEC);
}

// a chunk quantized by divisor d (r = 1/d): 16 int8
template <typename T>
__device__ __forceinline__ uint4 quant16(const Chunk<T>& c, float d,
                                         float r) {
  constexpr int VEC = Chunk<T>::VEC;
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < 16 / VEC; ++j)
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      w[(j * VEC + k) / 4] |= quant_one(to_float(c.a[j].v[k]), d, r)
                              << (8 * ((j * VEC + k) % 4));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

template <int TN>
__device__ __forceinline__ void wgmma_s8(int32_t (&d)[TN / 2], uint64_t a,
                                         uint64_t b) {
  if constexpr (TN == 16) hopper::wgmma_m64n16k32_s8(d, a, b, 1);
  if constexpr (TN == 32) hopper::wgmma_m64n32k32_s8(d, a, b, 1);
  if constexpr (TN == 64) hopper::wgmma_m64n64k32_s8(d, a, b, 1);
  if constexpr (TN == 128) hopper::wgmma_m64n128k32_s8(d, a, b, 1);
  if constexpr (TN == 256) hopper::wgmma_m64n256k32_s8(d, a, b, 1);
}

// One 128-byte k panel: four k32 steps of the warpgroup's 64 weight rows
// (at a_rows) against the token tile's panel.
template <int TN>
__device__ __forceinline__ void panel_mma(int32_t (&acc)[TN / 2],
                                          uint32_t a_rows, uint32_t b_panel) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_s8<TN>(acc, hopper::wgmma_desc(a_rows + kk * 32, 16, 1024),
                 hopper::wgmma_desc(b_panel + kk * 32, 16, 1024));
}

// A tile whose K panels are split between blocks: each block but one adds
// its partial into the tile's int32 sums ([register][thread] order over
// the 256 consumer threads, coalesced; red.global.add, no round trip) and
// takes a ticket.  The `finisher` waits until the others' tickets are in,
// adds the sums to its registers, leaves sums and ticket zeroed for the
// next call, and returns true.  The finisher is the block that reaches
// the tile last in its own run (the others reach it at their start), so
// it rarely waits; all blocks of the grid are resident (one an SM at
// most).  Integer sums are exact in any order.  Every consumer thread
// calls it.
template <int TN>
__device__ __forceinline__ bool split_reduce(int32_t (&acc)[TN / 2],
                                             int32_t* __restrict__ sums,
                                             int sharers, bool finisher,
                                             uint32_t* ticket, int tid) {
  if (!finisher) {
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) atomicAdd(sums + i * 256 + tid, acc[i]);
    __threadfence();
    hopper::named_barrier_sync(1, 256);
    if (tid == 0) atomicAdd(ticket, 1u);
    return false;
  }
  if (tid == 0) {
    while (*reinterpret_cast<volatile uint32_t*>(ticket) !=
           static_cast<uint32_t>(sharers - 1))
      __nanosleep(64);
    *ticket = 0u;
  }
  hopper::named_barrier_sync(1, 256);
  __threadfence();
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) {
    acc[i] += __ldcg(sums + i * 256 + tid);
    __stcg(sums + i * 256 + tid, 0);
  }
  return true;
}

// y[tok, ch] = cast((float(acc) * sx[tok]) * s[ch]) for this thread's
// accumulators: channels ch0 + 16 warp + g (+8), tokens tok0 + 8j + 2 t4
// (+1), the m64nN layout.
template <typename T, int TN>
__device__ __forceinline__ void epilogue(const int32_t (&acc)[TN / 2],
                                         const float* __restrict__ sx,
                                         const float* __restrict__ s,
                                         T* __restrict__ y, int ch0, int tok0,
                                         int M, int N, int warp, int lane) {
  const int g = lane / 4, t4 = lane % 4;
  const int c[2] = {ch0 + 16 * warp + g, ch0 + 16 * warp + g + 8};
  const float sc[2] = {c[0] < N ? s[c[0]] : 0.f, c[1] < N ? s[c[1]] : 0.f};
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ch = c[e / 2], tok = tok0 + 8 * j + 2 * t4 + (e & 1);
      if (tok < M && ch < N)
        y[(int64_t)tok * N + ch] = from_float<T>(__fmul_rn(
            __fmul_rn(__int2float_rn(acc[4 * j + e]), sx[tok]), sc[e / 2]));
    }
  }
}

// ---------------------------------------------------------------------------
// The row pre-pass (K3's redesign)
// ---------------------------------------------------------------------------

// A block of R_THREADS threads a row, 4 loads of 16 bytes a thread in
// flight: the max over the row, then the row again (from L1/L2) quantized
// 16 values at a time.  It lets the GEMM that follows start at once (the
// GEMM streams its first weight panels while this runs).
template <typename T, int R_THREADS>
__global__ void __launch_bounds__(R_THREADS)
w8a8_rows(const T* __restrict__ x, int8_t* __restrict__ xq,
          float* __restrict__ sx, int M, int K) {
  constexpr int VEC = Chunk<T>::VEC;
  __shared__ uint32_t wmax[R_THREADS / 32];
  hopper::griddep_launch_dependents();
  const int tid = threadIdx.x, lane = tid % 32;
  const T* row = x + (int64_t)blockIdx.x * K;
  uint32_t mx = 0;
  for (int i0 = tid * VEC; i0 < K; i0 += 4 * R_THREADS * VEC) {
    Vec<T, VEC> a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j * R_THREADS * VEC < K)
        a[j] = *reinterpret_cast<const Vec<T, VEC>*>(row + i0 +
                                                     j * R_THREADS * VEC);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (i0 + j * R_THREADS * VEC < K)
#pragma unroll
        for (int k = 0; k < VEC; ++k)
          mx = max(mx, __float_as_uint(fabsf(to_float(a[j].v[k]))));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if (lane == 0) wmax[tid / 32] = mx;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < R_THREADS / 32; ++w) mx = max(mx, wmax[w]);
  const float sv = __fdiv_rn(__uint_as_float(mx), Q_MAX);
  if (tid == 0) sx[blockIdx.x] = sv;
  const float d = divisor(sv), r = __frcp_rn(d);
  int8_t* out = xq + (int64_t)blockIdx.x * K;
  const int chunks = K / 16;
  for (int c0 = tid; c0 < chunks; c0 += 4 * R_THREADS) {
    Chunk<T> c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j * R_THREADS < chunks)
        load_chunk(c[j], row + (c0 + j * R_THREADS) * 16);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (c0 + j * R_THREADS < chunks)
        *reinterpret_cast<uint4*>(out + (c0 + j * R_THREADS) * 16) =
            quant16(c[j], d, r);
  }
}

// ---------------------------------------------------------------------------
// The GEMM
// ---------------------------------------------------------------------------

// A stage: one weight panel (128 channels x 128 bytes of K) and the token
// tile's panel of xq (TN rows x 128 bytes), both in the 128-byte swizzle.
__host__ __device__ constexpr uint32_t stage_bytes(int tn) {
  return PANEL_A + tn * 128;
}
// as many stages as fit in a block's shared memory, at most MAX_STAGES:
// 12 at 16 tokens (216 KB in flight), 7 at 128, 4 at 256
constexpr int MAX_STAGES = 16;
__host__ __device__ constexpr int gemm_stages(int tn) {
  return (232448 - 1024 - 16) / (stage_bytes(tn) + 16) > MAX_STAGES
             ? MAX_STAGES
             : (int)((232448 - 1024 - 16) / (stage_bytes(tn) + 16));
}
__host__ __device__ constexpr uint32_t gemm_smem_bytes(int tn) {
  return 1024 + gemm_stages(tn) * (stage_bytes(tn) + 16) + 16;
}

// The block that owns unit u of U units cut into G equal intervals,
// [b U / G, (b + 1) U / G).
__device__ __forceinline__ int64_t owner(int64_t u, int64_t U, int G) {
  return ((u + 1) * G - 1) / U;
}

// The work is units: a (token tile, channel tile)'s 128-byte panel of K.
// STREAM (one token tile, M <= 64): one block an SM, block b of G taking
// the units [b U / G, (b + 1) U / G) of the U = tiles x P, tile by tile,
// so every SM reads the same weight bytes whatever N and K are.  Else
// (128- or 256-token tiles): grid (tiles, ksplit, token tiles), block
// (tile, ks, tt) taking the panels of K range ks of that tile.  Each block
// walks its units as segments of one tile: the product over the segment's
// panels (one panel's wgmma in flight while the next waits), then the
// epilogue, after the other blocks' partials where the tile is shared
// (through its sums and ticket).  Warpgroup w owns channels 64w..64w+63
// of a tile.
template <typename T, int TN, bool STREAM>
__global__ void __launch_bounds__(P_THREADS, 1)
w8a8_gemm(const __grid_constant__ CUtensorMap tw,
          const __grid_constant__ CUtensorMap tx,
          const float* __restrict__ sx, const float* __restrict__ s,
          T* __restrict__ y, int32_t* __restrict__ sums,
          uint32_t* __restrict__ tickets, int M, int N, int K, int kr,
          int tiles) {
  constexpr int STAGES = gemm_stages(TN);
  constexpr uint32_t STAGE = stage_bytes(TN);
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = hopper::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t bars = base + STAGES * STAGE;
  auto full = [&](int st) { return bars + 8u * st; };
  auto empty = [&](int st) { return bars + 8u * (STAGES + st); };

  const int P = (K + 127) / 128;  // panels a row
  int64_t U, u0, u1;
  int tt = 0;
  if constexpr (STREAM) {
    U = (int64_t)tiles * P;
    u0 = blockIdx.x * U / gridDim.x;
    u1 = (blockIdx.x + 1) * U / gridDim.x;
  } else {
    tt = blockIdx.z;
    U = (int64_t)tiles * P;
    u0 = (int64_t)blockIdx.x * P + blockIdx.y * (kr / 128);
    u1 = min(u0 + kr / 128, (int64_t)(blockIdx.x + 1) * P);
  }
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;

  if (tid == 0) {
    for (int st = 0; st < STAGES; ++st) {
      hopper::mbar_init(full(st), 1);
      hopper::mbar_init(empty(st), 8);  // a lane of each consumer warp
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (warp == 8) {
    // producer: the first ring of weight panels at once, while the row
    // pre-pass may still run; their xq panels once it is done; then both
    // as the consumers free stages
    if (lane == 0) {
      hopper::prefetch_tensormap(&tw);
      hopper::prefetch_tensormap(&tx);
      const int64_t first = min(u1, u0 + STAGES);
      int it = 0;
      for (int64_t u = u0; u < first; ++u, ++it) {
        hopper::mbar_expect_tx(full(it), STAGE);
        hopper::tma_load_2d(base + it * STAGE, &tw, full(it),
                            (int)(u % P) * 128, (int)(u / P) * BM);
      }
      hopper::griddep_wait();
      it = 0;
      for (int64_t u = u0; u < first; ++u, ++it)
        hopper::tma_load_2d(base + it * STAGE + PANEL_A, &tx, full(it),
                            (int)(u % P) * 128, tt * TN);
      for (int64_t u = first; u < u1; ++u, ++it) {
        const int st = it % STAGES;
        hopper::mbar_wait(empty(st), ((it / STAGES) & 1) ^ 1);
        hopper::mbar_expect_tx(full(st), STAGE);
        hopper::tma_load_2d(base + st * STAGE, &tw, full(st),
                            (int)(u % P) * 128, (int)(u / P) * BM);
        hopper::tma_load_2d(base + st * STAGE + PANEL_A, &tx, full(st),
                            (int)(u % P) * 128, tt * TN);
      }
    }
    return;
  }

  hopper::griddep_wait();  // sx is the pre-pass's
  const int wg = tid / 128;
  int it = 0;
  for (int64_t u = u0; u < u1;) {
    const int t = (int)(u / P);
    const int64_t end = min(u1, (int64_t)(t + 1) * P);  // the tile's units
    int32_t acc[TN / 2];
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[i] = 0;
    for (; u < end; ++u, ++it) {
      const int st = it % STAGES;
      hopper::mbar_wait(full(st), (it / STAGES) & 1);
      hopper::fence_operands(acc);
      hopper::wgmma_fence();
      panel_mma<TN>(acc, base + st * STAGE + wg * 64 * 128,
                    base + st * STAGE + PANEL_A);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
      hopper::fence_operands(acc);
      hopper::mbar_arrive_if(empty((it + STAGES - 1) % STAGES),
                             lane == 0 && it > 0);
    }
    hopper::wgmma_wait<0>();
    hopper::fence_operands(acc);
    // the blocks that share the tile; the finisher: in a stream, the
    // owner of its first panel (which reaches it at the end of its run),
    // else the first K range
    int sharers;
    bool finisher;
    int64_t unit;  // the (token tile, tile)'s sums and ticket
    if constexpr (STREAM) {
      const int64_t first = owner((int64_t)t * P, U, gridDim.x);
      sharers = (int)(owner((int64_t)(t + 1) * P - 1, U, gridDim.x) -
                      first) + 1;
      finisher = first == blockIdx.x;
      unit = t;
    } else {
      sharers = gridDim.y;
      finisher = blockIdx.y == 0;
      unit = (int64_t)tt * tiles + t;
    }
    if (sharers == 1 || split_reduce<TN>(acc, sums + unit * (TN * 128),
                                         sharers, finisher, tickets + unit,
                                         tid))
      epilogue<T, TN>(acc, sx, s, y, t * BM + 64 * wg, tt * TN, M, N,
                      warp % 4, lane);
  }
}

// ---------------------------------------------------------------------------
// Host
// ---------------------------------------------------------------------------

struct Problem {
  const int8_t* xq;
  const float* sx;
  const int8_t* v;
  const float* s;
  void* y;
  int32_t* sums;
  uint32_t* tickets;
  int M, N, K, kr, blocks, ksplit;
};

// Launched with programmatic serialization: it may start while the row
// pre-pass before it runs (see the producer).
template <typename T, int TN, bool STREAM>
int launch_gemm(const Problem& p, const CUtensorMap& tw, const CUtensorMap& tx,
                cudaStream_t st) {
  auto kernel = w8a8_gemm<T, TN, STREAM>;
  const uint32_t smem = gemm_smem_bytes(TN);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles = (p.N + BM - 1) / BM;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = STREAM ? dim3(p.blocks, 1, 1)
                       : dim3(tiles, p.ksplit, (p.M + TN - 1) / TN);
  cfg.blockDim = dim3(P_THREADS, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const float* sx = p.sx;
  const float* s = p.s;
  T* y = static_cast<T*>(p.y);
  int32_t* sums = p.sums;
  uint32_t* tickets = p.tickets;
  int M = p.M, N = p.N, K = p.K, kr = p.kr;
  void* args[] = {const_cast<CUtensorMap*>(&tw), const_cast<CUtensorMap*>(&tx),
                  &sx, &s, &y, &sums, &tickets, &M, &N, &K, &kr,
                  const_cast<int*>(&tiles)};
  err = cudaLaunchKernelExC(&cfg, reinterpret_cast<const void*>(kernel),
                            args);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

template <typename T>
int gemm_as(const Problem& p, int tn, cudaStream_t st) {
  hopper::EncodeTiled encode;
  cudaError_t err = hopper::encode_tiled_fn(&encode);
  if (err != cudaSuccess) return err;
  CUtensorMap tw, tx;
  CUresult r = hopper::encode_i8_2d(encode, &tw, p.v, p.K, p.N, p.K, BM);
  if (r != CUDA_SUCCESS) return -(static_cast<int>(r) * 4);
  r = hopper::encode_i8_2d(encode, &tx, p.xq, p.K, p.M, p.K, tn);
  if (r != CUDA_SUCCESS) return -(static_cast<int>(r) * 4 + 1);
  if (tn == 16) return launch_gemm<T, 16, true>(p, tw, tx, st);
  if (tn == 32) return launch_gemm<T, 32, true>(p, tw, tx, st);
  if (tn == 64) return launch_gemm<T, 64, true>(p, tw, tx, st);
  if (tn == 128) return launch_gemm<T, 128, false>(p, tw, tx, st);
  if (tn == 256) return launch_gemm<T, 256, false>(p, tw, tx, st);
  return cudaErrorInvalidValue;
}

template <typename T>
int rows_as(const void* x, int8_t* xq, float* sx, int M, int K,
            cudaStream_t st) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const T* xt = static_cast<const T*>(x);
  if (M < sms)
    w8a8_rows<T, R_WIDE><<<M, R_WIDE, 0, st>>>(xt, xq, sx, M, K);
  else
    w8a8_rows<T, R_NARROW><<<M, R_NARROW, 0, st>>>(xt, xq, sx, M, K);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float16, 2 = float32 (x's and y's).  Every
// tensor contiguous and 16-byte aligned; K a multiple of 16.  Each returns
// a cudaError_t (0 on success), or, when cuTensorMapEncodeTiled refuses
// the tensor map of v (m = 0) or xq (m = 1), -(CUresult * 4 + m); nothing
// is launched then.

// The row pre-pass: x [M, K] -> xq int8 [M, K] and sx fp32 [M].
int dstpu_w8a8_rows(const void* x, int dtype, int8_t* xq, float* sx,
                    long long M, long long K, void* stream) {
  if (M <= 0 || K <= 0) return cudaSuccess;
  if (K % 16 || M > 0x7fffffffLL || K > 0x7fffffffLL || !aligned16(x) ||
      !aligned16(xq))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return rows_as<__nv_bfloat16>(x, xq, sx, M, K, st);
  if (dtype == 1) return rows_as<__half>(x, xq, sx, M, K, st);
  if (dtype == 2) return rows_as<float>(x, xq, sx, M, K, st);
  return cudaErrorInvalidValue;
}

// y [M, N] = W8A8(x [M, K]) through v int8 [N, K] and s fp32 [N], from
// dstpu_w8a8_rows's xq int8 [M, K] and sx fp32 [M]; y in `dtype`.  tn is
// the token tile: 16, 32 or 64 (M <= tn) with `blocks` blocks over equal
// shares of the tiles' K panels; or 128 or 256, a block a (channel tile, K
// range, token tile), K cut into ksplit ranges of kr values (a multiple of
// 128; the last may be shorter).  sums holds 128 x tn zeroed int32 and
// tickets one zeroed uint32 for each (token tile, channel tile); the kernel
// leaves them zeroed.
int dstpu_w8a8_gemm(const int8_t* xq, const float* sx, int dtype,
                    const int8_t* v, const float* s, void* y, int32_t* sums,
                    uint32_t* tickets, long long M, long long N, long long K,
                    int tn, int ksplit, int kr, int blocks, void* stream) {
  if (M <= 0 || N <= 0) return cudaSuccess;
  const long long tiles = (N + BM - 1) / BM, P = (K + 127) / 128;
  if (K <= 0 || K % 16 || M > 0x7fffffffLL || N > 0x7fffffffLL ||
      K > 0x7fffffffLL || !aligned16(v) || !aligned16(xq) || !sums ||
      !tickets)
    return cudaErrorInvalidValue;
  // a block that finishes a shared tile waits for the others: every block
  // of a grid with shared tiles must be resident at once, one an SM
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const long long token_tiles = (M + tn - 1) / tn;
  if (tn >= 128 ? (kr <= 0 || kr % 128 || ksplit <= 0 || ksplit > 65535 ||
                   (long long)kr * ksplit < K ||
                   (long long)kr * (ksplit - 1) >= K ||
                   (ksplit > 1 && tiles * ksplit * token_tiles > sms))
                : (M > tn || blocks <= 0 || blocks > tiles * P ||
                   blocks > sms))
    return cudaErrorInvalidValue;
  const Problem p{xq,     sx,     v,      s,  y,      sums, tickets,
                  (int)M, (int)N, (int)K, kr, blocks, ksplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return gemm_as<__nv_bfloat16>(p, tn, st);
  if (dtype == 1) return gemm_as<__half>(p, tn, st);
  if (dtype == 2) return gemm_as<float>(p, tn, st);
  return cudaErrorInvalidValue;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
