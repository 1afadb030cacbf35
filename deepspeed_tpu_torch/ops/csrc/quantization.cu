// Group-wise int8 quantize and dequantize for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (deepspeed_tpu_torch/ops/quantization.py).
//
// Replaces: deepspeed_tpu/ops/quantization.py::_quant_kernel (:41) and
// ::_dequant_kernel (:59) (the Pallas TPU kernels behind quantize and
// dequantize).  The values are viewed as [groups, gs] over the row-major
// flattening, the tail zero-padded; per group:
//   symmetric:  s = max(max|x|, eps) / q_max,            o = 0
//   asymmetric: s = max(max x - min x, eps) / (2 q_max), o = (max + min) / 2
//   payload     v = clip(rint((x - o) / s), -q_max, q_max) as int8
//   dequant     x = v s + o in fp32, cast to the output type, first n only.
// The padding zeros take part in the tail group's min and max, and the
// payload holds their quantized values, as in the reference.
//
// Bit-exact with the plain PyTorch version (and the JAX package's jnp
// branch): the max and min are order-independent (max|x| is taken as
// max(max x, -min x) or as a max of |x|, the same number); every step
// rounds as the separate fp32 operations there do: IEEE division
// (__fdiv_rn, never a reciprocal), round half to even (rint, as
// torch.round and jnp.round; the ring path clamps the quotient first,
// which gives the same integer as q_max is an integer, and rounds it by
// adding 1.5 2^23, see quant1), v s + o as __fmul_rn then __fadd_rn (no
// FMA contraction), and round-to-nearest-even casts.  eps, q_max and
// 2 q_max come from the caller as fp32, rounded from the same Python
// floats.
//
// What bounds it on this card: bytes.  Quantize reads the input once and
// writes 1 byte an element plus 8 bytes a group; dequantize the reverse.
// At llama3-8b's gate_proj ([4096, 14336] bf16, groups of 128) either
// moves 179.8 MB: 53.7 us at 3.35 TB/s.  The quantize's arithmetic comes
// close behind: __fdiv_rn is a reciprocal (MUFU.RCP), a range check
// (FCHK), five FMAs and a guarded call to a slow path, and its two
// quarter-rate instructions share one pipe of 16 lanes a cycle per SM;
// at the byte bound bf16 needs ~4.7 values a cycle per SM.
//
// Quantize (quant_ring).  The first kernel (quant_kernel: one warp per
// group, each group read twice one step after the other) sat at 27% of
// its bound at groups of 128: half of each warp idled, a lane had one
// 16-byte load in flight and waited on it, and lane 0 wrote scattered
// scales.  Now:
// - Persistent blocks, RING_BLOCKS_PER_SM = 3 a SM, each with one
//   producer warp and QW = 8 consumer warps.  The producer copies
//   group-aligned tiles of up to 16 KB (whole groups) into a ring of
//   STAGES = 2 shared-memory stages with 1-D bulk copies (cp.async.bulk
//   on an mbarrier), so the next tile arrives while this one's divisions
//   run, whatever the consumers' registers hold.  Deeper rings measured
//   slower (3 stages 2-4%, 4 stages 5-8%).
// - A consumer lane takes 16 consecutive values (a "chunk", 16 payload
//   bytes) per row, 2 rows a tile in bf16 and fp16, 1 in fp32, reads them
//   from the stage once and keeps them in registers (HOLD); the stage goes
//   back to the producer once the max and min have read them.  Lanes are
//   sized to the group: a group of at most 32 chunks (512 values) takes
//   the next power of two of lanes, several groups a warp, reduced with
//   segmented shuffles (8 lanes a group at 128 values, 2 at 32); a larger
//   group takes whole rows of 32 lanes, and the rows' partial max and min
//   meet in shared memory.
// - Scales and offsets are written as one contiguous run a tile (staged
//   in shared memory for small groups); the payload leaves as 16-byte
//   stores, neighbouring lanes on neighbouring addresses.
// - The ring path takes a 16-byte aligned input and payload, n a multiple
//   of the 16-byte vector and gs a multiple of 16 with at most 32 chunks
//   a group or a multiple of 32 chunks up to one 16 KB stage: groups of
//   up to 8192 bf16 or fp16 values, or 4096 fp32 values.  Other shapes
//   take quant_kernel (the first design): one warp a group, 16-byte loads
//   where the vector width divides gs and n and the input is aligned
//   (larger groups read again from L2), else one element an access.
//   Those shapes are not on the serving path.
// - Measured (scripts/bench_quant.py, NVIDIA H100 80GB HBM3, 700 W,
//   graph-replayed device time): 0.069 ms at gate_proj bf16, groups of
//   128 (77% of its bound; the first design 0.194 ms) and 0.068 ms at
//   groups of 2048 (77%; 0.093 ms).  What holds it there is that pipe: a
//   float-to-int conversion per value on it cost 9%, so the payload is
//   rounded with an FADD instead; consumers that load for themselves (no
//   ring), more or fewer consumer warps a block and more blocks a SM
//   move it by a few percent at most.

// Dequantize (dequant_kernel, the first design, 64-66% of its bound): a
// grid-stride pass, 16 int8 values a thread (one 16-byte load), the scale
// and offset of their group (a group may span rows of the weight),
// 16-byte stores of the output type straight into the caller's tensor of
// n elements: no [groups * gs] intermediate and no slice copy.  Shapes
// off the vector width take the same kernel with one element an access.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "hopper.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

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

// VEC values from x[idx], or zeros past n (the tail group's padding).
// The vector path is taken only when n is a multiple of VEC, so a vector
// lies wholly inside or wholly past the input.
template <typename T, int VEC>
__device__ __forceinline__ void load_group(const T* __restrict__ x,
                                           int64_t idx, int64_t n,
                                           float (&f)[VEC]) {
  if (idx < n) {
    const Vec<T, VEC> r = *reinterpret_cast<const Vec<T, VEC>*>(x + idx);
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = to_float(r.v[k]);
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) f[k] = 0.f;
  }
}

// The first design, for shapes the ring path does not take: one warp a
// group, grid-stride over groups, max and min over the group, then the
// group read again (from L1/L2) to write the payload.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
quant_kernel(const T* __restrict__ x, int8_t* __restrict__ v,
             float* __restrict__ s, float* __restrict__ o, int64_t n,
             int64_t groups, int gs, float q_max, float two_q_max, float eps,
             int symmetric) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (int64_t)gridDim.x * WARPS;
  for (int64_t g = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5);
       g < groups; g += nwarps) {
    const int64_t base = g * gs;
    float mx = -INFINITY, mn = INFINITY;
    for (int i = lane * VEC; i < gs; i += 32 * VEC) {
      float f[VEC];
      load_group<T, VEC>(x, base + i, n, f);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        mx = fmaxf(mx, f[k]);
        mn = fminf(mn, f[k]);
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      mn = fminf(mn, __shfl_xor_sync(0xffffffffu, mn, off));
    }
    float scale, offset;
    if (symmetric) {
      // max |x| = max(max x, -min x), exactly
      scale = __fdiv_rn(fmaxf(fmaxf(mx, -mn), eps), q_max);
      offset = 0.f;
    } else {
      scale = __fdiv_rn(fmaxf(__fsub_rn(mx, mn), eps), two_q_max);
      offset = __fmul_rn(__fadd_rn(mx, mn), 0.5f);
    }
    for (int i = lane * VEC; i < gs; i += 32 * VEC) {
      float f[VEC];
      load_group<T, VEC>(x, base + i, n, f);
      Vec<int8_t, VEC> q;
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float r = rintf(__fdiv_rn(__fsub_rn(f[k], offset), scale));
        q.v[k] = static_cast<int8_t>(
            static_cast<int>(fminf(fmaxf(r, -q_max), q_max)));
      }
      *reinterpret_cast<Vec<int8_t, VEC>*>(v + base + i) = q;
    }
    if (lane == 0) {
      s[g] = scale;
      o[g] = offset;
    }
  }
}

// ---------------------------------------------------------------------------
// quant_ring: the vector path of quantize
// ---------------------------------------------------------------------------

constexpr int QW = 8;                   // consumer warps of a block
constexpr int QTHREADS = (QW + 1) * 32;  // and one producer warp
constexpr int STAGES = 2;               // ring depth
constexpr bool RING = true;    // false: consumers load from global memory
constexpr bool HOLD = true;    // false: read the tile again to quantize it
constexpr int RING_BLOCKS_PER_SM = 3;
constexpr int STAGE_BYTES = QW * 2048;  // QW warps x rows x 32 chunks
constexpr int CONSUMERS = QW * 32;

// Rows (32 chunks of 16 values) a consumer warp takes from each tile:
// 2 in 2-byte types, 1 in fp32, so that a tile is STAGE_BYTES.
template <typename T>
__host__ __device__ constexpr int rows_per_warp() {
  return 4 / static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int tile_rows() {
  return QW * rows_per_warp<T>();
}
// most groups in a tile: one chunk a group
template <typename T>
__host__ __device__ constexpr int max_tile_groups() {
  return tile_rows<T>() * 32;
}

// 16 consecutive values: 2 x 16 bytes in bf16 and fp16, 4 in fp32.
template <typename T>
struct Chunk {
  uint4 w[sizeof(T)];
};

__device__ __forceinline__ uint32_t word_of(const uint4& u, int i) {
  return i == 0 ? u.x : i == 1 ? u.y : i == 2 ? u.z : u.w;
}

// value k (a compile-time index after unrolling) of a chunk, in fp32
template <typename T>
__device__ __forceinline__ float value(const Chunk<T>& c, int k);
template <>
__device__ __forceinline__ float value<__nv_bfloat16>(
    const Chunk<__nv_bfloat16>& c, int k) {
  const uint32_t w = word_of(c.w[k / 8], (k / 2) % 4);
  return __uint_as_float(k % 2 ? (w & 0xffff0000u) : (w << 16));
}
template <>
__device__ __forceinline__ float value<__half>(const Chunk<__half>& c,
                                               int k) {
  const uint32_t w = word_of(c.w[k / 8], (k / 2) % 4);
  return __half2float(__ushort_as_half(
      static_cast<unsigned short>(k % 2 ? w >> 16 : w & 0xffffu)));
}
template <>
__device__ __forceinline__ float value<float>(const Chunk<float>& c, int k) {
  return __uint_as_float(word_of(c.w[k / 4], k % 4));
}

// The chunk at element `off` of a tile whose first element is e0, from
// `src` (the tile's first 16 bytes); 16-byte words at or past n read as
// zeros (the tail group's padding).  n is a multiple of the word.
template <typename T>
__device__ __forceinline__ void load_chunk(Chunk<T>& c,
                                           const uint4* __restrict__ src,
                                           int off, int64_t e0, int64_t n) {
  constexpr int VEC = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < (int)sizeof(T); ++j)
    c.w[j] = e0 + off + j * VEC < n ? src[off / VEC + j]
                                    : make_uint4(0u, 0u, 0u, 0u);
}

template <bool SYM>
__device__ __forceinline__ void scale_of(float mx, float mn, float q_max,
                                         float two_q_max, float eps,
                                         float& scale, float& offset) {
  if (SYM) {  // mx holds max|x|
    scale = __fdiv_rn(fmaxf(mx, eps), q_max);
    offset = 0.f;
  } else {
    scale = __fdiv_rn(fmaxf(__fsub_rn(mx, mn), eps), two_q_max);
    offset = __fmul_rn(__fadd_rn(mx, mn), 0.5f);
  }
}

// clip(rint((f - offset) / scale)) in the low byte of the result (x - 0
// is x, so the symmetric case skips the subtraction).  The clipped y lies
// in [-127, 127]; y + 1.5 2^23 rounds it to an integer, half to even (the
// integer rintf gives), and holds that integer in two's complement in the
// low mantissa bits: no float-to-int conversion, which would share the
// quarter-rate pipe with the division's reciprocal and check.  Clipping
// before rounding gives the same integer, as q_max is an integer.
template <bool SYM>
__device__ __forceinline__ uint32_t quant1(float f, float scale,
                                           float offset, float q_max) {
  const float y = __fdiv_rn(SYM ? f : __fsub_rn(f, offset), scale);
  return __float_as_uint(
      __fadd_rn(fminf(fmaxf(y, -q_max), q_max), 12582912.f));
}

__device__ __forceinline__ uint32_t pack4(uint32_t a, uint32_t b, uint32_t c,
                                          uint32_t d) {
  return __byte_perm(__byte_perm(a, b, 0x0040), __byte_perm(c, d, 0x0040),
                     0x5410);
}

template <typename T>
constexpr size_t ring_smem_bytes() {
  return (RING ? (size_t)STAGES * STAGE_BYTES : 0) +
         2 * 2 * max_tile_groups<T>() * sizeof(float) +  // scales, offsets
         2 * 2 * tile_rows<T>() * sizeof(float) +         // row partials
         2 * STAGES * sizeof(uint64_t);                    // full, empty
}

// One tile is tile_groups whole groups (the last tile fewer); tiles go to
// the blocks round robin.  lpg_log2: log2 of the lanes a group takes when
// it has at most 32 chunks (cpg = gs / 16); rpg: rows a group takes when
// it has more (cpg / 32), else 0.
template <typename T, bool SYM>
__global__ void __launch_bounds__(QTHREADS, RING_BLOCKS_PER_SM)
quant_ring(const T* __restrict__ x, int8_t* __restrict__ v,
           float* __restrict__ s, float* __restrict__ o, int64_t n,
           int64_t groups, int gs, int lpg_log2, int rpg, int tile_groups,
           int64_t tiles, float q_max, float two_q_max, float eps) {
  constexpr int RPW = rows_per_warp<T>();
  constexpr int MAXG = max_tile_groups<T>();
  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem;
  float* s_st = reinterpret_cast<float*>(
      smem + (RING ? (size_t)STAGES * STAGE_BYTES : 0));  // [2][MAXG]
  float* o_st = s_st + 2 * MAXG;                           // [2][MAXG]
  float* part = o_st + 2 * MAXG;                     // [2][tile rows][2]
  uint64_t* bars =
      reinterpret_cast<uint64_t*>(part + 2 * 2 * tile_rows<T>());
  const uint32_t full0 = hopper::smem_u32(bars);
  const uint32_t empty0 = hopper::smem_u32(bars + STAGES);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init(full0 + 8 * i, 1);
      hopper::mbar_init(empty0 + 8 * i, QW);
    }
    hopper::fence_mbar_init();
  }
  __syncthreads();

  if (warp == QW) {  // the producer
    if (RING && lane == 0) {
      int i = 0;
      for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
        const int slot = i % STAGES;
        hopper::mbar_wait(empty0 + 8 * slot, ((i / STAGES) & 1) ^ 1);
        const int64_t e0 = t * tile_groups * gs;
        const int64_t e1 = e0 + (int64_t)tile_groups * gs < n
                               ? e0 + (int64_t)tile_groups * gs
                               : n;
        const uint32_t bytes = (uint32_t)((e1 - e0) * sizeof(T));
        hopper::mbar_expect_tx(full0 + 8 * slot, bytes);
        hopper::bulk_load_1d(hopper::smem_u32(ring + slot * STAGE_BYTES),
                             x + e0, bytes, full0 + 8 * slot);
      }
    }
    return;
  }

  const int lpg = 1 << lpg_log2;  // lanes a small group takes
  const int cpg = gs / 16;
  int i = 0;
  for (int64_t t = blockIdx.x; t < tiles; t += gridDim.x, ++i) {
    const int slot = i % STAGES, buf = i & 1;
    const int64_t g0 = t * tile_groups;
    const int tg = groups - g0 < tile_groups ? (int)(groups - g0)
                                             : tile_groups;
    const int64_t e0 = g0 * gs;
    if (RING) hopper::mbar_wait(full0 + 8 * slot, (i / STAGES) & 1);
    const uint4* src =
        RING ? reinterpret_cast<const uint4*>(ring + slot * STAGE_BYTES)
             : reinterpret_cast<const uint4*>(x + e0);

    // this lane's chunks: group (in the tile), element offset, validity
    Chunk<T> c[RPW];
    int gl[RPW], off[RPW];
    bool ok[RPW];
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      const int row = warp * RPW + k;
      if (rpg) {
        gl[k] = row / rpg;
        off[k] = row * 512 + lane * 16;
        ok[k] = gl[k] < tg;
      } else {
        const int ci = lane & (lpg - 1);
        gl[k] = (row << (5 - lpg_log2)) + (lane >> lpg_log2);
        off[k] = gl[k] * gs + ci * 16;
        ok[k] = ci < cpg && gl[k] < tg;
      }
      if (ok[k]) load_chunk<T>(c[k], src, off[k], e0, n);
    }

    float mx[RPW], mn[RPW], scale[RPW], offset[RPW];
#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      mx[k] = SYM ? 0.f : -INFINITY;
      mn[k] = INFINITY;
      scale[k] = 1.f;
      offset[k] = 0.f;
      if (ok[k]) {
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const float f = value<T>(c[k], e);
          if (SYM) {
            mx[k] = fmaxf(mx[k], fabsf(f));
          } else {
            mx[k] = fmaxf(mx[k], f);
            mn[k] = fminf(mn[k], f);
          }
        }
      }
      // over the lanes of the group (segments of lpg lanes), or the row
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        if (rpg || d < lpg) {
          mx[k] = fmaxf(mx[k], __shfl_xor_sync(0xffffffffu, mx[k], d));
          if (!SYM)
            mn[k] = fminf(mn[k], __shfl_xor_sync(0xffffffffu, mn[k], d));
        }
      }
      if (rpg) {
        if (lane == 0) {
          float* p = part + (buf * tile_rows<T>() + warp * RPW + k) * 2;
          p[0] = mx[k];
          p[1] = mn[k];
        }
      } else {
        scale_of<SYM>(mx[k], mn[k], q_max, two_q_max, eps, scale[k],
                      offset[k]);
        if (ok[k] && (lane & (lpg - 1)) == 0) {
          s_st[buf * MAXG + gl[k]] = scale[k];
          o_st[buf * MAXG + gl[k]] = offset[k];
        }
      }
    }
    // The stage is in registers, and the max and min above have read
    // every one of them: hand it back.  Not earlier: a shared-memory load
    // still in flight when the producer's next bulk copy lands reads the
    // new tile (a ring of two stages showed it).
    if (RING && HOLD) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * slot);
    }
    hopper::named_barrier_sync(1, CONSUMERS);
    if (rpg) {  // a group's rows meet here
      for (int g = threadIdx.x; g < tg; g += CONSUMERS) {
        float a = SYM ? 0.f : -INFINITY, b = INFINITY;
        for (int r = g * rpg; r < (g + 1) * rpg; ++r) {
          const float* p = part + (buf * tile_rows<T>() + r) * 2;
          a = fmaxf(a, p[0]);
          b = fminf(b, p[1]);
        }
        float sc, of;
        scale_of<SYM>(a, b, q_max, two_q_max, eps, sc, of);
        s_st[buf * MAXG + g] = sc;
        o_st[buf * MAXG + g] = of;
      }
      hopper::named_barrier_sync(1, CONSUMERS);
#pragma unroll
      for (int k = 0; k < RPW; ++k) {
        if (ok[k]) {
          scale[k] = s_st[buf * MAXG + gl[k]];
          offset[k] = o_st[buf * MAXG + gl[k]];
        }
      }
    }
    // the tile's scales and offsets as one contiguous run each
    for (int g = threadIdx.x; g < tg; g += CONSUMERS) {
      s[g0 + g] = s_st[buf * MAXG + g];
      o[g0 + g] = o_st[buf * MAXG + g];
    }

#pragma unroll
    for (int k = 0; k < RPW; ++k) {
      if (!ok[k]) continue;
      if (!HOLD) load_chunk<T>(c[k], src, off[k], e0, n);
      uint32_t qw[4];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        qw[w] = pack4(
            quant1<SYM>(value<T>(c[k], 4 * w), scale[k], offset[k], q_max),
            quant1<SYM>(value<T>(c[k], 4 * w + 1), scale[k], offset[k],
                        q_max),
            quant1<SYM>(value<T>(c[k], 4 * w + 2), scale[k], offset[k],
                        q_max),
            quant1<SYM>(value<T>(c[k], 4 * w + 3), scale[k], offset[k],
                        q_max));
      *reinterpret_cast<uint4*>(v + e0 + off[k]) =
          make_uint4(qw[0], qw[1], qw[2], qw[3]);
    }
    if (RING && !HOLD) {
      __syncwarp();
      if (lane == 0) hopper::mbar_arrive(empty0 + 8 * slot);
    }
  }
}

// VEC = 16: 16 payload bytes in one load, written as 16-byte stores of
// the output type; VEC = 1: one element per thread.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
dequant_kernel(const int8_t* __restrict__ v, const float* __restrict__ s,
               const float* __restrict__ o, T* __restrict__ x, int64_t n,
               int gs) {
  constexpr int CH = VEC == 1 ? 1 : 16 / sizeof(T);  // outputs per store
  const int64_t chunks = n / VEC;
  for (int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * THREADS) {
    const int64_t idx = c * VEC;
    const int64_t g = idx / gs;  // gs % VEC == 0: one group per chunk
    const float sc = s[g], off = o[g];
    const Vec<int8_t, VEC> q = *reinterpret_cast<const Vec<int8_t, VEC>*>(
        v + idx);
#pragma unroll
    for (int j = 0; j < VEC; j += CH) {
      Vec<T, CH> out;
#pragma unroll
      for (int k = 0; k < CH; ++k)
        out.v[k] = from_float<T>(
            __fadd_rn(__fmul_rn(static_cast<float>(q.v[j + k]), sc), off));
      *reinterpret_cast<Vec<T, CH>*>(x + idx + j) = out;
    }
  }
}

int blocks_for(int64_t work, int per_block) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (work + per_block - 1) / per_block;
  const int64_t cap = (int64_t)sms * 8;  // 8 resident blocks of 256 per SM
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, bool SYM>
int quantize_ring(const T* x, int8_t* v, float* s, float* o, int64_t n,
                  int64_t groups, int gs, int lpg_log2, int rpg,
                  float q_max, float two_q_max, float eps, cudaStream_t st) {
  const int tile_groups =
      rpg ? tile_rows<T>() / rpg : tile_rows<T>() * (32 >> lpg_log2);
  const int64_t tiles = (groups + tile_groups - 1) / tile_groups;
  constexpr size_t smem = ring_smem_bytes<T>();
  int err = cudaFuncSetAttribute(quant_ring<T, SYM>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
  if (err) return err;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t cap = (int64_t)sms * RING_BLOCKS_PER_SM;
  const int blocks = (int)(tiles < cap ? tiles : cap);
  quant_ring<T, SYM><<<blocks, QTHREADS, smem, st>>>(
      x, v, s, o, n, groups, gs, lpg_log2, rpg, tile_groups, tiles, q_max,
      two_q_max, eps);
  return cudaGetLastError();
}

template <typename T>
int quantize_as(const void* x, int8_t* v, float* s, float* o, int64_t n,
                int64_t groups, int gs, float q_max, float two_q_max,
                float eps, int symmetric, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  // the ring path: whole 16-value chunks, at most 32 a group or whole rows
  // of 32 up to one stage
  const int cpg = gs / 16;
  const bool small = gs % 16 == 0 && cpg <= 32;
  const bool rows = gs % 512 == 0 && cpg / 32 <= tile_rows<T>();
  if ((small || rows) && n % VEC == 0 && aligned(x, 16) && aligned(v, 16)) {
    int lpg_log2 = 0;
    while ((1 << lpg_log2) < cpg && lpg_log2 < 5) ++lpg_log2;
    const int rpg = small ? 0 : cpg / 32;
    return symmetric
               ? quantize_ring<T, true>(xt, v, s, o, n, groups, gs, lpg_log2,
                                        rpg, q_max, two_q_max, eps, st)
               : quantize_ring<T, false>(xt, v, s, o, n, groups, gs,
                                         lpg_log2, rpg, q_max, two_q_max,
                                         eps, st);
  }
  const int blocks = blocks_for(groups, WARPS);
  if (gs % VEC == 0 && n % VEC == 0 && aligned(x, 16) && aligned(v, VEC))
    quant_kernel<T, VEC><<<blocks, THREADS, 0, st>>>(
        xt, v, s, o, n, groups, gs, q_max, two_q_max, eps, symmetric);
  else
    quant_kernel<T, 1><<<blocks, THREADS, 0, st>>>(
        xt, v, s, o, n, groups, gs, q_max, two_q_max, eps, symmetric);
  return cudaGetLastError();
}

template <typename T>
int dequantize_as(const int8_t* v, const float* s, const float* o, void* x,
                  int64_t n, int gs, cudaStream_t st) {
  T* xt = static_cast<T*>(x);
  if (gs % 16 == 0 && n % 16 == 0 && aligned(v, 16) && aligned(x, 16))
    dequant_kernel<T, 16><<<blocks_for(n / 16, THREADS), THREADS, 0, st>>>(
        v, s, o, xt, n, gs);
  else
    dequant_kernel<T, 1><<<blocks_for(n, THREADS), THREADS, 0, st>>>(
        v, s, o, xt, n, gs);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float16, 2 = float32.  x: n contiguous
// elements; v: groups * gs int8; s, o: groups fp32 each, with
// groups = ceil(n / gs).  q_max = 2^(bits-1) - 1, two_q_max = 2 q_max,
// eps the scale floor (1e-12), all rounded to fp32 by the caller.
// Returns a cudaError_t (0 on success).
int dstpu_quantize(const void* x, int dtype, int8_t* v, float* s, float* o,
                   long long n, long long groups, int gs, float q_max,
                   float two_q_max, float eps, int symmetric, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (gs <= 0 || groups != (n + gs - 1) / gs) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return quantize_as<__nv_bfloat16>(x, v, s, o, n, groups, gs, q_max,
                                      two_q_max, eps, symmetric, st);
  if (dtype == 1)
    return quantize_as<__half>(x, v, s, o, n, groups, gs, q_max, two_q_max,
                               eps, symmetric, st);
  if (dtype == 2)
    return quantize_as<float>(x, v, s, o, n, groups, gs, q_max, two_q_max,
                              eps, symmetric, st);
  return cudaErrorInvalidValue;
}

// The first n elements of v s + o (v: ceil(n / gs) * gs int8, s and o one
// fp32 per group) into x, n contiguous elements of dtype (as above).
int dstpu_dequantize(const int8_t* v, const float* s, const float* o, void* x,
                     int dtype, long long n, int gs, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (gs <= 0) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dequantize_as<__nv_bfloat16>(v, s, o, x, n, gs, st);
  if (dtype == 1) return dequantize_as<__half>(v, s, o, x, n, gs, st);
  if (dtype == 2) return dequantize_as<float>(v, s, o, x, n, gs, st);
  return cudaErrorInvalidValue;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
