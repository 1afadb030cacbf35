// Group-wise int8 quantize and dequantize for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (deepspeed_tpu_torch/ops/quantization.py).
//
// Replaces: deepspeed_tpu/ops/quantization.py::_quant_kernel and
// ::_dequant_kernel (the Pallas TPU kernels behind quantize and
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
// branch): the max and min are order-independent; every step rounds as
// the separate fp32 operations there do: IEEE division (__fdiv_rn, never
// a reciprocal), rint (half to even, as torch.round and jnp.round),
// v s + o as __fmul_rn then __fadd_rn (no FMA contraction), and
// round-to-nearest-even casts.  eps, q_max and 2 q_max come from the
// caller as fp32, rounded from the same Python floats.
//
// What bounds it on this card: bytes.  Quantize reads the input once and
// writes 1 byte an element plus 8 bytes a group; dequantize the reverse.
// At llama3-8b's gate_proj ([4096, 14336] bf16, groups of 128) either
// moves 179.8 MB: 53.7 us at 3.35 TB/s, against a few operations an
// element.
//
// What this design does about it (a simple pass that is right first):
// - Quantize: one warp per group, grid-stride over groups.  Each lane
//   loads 16 bytes at a time (8 bf16 or 4 fp32 values), the warp reduces
//   max and min with shuffles, then re-reads its group (from L1/L2: the
//   same warp read it just before) to write the payload with 4- or
//   8-byte stores.
// - Dequantize: a grid-stride pass, 16 int8 values a thread (one 16-byte
//   load), the scale and offset of their group (a group may span rows of
//   the weight), 16-byte stores of the output type straight into the
//   caller's tensor of n elements: no [groups * gs] intermediate and no
//   slice copy.
// - Shapes the vector path cannot take (group size or n not a multiple
//   of the vector width, pointers not 16-byte aligned) take the same
//   kernels with one element per access.
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

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

template <typename T>
int quantize_as(const void* x, int8_t* v, float* s, float* o, int64_t n,
                int64_t groups, int gs, float q_max, float two_q_max,
                float eps, int symmetric, cudaStream_t st) {
  constexpr int VEC = 16 / sizeof(T);
  const int blocks = blocks_for(groups, WARPS);
  const T* xt = static_cast<const T*>(x);
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
