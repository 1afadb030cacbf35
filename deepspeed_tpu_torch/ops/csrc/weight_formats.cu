// The serving weight formats' per-use dequant kernels for Hopper
// (sm_90a): fp8 and per-channel int8, and fp6.  A plain C interface,
// loaded with ctypes (deepspeed_tpu_torch/ops/quantization.py).
//
// Replaces no Pallas kernel.  The JAX package writes these formats as jnp
// code that XLA fuses into the consuming dot
// (deepspeed_tpu/ops/quantization.py:156-281, dequantize_fp8 and
// dequantize_fp6; deepspeed_tpu/inference/quantization.py:159-178,
// dequantize_param_tree's w8a8 branch).  PyTorch has no such fusion, and
// each expansion runs once a weight every forward or model tick, so each
// is a kernel here:
//   K1 dequant_scaled   x = cast(v * s): v int8 or float8_e4m3fn, s one
//                       fp32 for the tensor or one per row of [rows, cols]
//   K2 dequant_fp6      three bytes -> four 6-bit codes (1 sign, 3
//                       exponent bits with bias 3, 2 mantissa bits,
//                       subnormal at exponent 0) -> +-|code| * s[group],
//                       cast, the first n values
// W8A8's activation path (the row quantization K3, the int8 product and
// the rescale K4 of the first design) is one GEMM kernel now,
// csrc/w8a8_gemm.cu.
//
// Bit-exact with the plain PyTorch versions (and the JAX functions): every
// step is one IEEE operation in the order the jnp code writes it,
// __fmul_rn (never an FMA) and round-to-nearest-even casts.  e4m3 -> fp32
// and the fp6 magnitudes are exact.
//
// What bounds them on this card: bytes, 3.35 TB/s.  K1 reads 1 byte and
// writes 2 (bf16) an element: llama3-8b's gate_proj [4096, 14336] moves
// 176 MB, 0.053 ms.  K2 reads 0.75 byte + a scale a group and writes 2:
// 0.048 ms there.  The designs here are simple grid-stride passes with
// 16-byte accesses where the shape allows.
//
// Measured (chip_smoke.py phase 22, NVIDIA H100 80GB HBM3, 700 W,
// graph-replayed device time): at gate_proj K1 0.079-0.080 ms (66% of its
// bound), K2 0.073 ms at groups of 128 and 0.070 at 2048 (66-69%).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int THREADS = 256;

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

// one payload byte as fp32, exactly
template <int VTYPE>
__device__ __forceinline__ float payload(uint8_t b);
template <>
__device__ __forceinline__ float payload<0>(uint8_t b) {  // int8
  return static_cast<float>(static_cast<int8_t>(b));
}
template <>
__device__ __forceinline__ float payload<1>(uint8_t b) {  // float8_e4m3fn
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(b), __NV_E4M3)));
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

// ---------------------------------------------------------------------------
// K1: dequant_scaled
// ---------------------------------------------------------------------------

// VEC = 16: 16 payload bytes a thread in one load, 16-byte stores of T; a
// chunk lies in one row (cols % 16 == 0 when the scale is per row).
// VEC = 1: one element a thread.
template <typename T, int VTYPE, int VEC>
__global__ void __launch_bounds__(THREADS)
dequant_scaled_kernel(const uint8_t* __restrict__ v,
                      const float* __restrict__ s, int per_row, int64_t cols,
                      T* __restrict__ x, int64_t n) {
  constexpr int CH = VEC == 1 ? 1 : 16 / sizeof(T);  // outputs per store
  const int64_t chunks = n / VEC;
  const float s0 = per_row ? 0.f : s[0];
  for (int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * THREADS) {
    const int64_t idx = c * VEC;
    const float sc = per_row ? s[idx / cols] : s0;
    const Vec<uint8_t, VEC> q =
        *reinterpret_cast<const Vec<uint8_t, VEC>*>(v + idx);
#pragma unroll
    for (int j = 0; j < VEC; j += CH) {
      Vec<T, CH> out;
#pragma unroll
      for (int k = 0; k < CH; ++k)
        out.v[k] = from_float<T>(__fmul_rn(payload<VTYPE>(q.v[j + k]), sc));
      *reinterpret_cast<Vec<T, CH>*>(x + idx + j) = out;
    }
  }
}

template <typename T, int VTYPE>
int dequant_scaled_as(const uint8_t* v, const float* s, int per_row,
                      int64_t cols, void* x, int64_t n, cudaStream_t st) {
  T* xt = static_cast<T*>(x);
  if (n % 16 == 0 && (!per_row || cols % 16 == 0) && aligned(v, 16) &&
      aligned(x, 16))
    dequant_scaled_kernel<T, VTYPE, 16>
        <<<blocks_for(n / 16, THREADS), THREADS, 0, st>>>(v, s, per_row,
                                                          cols, xt, n);
  else
    dequant_scaled_kernel<T, VTYPE, 1>
        <<<blocks_for(n, THREADS), THREADS, 0, st>>>(v, s, per_row, cols, xt,
                                                     n);
  return cudaGetLastError();
}

template <typename T>
int dequant_scaled_vtype(const uint8_t* v, int vtype, const float* s,
                         int per_row, int64_t cols, void* x, int64_t n,
                         cudaStream_t st) {
  if (vtype == 0)
    return dequant_scaled_as<T, 0>(v, s, per_row, cols, x, n, st);
  if (vtype == 1)
    return dequant_scaled_as<T, 1>(v, s, per_row, cols, x, n, st);
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// K2: dequant_fp6
// ---------------------------------------------------------------------------

// A 6-bit code's value times the group's scale: the magnitude
// (1 + m/4) 2^(e-3), or m/16 at e = 0, is exact in fp32 and carries the
// sign; one rounding, the product, as jnp's sign * mag * scale (the sign
// product is exact, so a -0 stays -0).
__device__ __forceinline__ float fp6_value(uint32_t code, float sc) {
  const uint32_t e = (code >> 2) & 7u, m = code & 3u;
  float mag = e == 0 ? static_cast<float>(m) * 0.0625f
                     : __uint_as_float(((e + 124u) << 23) | (m << 21));
  if (code & 32u) mag = -mag;
  return __fmul_rn(mag, sc);
}

// VEC = 16: 16 codes (12 bytes, three aligned 32-bit loads) a thread, the
// outputs written as 16-byte stores where the chunk lies wholly inside n
// and x is aligned.  VEC = 4: one 3-byte word a thread, byte loads.
// Groups hold a multiple of 4 codes, so a word never spans two groups.
template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
dequant_fp6_kernel(const uint8_t* __restrict__ p, const float* __restrict__ s,
                   T* __restrict__ x, int64_t n, int64_t total, int gs,
                   int vec_store) {
  constexpr int CH = 16 / sizeof(T);
  const int64_t chunks = total / VEC;
  for (int64_t c = (int64_t)blockIdx.x * THREADS + threadIdx.x; c < chunks;
       c += (int64_t)gridDim.x * THREADS) {
    const int64_t idx = c * VEC;
    if (idx >= n) continue;  // padding codes past the tensor
    uint32_t words[VEC / 4];
    if constexpr (VEC == 16) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(p + c * 12);
      const uint32_t w0 = w[0], w1 = w[1], w2 = w[2];
      words[0] = w0 & 0xFFFFFFu;
      words[1] = (w0 >> 24) | ((w1 & 0xFFFFu) << 8);
      words[2] = (w1 >> 16) | ((w2 & 0xFFu) << 16);
      words[3] = w2 >> 8;
    } else {
      const uint8_t* b = p + c * 3;
      words[0] = b[0] | (uint32_t(b[1]) << 8) | (uint32_t(b[2]) << 16);
    }
    float f[VEC];
#pragma unroll
    for (int q = 0; q < VEC / 4; ++q) {
      const float sc = s[(idx + 4 * q) / gs];
#pragma unroll
      for (int k = 0; k < 4; ++k)
        f[4 * q + k] = fp6_value((words[q] >> (6 * k)) & 63u, sc);
    }
    if (VEC % CH == 0 && vec_store && idx + VEC <= n) {
#pragma unroll
      for (int j = 0; j < VEC; j += CH) {
        Vec<T, CH> out;
#pragma unroll
        for (int k = 0; k < CH; ++k) out.v[k] = from_float<T>(f[j + k]);
        *reinterpret_cast<Vec<T, CH>*>(x + idx + j) = out;
      }
    } else {
#pragma unroll
      for (int k = 0; k < VEC; ++k)
        if (idx + k < n) x[idx + k] = from_float<T>(f[k]);
    }
  }
}

template <typename T>
int dequant_fp6_as(const uint8_t* p, const float* s, void* x, int64_t n,
                   int64_t total, int gs, cudaStream_t st) {
  T* xt = static_cast<T*>(x);
  const int vec_store = aligned(x, 16) && n % (16 / sizeof(T)) == 0;
  if (total % 16 == 0 && aligned(p, 4))
    dequant_fp6_kernel<T, 16><<<blocks_for(total / 16, THREADS), THREADS, 0,
                                st>>>(p, s, xt, n, total, gs, vec_store);
  else
    dequant_fp6_kernel<T, 4><<<blocks_for(total / 4, THREADS), THREADS, 0,
                               st>>>(p, s, xt, n, total, gs, 0);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = bfloat16, 1 = float16, 2 = float32 (the output's).  Every
// tensor contiguous.  Each returns a cudaError_t (0 on
// success).

// K1: x[i] = v[i] * s, n elements.  vtype 0 = int8, 1 = float8_e4m3fn;
// per_row 0: s is one fp32; 1: s[i / cols], one fp32 a row of [n/cols,
// cols].
int dstpu_dequant_scaled(const uint8_t* v, int vtype, const float* s,
                         int per_row, long long cols, void* x, int dtype,
                         long long n, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (per_row && (cols <= 0 || n % cols)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dequant_scaled_vtype<__nv_bfloat16>(v, vtype, s, per_row, cols,
                                               x, n, st);
  if (dtype == 1)
    return dequant_scaled_vtype<__half>(v, vtype, s, per_row, cols, x, n,
                                        st);
  if (dtype == 2)
    return dequant_scaled_vtype<float>(v, vtype, s, per_row, cols, x, n, st);
  return cudaErrorInvalidValue;
}

// K2: the first n of `total` codes (groups of gs, a multiple of 4; total =
// groups * gs), packed 4 to 3 bytes in p, times s[group] into x.
int dstpu_dequant_fp6(const uint8_t* p, const float* s, void* x, int dtype,
                      long long n, long long total, int gs, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (gs <= 0 || gs % 4 || total % gs || n > total)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dequant_fp6_as<__nv_bfloat16>(p, s, x, n, total, gs, st);
  if (dtype == 1) return dequant_fp6_as<__half>(p, s, x, n, total, gs, st);
  if (dtype == 2) return dequant_fp6_as<float>(p, s, x, n, total, gs, st);
  return cudaErrorInvalidValue;
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
