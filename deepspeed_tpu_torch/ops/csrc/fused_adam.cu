// Fused Adam/AdamW and Lion optimizer steps for Hopper (sm_90a), bound
// through a plain C interface and loaded with ctypes
// (deepspeed_tpu_torch/ops/fused_adam.py).
//
// Replaces: deepspeed_tpu/ops/fused_adam.py::_adam_kernel and ::_lion_kernel
// (the Pallas TPU kernels run per leaf by _run_elementwise), plus the
// engine's p - lr * u that follows them (runtime/engine.py:928-931).  Per
// element, with g scaled first by the step's gradient scale (1/(loss scale
// * gas) times the clipping factor):
//   Adam:  g += wd p (L2 mode); m' = b1 m + (1-b1) g; v' = b2 v + (1-b2) g g;
//          u = (m'/bc1) / (sqrt(v'/bc2) + eps); u += wd p (AdamW mode)
//   Lion:  u = sign(b1 m + (1-b1) g) + wd p; m' = b2 m + (1-b2) g
//   then   p' = p - lr u, and the compute-dtype working copy w = p'.
//
// What bounds it on this card: bytes.  Adam reads g, p, m, v (16 bytes an
// element) and writes p, m, v and the bf16 copy (14 bytes): at llama-1b's
// 1.1 B parameters ~33 GB, ~10 ms at 3.35 TB/s, against a few operations
// an element.
//
// What this design does about it:
// - One launch per step over flat fp32 buffers (the engine keeps master
//   weights, gradients and moments as flat buffers with per-leaf views),
//   not one launch per leaf as the TPU version: a grid-stride loop of
//   coalesced accesses, each element read once and written once.
// - p - lr u and the bf16 copy are written in the same pass, saving a
//   full read and write of p and the separate cast of the working copy.
// - lr, the bias corrections, the gradient scale and the fp16 overflow
//   flag are read from a small device array, so no step needs a host
//   sync; on overflow the kernel writes nothing (p, m and v untouched).
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int THREADS = 256;

// the step's scalars, in device memory: [lr, bc1, bc2, gscale, skip]
struct Scalars {
  float lr, bc1, bc2, gscale, skip;
};

template <typename W>
__device__ __forceinline__ void store_w(W* w, int64_t i, float x);
template <>
__device__ __forceinline__ void store_w<__nv_bfloat16>(__nv_bfloat16* w,
                                                       int64_t i, float x) {
  w[i] = __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ void store_w<__half>(__half* w, int64_t i,
                                                float x) {
  w[i] = __float2half_rn(x);
}
template <>
__device__ __forceinline__ void store_w<float>(float*, int64_t, float) {}

template <typename W>
__global__ void __launch_bounds__(THREADS)
adam_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, float* __restrict__ v, W* __restrict__ w,
            const float* __restrict__ sc, int64_t n, float b1, float c1,
            float b2, float c2, float eps, float wd, int adam_w) {
  const Scalars s = *reinterpret_cast<const Scalars*>(sc);
  if (s.skip != 0.f) return;  // fp16 overflow: leave the state untouched
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const float pi = p[i];
    float gi = g[i] * s.gscale;
    if (wd != 0.f && !adam_w) gi = gi + wd * pi;  // L2: decay into g
    const float mi = b1 * m[i] + c1 * gi;
    const float vi = b2 * v[i] + c2 * gi * gi;
    float u = (mi / s.bc1) / (sqrtf(vi / s.bc2) + eps);
    if (wd != 0.f && adam_w) u = u + wd * pi;    // decoupled decay
    const float pn = pi - s.lr * u;
    p[i] = pn;
    m[i] = mi;
    v[i] = vi;
    store_w(w, i, pn);
  }
}

template <typename W>
__global__ void __launch_bounds__(THREADS)
lion_kernel(float* __restrict__ p, const float* __restrict__ g,
            float* __restrict__ m, W* __restrict__ w,
            const float* __restrict__ sc, int64_t n, float b1, float c1,
            float b2, float c2, float wd) {
  const Scalars s = *reinterpret_cast<const Scalars*>(sc);
  if (s.skip != 0.f) return;
  for (int64_t i = blockIdx.x * (int64_t)THREADS + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * THREADS) {
    const float pi = p[i], mi = m[i];
    const float gi = g[i] * s.gscale;
    const float x = b1 * mi + c1 * gi;
    float u = (float)((x > 0.f) - (x < 0.f));
    if (wd != 0.f) u = u + wd * pi;
    const float pn = pi - s.lr * u;
    p[i] = pn;
    m[i] = b2 * mi + c2 * gi;
    store_w(w, i, pn);
  }
}

int blocks_for(int64_t n) {
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int64_t want = (n + THREADS - 1) / THREADS;
  const int64_t cap = (int64_t)sms * 8;  // 8 resident blocks of 256 per SM
  return (int)(want < cap ? (want > 0 ? want : 1) : cap);
}

}  // namespace

extern "C" {

// wdtype: the working copy w, 0 = none (w unused), 1 = bfloat16, 2 = float16.
// p, g, m, v: n contiguous fp32 elements.  sc: 5 fp32 device scalars
// [lr, bc1, bc2, gscale, skip].  c1 = 1 - b1 and c2 = 1 - b2, rounded from
// double by the caller as the reference's Python floats are.  Returns a
// cudaError_t.
int dstpu_fused_adam(float* p, const float* g, float* m, float* v, void* w,
                     int wdtype, const float* sc, long long n, float b1,
                     float c1, float b2, float c2, float eps, float wd,
                     int adam_w, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  if (wdtype == 1)
    adam_kernel<<<blocks, THREADS, 0, st>>>(
        p, g, m, v, static_cast<__nv_bfloat16*>(w), sc, n, b1, c1, b2, c2,
        eps, wd, adam_w);
  else if (wdtype == 2)
    adam_kernel<<<blocks, THREADS, 0, st>>>(p, g, m, v,
                                            static_cast<__half*>(w), sc, n,
                                            b1, c1, b2, c2, eps, wd, adam_w);
  else if (wdtype == 0)
    adam_kernel<<<blocks, THREADS, 0, st>>>(p, g, m, v,
                                            static_cast<float*>(nullptr), sc,
                                            n, b1, c1, b2, c2, eps, wd,
                                            adam_w);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

int dstpu_fused_lion(float* p, const float* g, float* m, void* w, int wdtype,
                     const float* sc, long long n, float b1, float c1,
                     float b2, float c2, float wd, void* stream) {
  if (n <= 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(n);
  if (wdtype == 1)
    lion_kernel<<<blocks, THREADS, 0, st>>>(
        p, g, m, static_cast<__nv_bfloat16*>(w), sc, n, b1, c1, b2, c2, wd);
  else if (wdtype == 2)
    lion_kernel<<<blocks, THREADS, 0, st>>>(p, g, m, static_cast<__half*>(w),
                                            sc, n, b1, c1, b2, c2, wd);
  else if (wdtype == 0)
    lion_kernel<<<blocks, THREADS, 0, st>>>(
        p, g, m, static_cast<float*>(nullptr), sc, n, b1, c1, b2, c2, wd);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

const char* dstpu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
