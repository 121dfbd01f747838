// Row RMSNorm with an f32 weight product, hand-written for Hopper
// (sm_90a). Python wrapper: kernels/norms.py rmsnorm.
//
// Replaces the TPU kernel _rmsnorm_kernel
// (infinitensor_tpu/kernels/norms.py:27, reached through rmsnorm :34-66).
//
// What it computes, as rmsnorm_ref (norms.py:21-24): for each row,
// out = x * 1/sqrt(mean(x^2) + eps) * w, all in f32, rounded once to x's
// type. x is bf16 or f32, w bf16 or f32 (read as f32). The model's own
// norm and the fused-norm matmul kernels round to bf16 before the weight
// product; this kernel does not, as the TPU kernel does not.
//
// What bounds it on this card: a row of d features is read once and
// written once with 2 FMAs and a reduction per element, far under the
// ~295 operations per byte where the tensor cores would be the limit:
// device-memory bytes (x, out and w once). At the final norm of a decode
// step (1-8 rows of 4096) the launch's latency is the floor.
//
// Design, kept simple: one block of up to 1024 threads per row (a
// 4096-wide row is 4 loads a thread: at 1-8 rows the time is a few
// device-memory latencies, not bytes), so every row count takes it (the
// TPU kernel's gate, rows >= 8 and a multiple of its 256-row block, is a
// sublane / tiling rule and is dropped). Pass 1 sums
// the squares in f32 (a warp shuffle tree, then one value per warp in
// shared memory, summed in warp order); pass 2 re-reads the row (from L1 /
// L2) and writes out.
#include "common.cuh"

namespace {

constexpr int kMaxThreads = 1024;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, typename W>
__global__ void __launch_bounds__(kMaxThreads)
rmsnorm_kernel(const T* __restrict__ x, const W* __restrict__ w,
               T* __restrict__ out, int d, float eps) {
  __shared__ float part[kMaxThreads / 32];
  const T* xr = x + (size_t)blockIdx.x * d;
  T* orow = out + (size_t)blockIdx.x * d;
  float ss = 0.f;
  for (int k = threadIdx.x; k < d; k += blockDim.x) {
    const float v = to_f32(xr[k]);
    ss = fmaf(v, v, ss);
  }
  ss = warp_sum(ss);
  const int warp = threadIdx.x >> 5, nwarps = (blockDim.x + 31) >> 5;
  if ((threadIdx.x & 31) == 0) part[warp] = ss;
  __syncthreads();
  float tot = 0.f;
  for (int i = 0; i < nwarps; ++i) tot += part[i];
  const float rinv = 1.f / sqrtf(tot / (float)d + eps);
  for (int k = threadIdx.x; k < d; k += blockDim.x)
    orow[k] = from_f32<T>(to_f32(xr[k]) * rinv * to_f32(w[k]));
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t s) {
  int threads = ((d + 31) / 32) * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  rmsnorm_kernel<T, W><<<rows, threads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const W*>(w),
      static_cast<T*>(out), d, eps);
  return cudaGetLastError();
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// x [rows, d] bf16 (x_f32 = 0) or f32; w [d] bf16 (w_f32 = 0) or f32;
// out [rows, d] in x's type.
ITT_EXPORT int rmsnorm(const void* x, int x_f32, const void* w, int w_f32,
                       void* out, int rows, int d, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || d <= 0) return (int)cudaErrorInvalidValue;
  if (x_f32)
    return w_f32 ? (int)launch<float, float>(x, w, out, rows, d, eps, s)
                 : (int)launch<float, __nv_bfloat16>(x, w, out, rows, d, eps, s);
  return w_f32 ? (int)launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s)
               : (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d,
                                                          eps, s);
}
