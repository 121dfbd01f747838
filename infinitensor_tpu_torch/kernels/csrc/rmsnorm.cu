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
// Design: one warp a row, kRowWarps rows a block of 128 threads (1024 rows
// are 256 blocks, resident in one wave); a block a row, with its second read
// of the row and its shared-memory reduction and barrier a row, read slower
// at every row count on the H100 (PERF.md §6, row 14; tools/step_ab.py times
// it from an older checkout). Where d is a multiple of a 16-byte chunk's
// elements and x, w and out are 16-byte aligned, a lane moves 16 bytes a
// load and a store and holds its chunks of the row in registers up to d =
// kHeldWidth, so x is read from device memory once; chunks past those are
// read again in pass 2, from L1 / L2. A lane issues the copies of all its
// held chunks before it uses any, and w's in groups of kWGroup chunks
// (copies issued one use at a time cost a device-memory round trip each).
// Otherwise (an offset view, an odd width) the warp walks the row with
// scalar loads. The sum of squares is a lane's f32 sum in chunk order, then
// a shuffle tree: no shared memory, no barrier. w goes through the read-only
// cache (__ldg). Results repeat bit for bit.
#include "common.cuh"

namespace {

constexpr int kRowWarps = 4;        // rows a block, a warp each
constexpr int kHeldWidth = 4096;    // a row up to this wide stays in registers
constexpr int kWGroup = 4;          // chunks of w a lane loads at once

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

// A 16-byte chunk of T: E = 16 / sizeof(T) elements; a lane holds kHeld
// chunks of its row (64 registers in bf16, 128 in f32).
template <typename T>
struct Chunk {
  static constexpr int E = 16 / sizeof(T);
  static constexpr int kHeld = kHeldWidth / 32 / E;
};

// The E elements of a chunk of T as f32.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& c,
                                       float (&v)[Chunk<T>::E]) {
  const uint32_t u[4] = {c.x, c.y, c.z, c.w};
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = __uint_as_float(u[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      v[2 * j] = __uint_as_float(u[j] << 16);
      v[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// E f32 values as a chunk of T (bf16: rounded to nearest even).
template <typename T>
__device__ __forceinline__ uint4 pack(const float (&v)[Chunk<T>::E]) {
  uint32_t u[4];
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) u[j] = __float_as_uint(v[j]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
      u[j] = *reinterpret_cast<const uint32_t*>(&b);
    }
  }
  return make_uint4(u[0], u[1], u[2], u[3]);
}

// w[k0 .. k0 + E) as f32 through the read-only cache, in 16- (f32) or
// 8-byte (bf16) loads; k0 is a multiple of E, w 16-byte aligned.
template <typename W, int E>
__device__ __forceinline__ void load_w(const W* w, int k0, float (&v)[E]) {
  if constexpr (sizeof(W) == 4) {
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(w + k0 + j));
      v[j] = f.x, v[j + 1] = f.y, v[j + 2] = f.z, v[j + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < E; j += 4) {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(w + k0 + j));
      v[j] = __uint_as_float(u.x << 16);
      v[j + 1] = __uint_as_float(u.x & 0xffff0000u);
      v[j + 2] = __uint_as_float(u.y << 16);
      v[j + 3] = __uint_as_float(u.y & 0xffff0000u);
    }
  }
}

template <typename T>
__device__ __forceinline__ float sum_squares(const uint4& c, float ss) {
  float v[Chunk<T>::E];
  unpack<T>(c, v);
#pragma unroll
  for (int j = 0; j < Chunk<T>::E; ++j) ss = fmaf(v[j], v[j], ss);
  return ss;
}

// Chunk c of the output row: x's chunk xc times rinv times w's chunk wv,
// in f32.
template <typename T>
__device__ __forceinline__ void store_chunk(T* orow, int c, const uint4& xc,
                                            const float (&wv)[Chunk<T>::E],
                                            float rinv) {
  float v[Chunk<T>::E];
  unpack<T>(xc, v);
#pragma unroll
  for (int j = 0; j < Chunk<T>::E; ++j) v[j] = v[j] * rinv * wv[j];
  reinterpret_cast<uint4*>(orow)[c] = pack<T>(v);
}

// Warp w of block b normalizes row b * kRowWarps + w.
// VEC: 16-byte chunks (d a multiple of Chunk<T>::E, pointers aligned).
template <typename T, typename W, bool VEC>
__global__ void __launch_bounds__(32 * kRowWarps)
rmsnorm_rows_kernel(const T* __restrict__ x, const W* __restrict__ w,
                    T* __restrict__ out, int rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kRowWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const T* xr = x + (size_t)row * d;
  T* orow = out + (size_t)row * d;
  float ss = 0.f;
  if constexpr (VEC) {
    constexpr int E = Chunk<T>::E, kHeld = Chunk<T>::kHeld;
    const uint4* xc = reinterpret_cast<const uint4*>(xr);
    const int nc = d / E;
    // every copy of the held chunks is issued before any is used (a
    // chunk past the row is zero: it adds nothing to the sum)
    uint4 held[kHeld];
#pragma unroll
    for (int i = 0; i < kHeld; ++i) {
      const int c = lane + 32 * i;
      held[i] = c < nc ? xc[c] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kHeld; ++i) ss = sum_squares<T>(held[i], ss);
#pragma unroll 4
    for (int c = lane + 32 * kHeld; c < nc; c += 32)
      ss = sum_squares<T>(__ldg(xc + c), ss);
    const float rinv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);
    // w in groups of kWGroup chunks, each group's loads issued together
#pragma unroll
    for (int i0 = 0; i0 < kHeld; i0 += kWGroup) {
      float wv[kWGroup][E];
#pragma unroll
      for (int i = 0; i < kWGroup; ++i) {
        const int c = lane + 32 * (i0 + i);
        if (c < nc) load_w<W, E>(w, c * E, wv[i]);
      }
#pragma unroll
      for (int i = 0; i < kWGroup; ++i) {
        const int c = lane + 32 * (i0 + i);
        if (c < nc) store_chunk<T>(orow, c, held[i0 + i], wv[i], rinv);
      }
    }
#pragma unroll 4
    for (int c = lane + 32 * kHeld; c < nc; c += 32) {
      float wv[E];
      load_w<W, E>(w, c * E, wv);
      store_chunk<T>(orow, c, __ldg(xc + c), wv, rinv);
    }
  } else {
#pragma unroll 4
    for (int k = lane; k < d; k += 32) {
      const float v = to_f32(xr[k]);
      ss = fmaf(v, v, ss);
    }
    const float rinv = 1.f / sqrtf(warp_sum(ss) / (float)d + eps);
#pragma unroll 4
    for (int k = lane; k < d; k += 32)
      orow[k] = from_f32<T>(to_f32(xr[k]) * rinv * to_f32(__ldg(w + k)));
  }
}

template <typename T, typename W>
cudaError_t launch(const void* x, const void* w, void* out, int rows, int d,
                   float eps, cudaStream_t s) {
  const T* xt = static_cast<const T*>(x);
  const W* wt = static_cast<const W*>(w);
  T* ot = static_cast<T*>(out);
  const bool vec = d % Chunk<T>::E == 0 &&
                   (reinterpret_cast<uintptr_t>(x) |
                    reinterpret_cast<uintptr_t>(w) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  const int blocks = (rows + kRowWarps - 1) / kRowWarps;
  if (vec)
    rmsnorm_rows_kernel<T, W, true><<<blocks, 32 * kRowWarps, 0, s>>>(
        xt, wt, ot, rows, d, eps);
  else
    rmsnorm_rows_kernel<T, W, false><<<blocks, 32 * kRowWarps, 0, s>>>(
        xt, wt, ot, rows, d, eps);
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
                 : (int)launch<float, __nv_bfloat16>(x, w, out, rows, d, eps,
                                                     s);
  return w_f32 ? (int)launch<__nv_bfloat16, float>(x, w, out, rows, d, eps, s)
               : (int)launch<__nv_bfloat16, __nv_bfloat16>(x, w, out, rows, d,
                                                          eps, s);
}
