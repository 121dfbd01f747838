// Helpers shared by the port's CUDA kernels (plain C interface, loaded
// with ctypes by kernels/_build.py).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define ITT_EXPORT extern "C" __attribute__((visibility("default")))

// Every library exports the message for the cudaError_t its launchers
// return, so the Python wrapper can raise with it.
#define ITT_DEFINE_ERROR_STRING()                                        \
  ITT_EXPORT const char* itt_error_string(int err) {                     \
    return cudaGetErrorString(static_cast<cudaError_t>(err));            \
  }

// The activation type of a matmul launch (its x_kind): x is read as f32
// and the output written in x's type.
constexpr int kXBf16 = 0, kXF16 = 1, kXF32 = 2;

// Each card's dynamic shared-memory cap granted to one kernel (a static
// in its launcher). cudaFuncSetAttribute sets the cap for the current
// device only, so a grant on one card says nothing of another.
constexpr int kMaxDevices = 64;
struct SmemGrant {
  size_t bytes[kMaxDevices] = {};
};

// Raise `kernel`'s dynamic shared-memory cap on the current device to
// `bytes`, once per new maximum there (the first launch of a shape on a
// card, before any graph capture that replays it).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, SmemGrant* granted) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (bytes <= granted->bytes[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess) granted->bytes[dev] = bytes;
  return e;
}

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

// Element i of a bf16, f16 or f32 array (kind kXBf16, kXF16, kXF32) as
// f32, and f32 v stored as one; the kind is a run-time argument.
__device__ __forceinline__ float load_kind(const void* p, int kind, size_t i) {
  if (kind == kXF32) return static_cast<const float*>(p)[i];
  if (kind == kXF16) return __half2float(static_cast<const __half*>(p)[i]);
  return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
}

__device__ __forceinline__ void store_kind(void* p, int kind, size_t i, float v) {
  if (kind == kXF32)
    static_cast<float*>(p)[i] = v;
  else if (kind == kXF16)
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
}

__device__ __forceinline__ float bf16_to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Scale rows are stored bf16 (the bench's int4 weights) or f32
// (quantize_weight); read either as f32.
__device__ __forceinline__ float load_scale(const void* sc, bool bf16,
                                            size_t i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(sc)[i])
              : static_cast<const float*>(sc)[i];
}

// Exact small-integer -> float without an I2F: 2^23 + n has n in its low
// mantissa bits. nib_lo: low nibble stored offset-binary (+8) -> its
// signed value. nib_hi: high nibble stored two's complement -> its value
// (n ^ 8 = n + 8 for a 4-bit two's complement n). i8: a signed byte.
__device__ __forceinline__ float nib_lo(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) | 0x4B000000u) - 8388616.f;
}
__device__ __forceinline__ float nib_hi(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFu) ^ 0x4B000008u) - 8388616.f;
}
__device__ __forceinline__ float i8_val(uint32_t w, int shift) {
  return __uint_as_float(((w >> shift) & 0xFFu) ^ 0x4B000080u) - 8388736.f;
}

// A 4 x 4 byte transpose: w[i] holds 4 adjacent columns (bytes j) of
// packed row i; cw[j] gets column j of rows 0..3 (byte i = row i), the
// layout of 4 consecutive K values that __dp4a and an int8 mma fragment
// take. Eight byte permutes.
__device__ __forceinline__ void transpose_bytes(const uint32_t (&w)[4],
                                                uint32_t (&cw)[4]) {
  const uint32_t a_lo = __byte_perm(w[0], w[1], 0x5140);
  const uint32_t a_hi = __byte_perm(w[0], w[1], 0x7362);
  const uint32_t b_lo = __byte_perm(w[2], w[3], 0x5140);
  const uint32_t b_hi = __byte_perm(w[2], w[3], 0x7362);
  cw[0] = __byte_perm(a_lo, b_lo, 0x5410);
  cw[1] = __byte_perm(a_lo, b_lo, 0x7632);
  cw[2] = __byte_perm(a_hi, b_hi, 0x5410);
  cw[3] = __byte_perm(a_hi, b_hi, 0x7632);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
