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

__device__ __forceinline__ float neg_inf() { return __uint_as_float(0xff800000u); }

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
