// The pieces of the tensor-core matmul tile that quant_matmul_mma.cu
// (qmm_group_mma, qmm_group_ln_mma: 16-bit operands) and
// quant_matmul_w4a8_mma.cu (qmm_w4a8_mma: int8 operands) share: the block
// shape, the cp.async ring's copies and the staging of a packed weight
// tile, ldmatrix. Both run swap-AB (out^T = W^T x^T: M over output
// columns, N over activation rows); a block is kWarps warps of 32 output
// columns each, a ring of kStages stages of kBK packed weight rows.
// flash_attention.cu takes the copies, ldmatrix, the 16-bit mma.sync
// (mma16816) and pack_out for its own tiles.
#pragma once

#include "common.cuh"

namespace mma_tile {

constexpr int kWarps = 4;                  // each owns 32 columns
constexpr int kBN = 32 * kWarps;           // output columns per block
constexpr int kBK = 64;                    // packed rows per stage
constexpr int kStages = 3;
constexpr int kWStride = kBN + 16;         // bytes per staged weight row
constexpr int kThreads = 32 * kWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 (4) bytes to shared memory, zero-filled past `valid` bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
// As ldsm_x4, each 8 x 8 matrix transposed: a lane gets rows 2 (lane % 4)
// and 2 (lane % 4) + 1 of column lane / 4 (a B fragment of a row-major
// [k][n] tile).
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// The byte offset of column byte c of staged weight row r. SWIZZLE moves
// the 32-byte half-rows of rows with bit 3 set by 32 bytes, so that
// lanes reading rows 4t + i (t = 0..3) of one column word hit 32
// distinct banks (the int8 A fragments' rows; the 16-bit tile reads rows
// 2t + i, conflict-free without it).
template <bool SWIZZLE>
__device__ __forceinline__ int wcol(int r, int c) {
  return SWIZZLE ? c ^ ((r & 8) << 2) : c;
}

// Stage the kBK x kBN int8 weight tile of packed rows p .. p + kBK and
// columns col0 .. col0 + kBN (zero past dout_p) at `base`, row stride
// kWStride: 16-byte copies, 4-byte ones where the columns are no
// multiple of 16.
template <bool SWIZZLE>
__device__ __forceinline__ void load_weight_tile(uint8_t* base,
                                                 const int8_t* qw, int p,
                                                 int col0, int dout_p) {
  if ((dout_p & 15) == 0) {
    for (int i = threadIdx.x; i < kBK * (kBN / 16); i += kThreads) {
      const int r = i / (kBN / 16), c = (i % (kBN / 16)) * 16;
      const bool ok = col0 + c < dout_p;
      cp_async16(base + r * kWStride + wcol<SWIZZLE>(r, c),
                 ok ? qw + (size_t)(p + r) * dout_p + col0 + c : qw,
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < kBK * (kBN / 4); i += kThreads) {
      const int r = i / (kBN / 4), c = (i % (kBN / 4)) * 4;
      const bool ok = col0 + c < dout_p;
      cp_async4(base + r * kWStride + wcol<SWIZZLE>(r, c),
                ok ? qw + (size_t)(p + r) * dout_p + col0 + c : qw,
                ok ? 4 : 0);
    }
  }
}

// d += a * b on the tensor cores, 16-bit operands of the type XK.
template <int XK>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if (XK == kXF16)
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, "
        "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  else
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, "
        "%3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values as a pair of 16-bit values of the type XK (a in the
// low half), rounded to nearest.
template <int XK>
__device__ __forceinline__ uint32_t pack_out(float a, float b) {
  if (XK == kXF16) {
    const __half2 h = __floats2half2_rn(a, b);
    return *reinterpret_cast<const uint32_t*>(&h);
  }
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The lane's 4 output columns of one row (its C fragment elements), at
// out[r][n .. n + 3] in the type XK: one 8-byte store (16-byte for f32).
template <int XK>
__device__ __forceinline__ void store4(void* out, size_t i, float v0,
                                       float v1, float v2, float v3) {
  if (XK == kXF32)
    *reinterpret_cast<float4*>(static_cast<float*>(out) + i) =
        make_float4(v0, v1, v2, v3);
  else
    *reinterpret_cast<uint2*>(static_cast<uint16_t*>(out) + i) =
        make_uint2(pack_out<XK>(v0, v1), pack_out<XK>(v2, v3));
}

}  // namespace mma_tile
