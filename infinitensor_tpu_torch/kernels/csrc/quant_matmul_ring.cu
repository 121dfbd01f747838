// qmm_group_norm at one row (the batch-1 decode's fused RMSNorm + int4
// matmul, wqkv and w_gateup, 64 launches a Llama-2-7B token), redesigned
// for Hopper (sm_90a): an asynchronous-copy ring over a balanced
// persistent grid. Python wrapper: kernels/quant_matmul.py
// (_launch_group_norm_ring, ring_plan).
//
// Replaces the TPU kernel infinitensor_tpu/kernels/quant_matmul.py
//   qmm_group_norm_ring  <- _kernel_group_norm (:85) at one row
// for int4 weights in the main path's layout (split-half packing, groups
// that are multiples of 128 packed rows, bf16 or f32 scales, physical
// columns a multiple of 4); an int8 weight and 2 or more rows take the
// other forms (quant_matmul.py group_form).
//
// What bounds it on this card: one row uses each weight byte for 2
// multiply-adds, so the time floor is the packed weights and scales over
// device-memory bandwidth: wqkv 25.95 MB (7.8 us at 3.35 TB/s), w_gateup
// 47.58 MB (14.2 us). The CUDA-core form (quant_matmul.cuh) streams them at
// about 1.1-1.35 TB/s: 128-column blocks fit the card badly (wqkv 96 on
// 132 SMs, w_gateup 176), a norm launch takes no K split, every block reads
// and reduces the whole row before its first weight load, and each lane has
// only its unrolled 32-bit loads in flight.
//
// Design:
//  * the grid, the ring and the merge of ring.cuh (shared with
//    quant_matmul_w4a8_ring.cu): stream-K shares of (128-column tile, packed
//    scale group) units, one block an SM, a 4-stage ring of 17,408-byte
//    stages (3 stages, 52,224 bytes, in flight while the 16 warps decode
//    the fourth, against the ~25 KB an SM needs at 3.35 TB/s / 132 SMs and
//    about 1 us of latency; TMA copies where the rows are 16-byte aligned,
//    cp.async else), the shared tiles summed in block order by the last
//    block to arrive (wqkv 1536 units, 11-12 a block; w_gateup 2816,
//    21-22);
//  * the norm inside: a block issues its first 3 stages, then takes the
//    row's mean of squares with rms_norm_rinv (the 512-thread reduction of
//    the CUDA-core prologue, so the normalized x is that prologue's to the
//    bit) while they land, and normalizes with rms_norm_value only the x
//    columns of its own groups (lo and hi), as f32 in shared memory;
//  * the arithmetic of quant_matmul.cuh: warp w takes packed rows 8w..8w+7
//    of a stage, lane l its columns 4l..4l+3 (one 32-bit word a row, a warp
//    a 128-byte row); each nibble decodes with the 2^23 trick to its exact
//    value times a power of two fixed by its bit position (lo nibble of
//    byte j: 1 or 256, hi: 16 or 4096; bytes 2-3 are shifted down once), so
//    a weight costs one LOP3, one FADD and one FFMA; the f32 partials of a
//    scale group times the scale divided by that power of two (exact) is
//    the partial of the exact values times the scale, to the bit; the 16
//    warps' sums meet in shared memory in warp order at the end of a tile.
#include "ring.cuh"

namespace {

using ring::kCols;
using ring::kRowsWarp;
using ring::kThreads;
using qmm_detail::kLanes;
using qmm_detail::kWarps;

inline size_t ring_smem(int din) {
  return ring::kAlignPad + ring::kRingBytes + sizeof(float) * ((size_t)din + kWarps * kCols);
}

// x bf16 [din] (one row); nw bf16 [din]; qw int8 [din / 2, dout_p] (int4,
// split-half packing); sc [din / group, dout_p] bf16 (SCB) or f32; out bf16
// [dout_p]; part f32 [gridDim.x, 2, kCols] scratch; counters int32
// [tiles], zero (and zero again after the launch). A16: the weight and
// scale rows are 16-byte aligned (dout_p % 16 == 0).
template <bool SCB, bool A16>
__global__ void __launch_bounds__(kThreads, 1)
qmm_group_norm_ring_kernel(const __nv_bfloat16* __restrict__ x,
                           const __nv_bfloat16* __restrict__ nw,
                           const int8_t* __restrict__ qw,
                           const void* __restrict__ sc,
                           __nv_bfloat16* __restrict__ out,
                           float* __restrict__ part, int* __restrict__ counters,
                           int din, int dout_p, int group, float eps,
                           const __grid_constant__ ring::Maps maps) {
  extern __shared__ __align__(128) unsigned char smem_[];
  unsigned char* smem = ring::aligned(smem_);
  float* xs = reinterpret_cast<float*>(smem + ring::kRingBytes);        // [din]
  float* red = xs + din;                                                // [kWarps][kCols]
  __shared__ float rpart[kWarps];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const ring::Share sh(din, dout_p, group);
  const int krows = sh.krows;

  // the row statistics while the first stages land, then the x columns of
  // this block's groups (a cyclic run of them), lo and hi
  auto prologue = [&] {
    const float rinv = qmm_detail::rms_norm_rinv<kXBf16>(x, 0, din, eps, rpart);
    const int g0 = sh.u0 % sh.ngs, gn = min(sh.u1 - sh.u0, sh.ngs);
#pragma unroll 4
    for (int k = tid; k < gn * group; k += kThreads) {
      const int p = (g0 + k / group) % sh.ngs * group + k % group;
      xs[p] = qmm_detail::rms_norm_value(qmm_detail::load_x<kXBf16>(x, p), rinv, nw, p);
      xs[krows + p] = qmm_detail::rms_norm_value(
          qmm_detail::load_x<kXBf16>(x, krows + p), rinv, nw, krows + p);
    }
  };
  auto consume = [&](const unsigned char* st, const ring::Pos& at, float (&acc)[4]) {
    const int p = at.p0 + warp * kRowsWarp;
    uint32_t w[kRowsWarp];
#pragma unroll
    for (int r = 0; r < kRowsWarp; ++r)
      w[r] = *reinterpret_cast<const uint32_t*>(st + (warp * kRowsWarp + r) * kCols + lane * 4);
    float xl[kRowsWarp], xh[kRowsWarp];
#pragma unroll
    for (int r = 0; r < kRowsWarp; r += 4) {
      const float4 a = *reinterpret_cast<const float4*>(xs + p + r);
      const float4 h = *reinterpret_cast<const float4*>(xs + krows + p + r);
      xl[r] = a.x, xl[r + 1] = a.y, xl[r + 2] = a.z, xl[r + 3] = a.w;
      xh[r] = h.x, xh[r + 1] = h.y, xh[r + 2] = h.z, xh[r + 3] = h.w;
    }
    float pl[4] = {0.f, 0.f, 0.f, 0.f}, ph[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int r = 0; r < kRowsWarp; ++r) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t v = half ? w[r] >> 16 : w[r];
        const int j = 2 * half;
        pl[j] = fmaf(xl[r], __uint_as_float((v & 0xFu) | 0x4B000000u) - 8388616.f, pl[j]);
        ph[j] = fmaf(xh[r], __uint_as_float((v & 0xF0u) ^ 0x4B000080u) - 8388736.f, ph[j]);
        pl[j + 1] =
            fmaf(xl[r], __uint_as_float((v & 0xF00u) | 0x4B000000u) - 8390656.f, pl[j + 1]);
        ph[j + 1] =
            fmaf(xh[r], __uint_as_float((v & 0xF000u) ^ 0x4B008000u) - 8421376.f, ph[j + 1]);
      }
    }
    float sl[4], shs[4];
    ring::stage_scales<SCB>(st, sl, shs);
    // the partials hold the exact values times 1 or 256 (lo), 16 or 4096
    // (hi) by the column's byte within its pair: undone on the scale
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = fmaf(ph[j], shs[j] * (j & 1 ? 1.f / 4096.f : 1.f / 16.f),
                    fmaf(pl[j], sl[j] * (j & 1 ? 1.f / 256.f : 1.f), acc[j]));
  };
  ring::stream<A16, SCB ? 2 : 4>(
      smem, red, qw, sc, maps, part, counters, sh, dout_p, prologue, consume,
      [&](int col, float v) { out[col] = __float2bfloat16_rn(v); });
}

template <bool SCB, bool A16>
cudaError_t launch(const void* x, const void* nw, const void* qw, const void* sc,
                   void* out, void* part, void* counters, int din, int dout_p,
                   int group, int blocks, float eps, cudaStream_t stream) {
  static SmemGrant granted;
  auto kernel = qmm_group_norm_ring_kernel<SCB, A16>;
  const size_t smem = ring_smem(din);
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  ring::Maps maps{};
  if (A16 && (e = ring::encode_maps(&maps, qw, sc, SCB ? 2 : 4, din / 2, dout_p,
                                    din / 2 / group)) != cudaSuccess)
    return e;
  kernel<<<blocks, dim3(kLanes, kWarps), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(nw),
      static_cast<const int8_t*>(qw), sc, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), din, dout_p, group, eps, maps);
  return cudaGetLastError();
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// One row: out bf16 [dout_p] = (RMSNorm(x) * nw) @ W, W int4 (split-half
// packing) qw int8 [din / 2, dout_p] with scales sc [din / group, dout_p]
// (bf16 if sc_bf16, else f32); x, nw bf16 [din]. group a multiple of 128
// dividing din / 2, dout_p a multiple of 4, din * 4 bytes of shared memory
// beside the ring (din up to 32768). blocks: the grid (ring_plan, at most
// the units); part f32 [blocks, 2, 128] scratch; counters int32
// [ceil(dout_p / 128)], zero, and zero again after the launch.
ITT_EXPORT int qmm_group_norm_ring(const void* x, const void* nw, const void* qw,
                                   const void* sc, int sc_bf16, void* out, void* part,
                                   void* counters, int din, int dout_p, int group,
                                   int blocks, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int krows = din / 2;
  if (din <= 0 || din % 2 || group <= 0 || group % ring::kRows || krows % group ||
      dout_p <= 0 || dout_p % 4 || !part || !counters ||
      ring_smem(din) > (size_t)qmm_detail::kSmemMax)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)(dout_p + kCols - 1) / kCols * (krows / group);
  if (blocks <= 0 || blocks > units) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(qw) % 4 || reinterpret_cast<uintptr_t>(sc) % 4)
    return (int)cudaErrorInvalidValue;
  const bool a16 = dout_p % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sc) % 16 == 0;
#define ITT_RING(SB, A)                                                        \
  if ((bool)sc_bf16 == SB && a16 == A)                                         \
    return (int)launch<SB, A>(x, nw, qw, sc, out, part, counters, din, dout_p, \
                              group, blocks, eps, s);
  ITT_RING(true, true) ITT_RING(true, false) ITT_RING(false, true) ITT_RING(false, false)
#undef ITT_RING
  return (int)cudaErrorInvalidValue;
}
