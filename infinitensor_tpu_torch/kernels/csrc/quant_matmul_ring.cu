// The one-row int4 group-dot matmuls of the batch-1 decode, redesigned for
// Hopper (sm_90a) as one kernel template over the ring of ring.cuh: an
// asynchronous-copy ring over a balanced persistent grid, with an f32
// CUDA-core consumer. Python wrappers: kernels/quant_matmul.py
// (_launch_norm_ring, _launch_group2d_ring, ring_plan; group_form,
// slab_form and group2d_form answer "ring").
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/quant_matmul.py, at
// one row of an int4 weight:
//   qmm_group_norm_ring <- _kernel_group_norm (:85): RMSNorm + group dots,
//                          wqkv and w_gateup, 64 launches a Llama-2-7B token
//   qmm_slab_norm_ring  <- _kernel_group_norm_slab (:208; _group_dots_slab
//                          :170): the same over the paired layout, one scale
//                          row per packed group (paired weights' wqkv and
//                          w_gateup, 64 a token)
//   qmm_group2d_ring    <- _kernel_group2d (:404): the group dots that the
//                          TPU splits along K to lengthen a short grid (wo
//                          and w_down under a split-K table entry, 64 a
//                          token), here one launch: the stream-K grid is
//                          Hopper's answer to the same short grid
// for weights in split-half packing, groups that are multiples of 128
// packed rows, bf16 or f32 scales, physical columns a multiple of 4; x bf16
// with the norm, bf16, f16 or f32 without (out in x's type). An int8
// weight and 2 or more rows take the other forms.
//
// What bounds it on this card: one row uses each weight byte for 2
// multiply-adds, so the time floor is the packed weights and scales over
// device-memory bandwidth: wqkv 25.95 MB (7.8 us at 3.35 TB/s), w_gateup
// 47.58 MB (14.2 us; paired 25.4 and 46.6 MB), wo 8.65 MB (2.6 us), w_down
// 23.2 MB (6.9 us). The CUDA-core forms stream them at about 1.1-1.35
// TB/s: 128-column blocks fit the card badly (wqkv 96 on 132 SMs,
// w_gateup 176), a norm launch takes no K split, every block reads and
// reduces the whole row before its first weight load, and each lane has
// only its unrolled 32-bit loads in flight; qmm_group2d's split is two
// launches (1376 blocks at w_down, kb 128, and a 0.7 MB f32 workspace
// written and read back by splitk_sum).
//
// Design:
//  * the grid, the ring, the merge and the launch of ring.cuh (shared with
//    quant_matmul_w4a8_ring.cu): stream-K shares of (128-column tile, packed
//    scale group) units, one block an SM, a 4-stage ring of 17,408-byte
//    stages (3 stages, 52,224 bytes, in flight while the 16 warps decode
//    the fourth, against the ~25 KB an SM needs at 3.35 TB/s / 132 SMs and
//    about 1 us of latency; TMA copies where the rows are 16-byte aligned,
//    cp.async else; PAIRED: one scale row a stage), the shared tiles summed
//    in block order by the last block to arrive (wqkv 1536 units, 11-12 a
//    block; w_gateup 2816, 21-22; wo 1024, 7-8; w_down 1376, 10-11), a
//    programmatic dependent launch whose first stages go out before the
//    kernel ahead of it ends;
//  * NORM: a block issues its first 3 stages, then takes the row's mean of
//    squares with rms_norm_rinv (the 512-thread reduction of the CUDA-core
//    prologue, so the normalized x is that prologue's to the bit) while
//    they land, and normalizes with rms_norm_value only the x columns of
//    its own groups (lo and hi), as f32 in shared memory; without it the
//    block loads those columns as they are (load_x: bf16, f16 or f32);
//  * the arithmetic of quant_matmul.cuh: warp w takes packed rows 8w..8w+7
//    of a stage, lane l its columns 4l..4l+3 (one 32-bit word a row, a warp
//    a 128-byte row); each nibble decodes with the 2^23 trick to its exact
//    value times a power of two fixed by its bit position (lo nibble of
//    byte j: 1 or 256, hi: 16 or 4096; bytes 2-3 are shifted down once), so
//    a weight costs one LOP3, one FADD and one FFMA; at a stage's end the
//    f32 partials times the scale divided by that power of two (exact) are
//    the partials of the exact values times the scale, to the bit: lo
//    against s_lo, hi against s_hi (PAIRED: both against the group's one
//    scale, pl s (1 | 1/256) + ph s (1/16 | 1/4096)); the 16 warps' sums
//    meet in shared memory in warp order at the end of a tile. The sum
//    runs over K in another order than the TPU kernels' (and qmm_group2d's
//    per-split partials), so it agrees with them within rounding; a replay
//    repeats bit for bit.
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

// x [din] (one row; XK: bf16 with the norm, else bf16, f16 or f32); nw bf16
// [din] (NORM); qw int8 [din / 2, dout_p] (int4, split-half packing); sc
// [din / group, dout_p] (PAIRED: [din / (2 group), dout_p]) bf16 (SCB) or
// f32; out [dout_p] in x's type; part f32 [gridDim.x, 2, kCols] scratch;
// counters int32 [tiles], zero (and zero again after the launch). A16: the
// weight and scale rows are 16-byte aligned (dout_p % 16 == 0).
template <bool SCB, bool A16, bool NORM, bool PAIRED, int XK>
__global__ void __launch_bounds__(kThreads, 1)
qmm_ring_kernel(const void* __restrict__ x, const __nv_bfloat16* __restrict__ nw,
                const int8_t* __restrict__ qw, const void* __restrict__ sc,
                void* __restrict__ out, float* __restrict__ part,
                int* __restrict__ counters, int din, int dout_p, int group, float eps,
                const __grid_constant__ ring::Maps maps) {
  static_assert(XK == kXBf16 || !NORM, "only a bf16 x takes the norm");
  extern __shared__ __align__(128) unsigned char smem_[];
  unsigned char* smem = ring::aligned(smem_);
  float* xs = reinterpret_cast<float*>(smem + ring::kRingBytes);        // [din]
  float* red = xs + din;                                                // [kWarps][kCols]
  __shared__ float rpart[kWarps];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const ring::Share sh(din, dout_p, group);
  const int krows = sh.krows;

  // the row statistics while the first stages land (NORM), then the x
  // columns of this block's groups (a cyclic run of them), lo and hi
  auto prologue = [&] {
    const int g0 = sh.u0 % sh.ngs, gn = min(sh.u1 - sh.u0, sh.ngs);
    if constexpr (NORM) {
      const float rinv = qmm_detail::rms_norm_rinv<kXBf16>(x, 0, din, eps, rpart);
#pragma unroll 4
      for (int k = tid; k < gn * group; k += kThreads) {
        const int p = (g0 + k / group) % sh.ngs * group + k % group;
        xs[p] = qmm_detail::rms_norm_value(qmm_detail::load_x<kXBf16>(x, p), rinv, nw, p);
        xs[krows + p] = qmm_detail::rms_norm_value(
            qmm_detail::load_x<kXBf16>(x, krows + p), rinv, nw, krows + p);
      }
    } else {
#pragma unroll 4
      for (int k = tid; k < gn * group; k += kThreads) {
        const int p = (g0 + k / group) % sh.ngs * group + k % group;
        xs[p] = qmm_detail::load_x<XK>(x, p);
        xs[krows + p] = qmm_detail::load_x<XK>(x, krows + p);
      }
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
    ring::stage_scales<SCB, PAIRED>(st, sl, shs);
    // the partials hold the exact values times 1 or 256 (lo), 16 or 4096
    // (hi) by the column's byte within its pair: undone on the scale (lo's
    // and hi's, or PAIRED the one both take)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = fmaf(ph[j], shs[j] * (j & 1 ? 1.f / 4096.f : 1.f / 16.f),
                    fmaf(pl[j], sl[j] * (j & 1 ? 1.f / 256.f : 1.f), acc[j]));
  };
  ring::stream<A16, SCB ? 2 : 4, PAIRED>(
      smem, red, qw, sc, maps, part, counters, sh, dout_p, prologue, consume,
      [&](int col, float v) { qmm_detail::store_out<XK>(out, col, v); });
}

template <bool SCB, bool A16, bool NORM, bool PAIRED, int XK>
cudaError_t launch(const void* x, const void* nw, const void* qw, const void* sc, void* out,
                   void* part, void* counters, int din, int dout_p, int group, int blocks,
                   float eps, cudaStream_t stream) {
  static SmemGrant granted;
  auto kernel = qmm_ring_kernel<SCB, A16, NORM, PAIRED, XK>;
  const size_t smem = ring_smem(din);
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  ring::Maps maps{};
  const int ngs = din / 2 / group;
  if (A16 && (e = ring::encode_maps(&maps, qw, sc, SCB ? 2 : 4, din / 2, dout_p,
                                    PAIRED ? ngs : 2 * ngs)) != cudaSuccess)
    return e;
  return ring::launch(kernel, blocks, smem, stream, x,
                      static_cast<const __nv_bfloat16*>(nw), static_cast<const int8_t*>(qw), sc,
                      out, static_cast<float*>(part), static_cast<int*>(counters), din, dout_p,
                      group, eps, maps);
}

// The checks and the dispatch of the three C entries.
int ring_entry(const void* x, int x_kind, const void* nw, const void* qw, const void* sc,
               int sc_bf16, void* out, void* part, void* counters, int din, int dout_p,
               int group, int blocks, bool norm, bool paired, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int krows = din / 2;
  if (din <= 0 || din % 2 || group <= 0 || group % ring::kRows || krows % group ||
      dout_p <= 0 || dout_p % 4 || !part || !counters || (norm && x_kind != kXBf16) ||
      ring_smem(din) > (size_t)qmm_detail::kSmemMax)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)(dout_p + kCols - 1) / kCols * (krows / group);
  if (blocks <= 0 || blocks > units) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(qw) % 4 || reinterpret_cast<uintptr_t>(sc) % 4)
    return (int)cudaErrorInvalidValue;
  const bool a16 = dout_p % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sc) % 16 == 0;
#define ITT_RING(SB, A, N, P, XF)                                                     \
  if ((bool)sc_bf16 == SB && a16 == A && norm == N && paired == P && x_kind == XF)    \
    return (int)launch<SB, A, N, P, XF>(x, nw, qw, sc, out, part, counters, din, dout_p, \
                                        group, blocks, eps, s);
#define ITT_RING_SA(N, P, XF)                                                         \
  ITT_RING(true, true, N, P, XF) ITT_RING(true, false, N, P, XF)                      \
  ITT_RING(false, true, N, P, XF) ITT_RING(false, false, N, P, XF)
  ITT_RING_SA(true, false, kXBf16) ITT_RING_SA(true, true, kXBf16)
  ITT_RING_SA(false, false, kXBf16) ITT_RING_SA(false, false, kXF16)
  ITT_RING_SA(false, false, kXF32)
#undef ITT_RING_SA
#undef ITT_RING
  return (int)cudaErrorInvalidValue;
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
  return ring_entry(x, kXBf16, nw, qw, sc, sc_bf16, out, part, counters, din, dout_p, group,
                    blocks, true, false, eps, stream);
}

// qmm_group_norm_ring over a paired weight: sc [din / (2 group), dout_p],
// the one scale of packed group c for both its halves.
ITT_EXPORT int qmm_slab_norm_ring(const void* x, const void* nw, const void* qw,
                                  const void* sc, int sc_bf16, void* out, void* part,
                                  void* counters, int din, int dout_p, int group,
                                  int blocks, float eps, void* stream) {
  return ring_entry(x, kXBf16, nw, qw, sc, sc_bf16, out, part, counters, din, dout_p, group,
                    blocks, true, true, eps, stream);
}

// qmm_group_norm_ring without the norm: out [dout_p] in x's type = x @ W, x
// [din] bf16, f16 or f32 (x_kind kXBf16, kXF16 or kXF32).
ITT_EXPORT int qmm_group2d_ring(const void* x, int x_kind, const void* qw, const void* sc,
                                int sc_bf16, void* out, void* part, void* counters, int din,
                                int dout_p, int group, int blocks, void* stream) {
  return ring_entry(x, x_kind, nullptr, qw, sc, sc_bf16, out, part, counters, din, dout_p,
                    group, blocks, false, false, 0.f, stream);
}
