// qmm_w4a8 and qmm_norm_w4a8 at one row (the W4A8 decode: the lm_head on
// the main path; wqkv, wo, w_gateup and w_down under the W4A8 knob),
// redesigned for Hopper (sm_90a): the persistent ring of ring.cuh with an
// integer dp4a consumer. Python wrapper: kernels/quant_matmul.py
// (_launch_w4a8_ring, ring_plan; w4a8_form answers "ring").
//
// Replaces the TPU kernels infinitensor_tpu/kernels/quant_matmul.py
//   qmm_w4a8_ring       <- _kernel_group_w4a8 (:283; _quantize_rows_i8
//                          :217, _group_dots_w4a8 :229) at one row
//   qmm_norm_w4a8_ring  <- _kernel_group_norm_w4a8 (:288) at one row
// for int4 weights in split-half packing, groups that are multiples of 128
// packed rows, bf16 or f32 scales, physical columns a multiple of 4; x bf16
// (with the norm) or bf16 / f32 (without). An int8 weight (W8A8) and 2 rows
// keep the CUDA-core form (quant_matmul.cu), 3 rows and more the tensor
// cores (quant_matmul_w4a8_mma.cu).
//
// What bounds it on this card: one row uses each weight byte for 2
// multiply-adds, so the floor is the packed weights and scales over
// device-memory bandwidth (H100 SXM 3.35 TB/s): the lm_head 4096 -> 32000
// 67.6 MB (20.2 us), wqkv 26.0 MB (7.8 us), w_gateup 47.6 MB (14.2 us), wo
// 8.7 MB (2.6 us), w_down 23.3 MB (6.9 us). The CUDA-core form runs
// dout_p / 128 blocks (wo and w_down 32 on 132 SMs, wqkv 96, w_gateup 176,
// the lm_head 250) with no K split; each block quantizes the whole row
// before its first weight load and has only its unrolled 32-bit loads in
// flight.
//
// Design:
//  * the grid, the ring, the merge and the launch of ring.cuh (one block an
//    SM over stream-K shares of (128-column tile, packed scale group) units;
//    a 4-stage ring of 17,408-byte stages, each three TMA copies where the
//    rows are 16-byte aligned; the shared tiles summed in block order by
//    the last block to arrive; a programmatic dependent launch), as
//    qmm_group_norm_ring;
//  * the quantized row inside: a block issues its first 3 stages, then
//    (with the norm) takes rms_norm_rinv, then the block-wide amax of the
//    whole (normalized) row and sx = w4a8_row_scale(amax) while they land,
//    and quantizes with w4a8_code only the lo and hi x columns of its own
//    groups into shared int8. Both helpers and the 512-thread reduction are
//    the CUDA-core prologue's, so xq and sx are its bits. Every block reads
//    the whole row for the amax (4096-11008 values that L2 holds): a
//    separate quantize launch would cost more than the row;
//  * an integer consumer: warp w takes packed rows 8w..8w+7 of a stage as
//    two quads of 4 rows, lane l its columns 4l..4l+3. A quad is 4 LDS.32,
//    8 byte permutes (transpose_bytes: one word a column, its 4 K values in
//    bytes), then for each column __dp4a of (cw & 0x0F0F0F0F) = lo + 8
//    against the xq lo word and of (cw & 0xF0F0F0F0) = 16 hi against the
//    xq hi word, and one __dp4a of the lo word against 0x01010101 for the
//    -8 sum(xq_lo) correction: the arithmetic of qmm_w4a8's CUDA-core form.
//    The warp's i32 partials of a scale group are exact; at the group's
//    last stage they are folded once into the f32 column sums,
//    (il - 8 sxl) s_lo + ih (s_hi / 16), and set back to zero;
//  * sums in a fixed order (groups in stream order within a warp, the 16
//    warps in order, the blocks in order), times sx once at the tile's
//    output (linearity, as the TPU kernel does), rounded once to x's type:
//    a replay repeats bit for bit.
#include "ring.cuh"

namespace {

using namespace qmm_detail;
using ring::kRowsWarp;
using ring::kThreads;
static_assert(kCols == ring::kCols, "a ring tile is the CUDA-core form's column block");

inline size_t w4a8_ring_smem(int din) {
  return ring::kAlignPad + ring::kRingBytes + sizeof(float) * kWarps * kCols +
         ((size_t)din + 15) / 16 * 16;
}

// x [din] (one row; XK: bf16 or, without the norm, f32); nw bf16 [din]
// (NORM); qw int8 [din / 2, dout_p] (int4, split-half packing); sc
// [din / group, dout_p] bf16 (SCB) or f32; out [dout_p] in x's type; part
// f32 [gridDim.x, 2, kCols] scratch; counters int32 [tiles], zero (and zero
// again after the launch). A16: the weight and scale rows are 16-byte
// aligned (dout_p % 16 == 0).
template <bool SCB, bool A16, bool NORM, int XK>
__global__ void __launch_bounds__(kThreads, 1)
qmm_w4a8_ring_kernel(const void* __restrict__ x, const __nv_bfloat16* __restrict__ nw,
                     const int8_t* __restrict__ qw, const void* __restrict__ sc,
                     void* __restrict__ out, float* __restrict__ part,
                     int* __restrict__ counters, int din, int dout_p, int group,
                     float eps, const __grid_constant__ ring::Maps maps) {
  static_assert(XK == kXBf16 || !NORM, "only a bf16 x takes the norm");
  extern __shared__ __align__(128) unsigned char smem_[];
  unsigned char* smem = ring::aligned(smem_);
  float* red = reinterpret_cast<float*>(smem + ring::kRingBytes);        // [kWarps][kCols]
  int8_t* xq = reinterpret_cast<int8_t*>(red + kWarps * kCols);           // [din]
  __shared__ float rpart[kWarps];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const ring::Share sh(din, dout_p, group);
  const int krows = sh.krows;
  float sx = 0.f;

  auto prologue = [&] {
    float rinv = 1.f;
    if constexpr (NORM) rinv = rms_norm_rinv<XK>(x, 0, din, eps, rpart);
    auto xn = [&](int k) {
      const float v = load_x<XK>(x, k);
      return NORM ? rms_norm_value(v, rinv, nw, k) : v;
    };
    float amax = 0.f;
#pragma unroll 8
    for (int k = tid; k < din; k += kThreads) amax = fmaxf(amax, fabsf(xn(k)));
    sx = w4a8_row_scale(block_reduce<true>(amax, rpart));
    // the x columns of this block's groups (a cyclic run of them), lo and hi
    const int g0 = sh.u0 % sh.ngs, gn = min(sh.u1 - sh.u0, sh.ngs);
#pragma unroll 4
    for (int k = tid; k < gn * group; k += kThreads) {
      const int p = (g0 + k / group) % sh.ngs * group + k % group;
      xq[p] = w4a8_code(xn(p), sx);
      xq[krows + p] = w4a8_code(xn(krows + p), sx);
    }
  };

  int il[4] = {0, 0, 0, 0}, ih[4] = {0, 0, 0, 0}, sxl = 0;   // the group's exact partials
  auto consume = [&](const unsigned char* st, const ring::Pos& at, float (&acc)[4]) {
    const int p = at.p0 + warp * kRowsWarp;
#pragma unroll
    for (int qd = 0; qd < kRowsWarp; qd += 4) {
      uint32_t w[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        w[r] = *reinterpret_cast<const uint32_t*>(st + (warp * kRowsWarp + qd + r) * kCols +
                                                  lane * 4);
      uint32_t cw[4];
      transpose_bytes(w, cw);
      const int xl = *reinterpret_cast<const int*>(xq + p + qd);
      const int xh = *reinterpret_cast<const int*>(xq + krows + p + qd);
      sxl = __dp4a(xl, 0x01010101, sxl);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        il[j] = __dp4a(xl, (int)(cw[j] & 0x0F0F0F0Fu), il[j]);
        ih[j] = __dp4a(xh, (int)(cw[j] & 0xF0F0F0F0u), ih[j]);
      }
    }
    if (at.sg == sh.spg - 1) {   // the group's last stage: fold it once
      float sl[4], shs[4];
      ring::stage_scales<SCB>(st, sl, shs);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[j] += (float)(il[j] - 8 * sxl) * sl[j] + (float)ih[j] * (shs[j] * 0.0625f);
        il[j] = ih[j] = 0;
      }
      sxl = 0;
    }
  };
  ring::stream<A16, SCB ? 2 : 4>(
      smem, red, qw, sc, maps, part, counters, sh, dout_p, prologue, consume,
      [&](int col, float v) { store_out<XK>(out, col, v * sx); });
}

template <bool SCB, bool A16, bool NORM, int XK>
cudaError_t launch(const void* x, const void* nw, const void* qw, const void* sc, void* out,
                   void* part, void* counters, int din, int dout_p, int group, int blocks,
                   float eps, cudaStream_t stream) {
  static SmemGrant granted;
  auto kernel = qmm_w4a8_ring_kernel<SCB, A16, NORM, XK>;
  const size_t smem = w4a8_ring_smem(din);
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  ring::Maps maps{};
  if (A16 && (e = ring::encode_maps(&maps, qw, sc, SCB ? 2 : 4, din / 2, dout_p,
                                    din / group)) != cudaSuccess)
    return e;
  return ring::launch(kernel, blocks, smem, stream, x, static_cast<const __nv_bfloat16*>(nw),
                      static_cast<const int8_t*>(qw), sc, out, static_cast<float*>(part),
                      static_cast<int*>(counters), din, dout_p, group, eps, maps);
}

int w4a8_ring(const void* x, int x_kind, const void* nw, const void* qw, const void* sc,
              int sc_bf16, void* out, void* part, void* counters, int din, int dout_p,
              int group, int blocks, bool norm, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int krows = din / 2;
  if (din <= 0 || din % 2 || group <= 0 || group % ring::kRows || krows % group ||
      dout_p <= 0 || dout_p % 4 || !part || !counters || (norm && x_kind != kXBf16) ||
      w4a8_ring_smem(din) > (size_t)kSmemMax)
    return (int)cudaErrorInvalidValue;
  const long long units = (long long)(dout_p + kCols - 1) / kCols * (krows / group);
  if (blocks <= 0 || blocks > units) return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(qw) % 4 || reinterpret_cast<uintptr_t>(sc) % 4)
    return (int)cudaErrorInvalidValue;
  const bool a16 = dout_p % 16 == 0 && reinterpret_cast<uintptr_t>(qw) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(sc) % 16 == 0;
#define ITT_W4A8_RING(SB, A, N, XF)                                                     \
  if ((bool)sc_bf16 == SB && a16 == A && norm == N && x_kind == XF)                     \
    return (int)launch<SB, A, N, XF>(x, nw, qw, sc, out, part, counters, din, dout_p,   \
                                     group, blocks, eps, s);
#define ITT_W4A8_RING_X(N, XF)                                                          \
  ITT_W4A8_RING(true, true, N, XF) ITT_W4A8_RING(true, false, N, XF)                    \
  ITT_W4A8_RING(false, true, N, XF) ITT_W4A8_RING(false, false, N, XF)
  ITT_W4A8_RING_X(true, kXBf16) ITT_W4A8_RING_X(false, kXBf16) ITT_W4A8_RING_X(false, kXF32)
#undef ITT_W4A8_RING_X
#undef ITT_W4A8_RING
  return (int)cudaErrorInvalidValue;
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// One row: out [dout_p] in x's type = sx * (xq @ W), xq the row quantized
// to int8 (_quantize_rows_i8), W int4 (split-half packing) qw int8
// [din / 2, dout_p] with scales sc [din / group, dout_p] (bf16 if sc_bf16,
// else f32); x [din] bf16 or f32 (x_kind kXBf16 or kXF32). group a multiple
// of 128 dividing din / 2, dout_p a multiple of 4. blocks: the grid
// (ring_plan, at most the units); part f32 [blocks, 2, 128] scratch;
// counters int32 [ceil(dout_p / 128)], zero, and zero again after the
// launch.
ITT_EXPORT int qmm_w4a8_ring(const void* x, int x_kind, const void* qw, const void* sc,
                             int sc_bf16, void* out, void* part, void* counters, int din,
                             int dout_p, int group, int blocks, void* stream) {
  return w4a8_ring(x, x_kind, nullptr, qw, sc, sc_bf16, out, part, counters, din, dout_p,
                   group, blocks, false, 0.f, stream);
}

// RMSNorm(x) * nw (x, nw bf16 [din]) ahead of qmm_w4a8_ring's quantize.
ITT_EXPORT int qmm_norm_w4a8_ring(const void* x, const void* nw, const void* qw,
                                  const void* sc, int sc_bf16, void* out, void* part,
                                  void* counters, int din, int dout_p, int group, int blocks,
                                  float eps, void* stream) {
  return w4a8_ring(x, kXBf16, nw, qw, sc, sc_bf16, out, part, counters, din, dout_p, group,
                   blocks, true, eps, stream);
}
