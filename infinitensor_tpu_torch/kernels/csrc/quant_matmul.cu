// Weight-only int4/int8 group-dot matmuls for decode, hand-written for
// Hopper (sm_90a). Python wrappers: kernels/quant_matmul.py. The group-dot
// body and its design notes are in quant_matmul.cuh (shared with
// quant_matmul_fused.cu and quant_matmul_chunk.cu).
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/quant_matmul.py:
//   qmm_group (has_norm=0)  <- _kernel_group        (:100, _group_dots :115)
//   qmm_group (has_norm=1)  <- _kernel_group_norm   (:85)
//   qmm_w4a8                <- _kernel_group_w4a8   (:283,
//                              _group_dots_w4a8 :229, _quantize_rows_i8 :217)
//   qmm_norm_w4a8           <- _kernel_group_norm_w4a8 (:288)
//
// What bounds it on this card: at decode (rows = batch = 1) every weight
// byte is used for 2 multiply-adds per row, far below the ~295 ops/byte
// where the H100 stops being memory-bound, so the time floor is the
// packed weights + scales over device-memory bandwidth (wqkv 25.95 MB,
// w_gateup 47.58 MB, wo 8.65 MB, w_down 23.25 MB, lm_head 67.58 MB at
// Llama-2-7B int4 with bf16 scales).
//
// qmm_w4a8 quantizes each activation row to int8 per block (sx =
// max(amax, 1e-30) * f32(1/127), round half to even, clip +-127),
// transposes 4 packed rows x 4 columns with byte permutes, and runs
// __dp4a against (b & 0x0F) = lo + 8 and (b & 0xF0) = 16 * hi as signed
// bytes; the i32 partials are exact, then rescaled per group in f32
// (s_lo and s_hi / 16, minus 8 * sum(xq) for the low half) and by sx
// at the end, as the TPU kernel does. qmm_norm_w4a8 runs the RMSNorm of
// quant_matmul.cuh first: the row max needs the whole NORMALIZED row, so
// a block takes the mean of squares over the raw row, then recomputes
// each normalized value (the same bf16 value every time) for the
// block-wide max and again for the quantize, instead of holding a second
// f32 copy of the row in shared memory.
//
// qmm_group without the norm also takes an f16 or f32 x (x_kind, common.cuh)
// and writes x's type, as the TPU kernels take any float x and write x's
// type; qmm_w4a8 takes bf16 and f32 (an f16 x under "w4a8" takes qmm_group
// on the card, as the JAX package sends it to its group kernel).
#include "quant_matmul.cuh"

namespace {

using namespace qmm_detail;

template <int BITS, int R, bool NORM, int XK = kXBf16>
__global__ void __launch_bounds__(kLanes * kWarps)
qmm_w4a8_kernel(const void* __restrict__ x,
                const __nv_bfloat16* __restrict__ nw,
                const int8_t* __restrict__ qw, const void* __restrict__ sc,
                bool sc_bf16, void* __restrict__ out, int rows,
                int din, int dout_p, int group, float eps) {
  static_assert(XK == kXBf16 || !NORM, "only a bf16 x takes the norm");
  extern __shared__ float smem[];
  float* red = smem;                                        // [kWarps][R][kCols]
  int8_t* xq = reinterpret_cast<int8_t*>(smem + kWarps * R * kCols);  // [R][din]
  __shared__ float part[kWarps];
  __shared__ float sx[R];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane, nthr = kLanes * kWarps;
  const int row0 = blockIdx.y * R;
  const int nrows = min(R, rows - row0);

  // per-row int8 activations, as _quantize_rows_i8 (after the RMSNorm)
  for (int r = 0; r < R; ++r) {
    const size_t xr = (size_t)(row0 + r) * din;    // the row's first x
    if (r >= nrows) {
      for (int k = tid; k < din; k += nthr) xq[r * din + k] = 0;
      if (tid == 0) sx[r] = 0.f;
      continue;
    }
    const float rinv = NORM ? rms_norm_rinv<XK>(x, xr, din, eps, part) : 1.f;
    auto xn = [&](int k) {
      const float v = load_x<XK>(x, xr + k);
      return NORM ? rms_norm_value(v, rinv, nw, k) : v;
    };
    float amax = 0.f;
    for (int k = tid; k < din; k += nthr) amax = fmaxf(amax, fabsf(xn(k)));
    amax = block_reduce<true>(amax, part);
    const float s = fmaxf(amax, 1e-30f) * (1.0f / 127.0f);
    for (int k = tid; k < din; k += nthr) {
      const float q = rintf(xn(k) / s);
      xq[r * din + k] = (int8_t)fminf(fmaxf(q, -127.f), 127.f);
    }
    if (tid == 0) sx[r] = s;
  }
  __syncthreads();

  const int col = blockIdx.x * kCols + lane * 4;
  const int krows = BITS == 4 ? din / 2 : din;
  const int ngs = krows / group;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  if (col < dout_p) {
    for (int c = warp; c < ngs; c += kWarps) {
      int il[R][4], ih[R][4], sxl[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        sxl[r] = 0;
#pragma unroll
        for (int j = 0; j < 4; ++j) il[r][j] = ih[r][j] = 0;
      }
      const int8_t* qp = qw + (size_t)c * group * dout_p + col;
#pragma unroll 2
      for (int i = 0; i < group; i += 4) {
        uint32_t w[4];
#pragma unroll
        for (int t = 0; t < 4; ++t)
          w[t] = __ldg(reinterpret_cast<const uint32_t*>(qp + (size_t)(i + t) * dout_p));
        // rows i..i+3 x columns j -> one word per column, rows in bytes
        uint32_t cw[4];
        transpose_bytes(w, cw);
        const int k = c * group + i;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int xl = *reinterpret_cast<const int*>(xq + r * din + k);
          if (BITS == 4) {
            const int xh = *reinterpret_cast<const int*>(xq + r * din + krows + k);
            sxl[r] = __dp4a(xl, 0x01010101, sxl[r]);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              il[r][j] = __dp4a(xl, (int)(cw[j] & 0x0F0F0F0Fu), il[r][j]);
              ih[r][j] = __dp4a(xh, (int)(cw[j] & 0xF0F0F0F0u), ih[r][j]);
            }
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) il[r][j] = __dp4a(xl, (int)cw[j], il[r][j]);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s_lo = load_scale(sc, sc_bf16, (size_t)c * dout_p + col + j);
        const float s_hi =
            BITS == 4
                ? load_scale(sc, sc_bf16, (size_t)(ngs + c) * dout_p + col + j) * 0.0625f
                : 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][j] += BITS == 4 ? (float)(il[r][j] - 8 * sxl[r]) * s_lo +
                                       (float)ih[r][j] * s_hi
                                 : (float)il[r][j] * s_lo;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * R + r) * kCols + lane * 4 + j] = acc[r][j];
  __syncthreads();
  write_out<R, false, XK>(red, sx, nullptr, false, 0, out, nullptr, rows,
                          row0, nrows, dout_p);
}

template <int BITS, int R, bool NORM, int XK = kXBf16>
cudaError_t launch_w4a8(const void* x, const void* nw, const void* qw,
                        const void* sc, bool sc_bf16, void* out, int rows,
                        int din, int dout_p, int group, float eps,
                        cudaStream_t stream) {
  static SmemGrant granted;
  auto kernel = qmm_w4a8_kernel<BITS, R, NORM, XK>;
  const size_t smem = sizeof(float) * (size_t)kWarps * R * kCols + (size_t)R * din;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  dim3 grid((dout_p + kCols - 1) / kCols, (rows + R - 1) / R);
  kernel<<<grid, dim3(kLanes, kWarps), smem, stream>>>(
      x, static_cast<const __nv_bfloat16*>(nw), static_cast<const int8_t*>(qw),
      sc, sc_bf16, out, rows, din, dout_p, group, eps);
  return cudaGetLastError();
}

int w4a8(const void* x, int x_kind, const void* nw, const void* qw,
         const void* sc, int sc_bf16, void* out, int rows, int din,
         int dout_p, int bits, int group, bool norm, float eps,
         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = rows_per_block(rows, din);
#define ITT_W4A8(B, RR, N, XF)                                                \
  if (bits == B && R == RR && norm == N && x_kind == XF)                       \
    return (int)launch_w4a8<B, RR, N, XF>(x, nw, qw, sc, sc_bf16, out, rows,  \
                                          din, dout_p, group, eps, s);
  ITT_W4A8(4, 1, false, kXBf16) ITT_W4A8(4, 2, false, kXBf16)
  ITT_W4A8(4, 4, false, kXBf16) ITT_W4A8(8, 1, false, kXBf16)
  ITT_W4A8(8, 2, false, kXBf16) ITT_W4A8(8, 4, false, kXBf16)
  ITT_W4A8(4, 1, true, kXBf16) ITT_W4A8(4, 2, true, kXBf16)
  ITT_W4A8(4, 4, true, kXBf16) ITT_W4A8(8, 1, true, kXBf16)
  ITT_W4A8(8, 2, true, kXBf16) ITT_W4A8(8, 4, true, kXBf16)
  ITT_W4A8(4, 1, false, kXF32) ITT_W4A8(4, 2, false, kXF32)
  ITT_W4A8(4, 4, false, kXF32) ITT_W4A8(8, 1, false, kXF32)
  ITT_W4A8(8, 2, false, kXF32) ITT_W4A8(8, 4, false, kXF32)
#undef ITT_W4A8
  return (int)cudaErrorInvalidValue;
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// x [rows, din] bf16, or without the norm f16 or f32 (x_kind: kXBf16,
// kXF16, kXF32); nw bf16 [din] (read when has_norm); qw int8 [din/2 or din,
// dout_p]; sc bf16/f32 [ng, dout_p]; out [rows, dout_p] in x's type.
// splits > 1 (without the norm): the split form of quant_matmul.cuh
// (KSPLIT), splits blocks along K for each tile of 128 columns, with part
// f32 [splits, rows, dout_p] scratch and counters int32 [tiles * row
// blocks], zero (and zero again after the launch).
ITT_EXPORT int qmm_group(const void* x, int x_kind, const void* nw,
                         const void* qw, const void* sc, int sc_bf16,
                         void* out, int rows, int din, int dout_p, int bits,
                         int group, int has_norm, float eps, int splits,
                         void* part, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    if (has_norm) return (int)cudaErrorInvalidValue;
    const int R = ksplit_rows(rows);
#define ITT_QMM_KS(B, RR, XF)                                                 \
  if (bits == B && R == RR && x_kind == XF)                                  \
    return (int)launch_ksplit<B, RR, false, kGroupDots, XF>(                 \
        x, qw, sc, sc_bf16, out, rows, din, dout_p, group, splits,           \
        static_cast<float*>(part), static_cast<int*>(counters), s);
#define ITT_QMM_KS_X(XF)                                                      \
  ITT_QMM_KS(4, 1, XF) ITT_QMM_KS(4, 2, XF) ITT_QMM_KS(4, 4, XF)              \
  ITT_QMM_KS(8, 1, XF) ITT_QMM_KS(8, 2, XF) ITT_QMM_KS(8, 4, XF)
    ITT_QMM_KS_X(kXBf16) ITT_QMM_KS_X(kXF16) ITT_QMM_KS_X(kXF32)
#undef ITT_QMM_KS_X
#undef ITT_QMM_KS
    return (int)cudaErrorInvalidValue;
  }
  const int R = rows_per_block(rows, sizeof(float) * din);
  if (group_smem(R, din) > kSmemMax) return (int)cudaErrorInvalidValue;
#define ITT_QMM(B, RR, N, XF)                                                 \
  if (bits == B && R == RR && (bool)has_norm == N && x_kind == XF)           \
    return (int)launch_group<B, RR, (N ? kRmsNorm : kNoNorm), false,          \
                             kGroupDots, XF>(                                 \
        x, nw, nullptr, true, qw, sc, sc_bf16, nullptr, false, 0, out, rows,  \
        din, dout_p, group, eps, s);
  ITT_QMM(4, 1, true, kXBf16) ITT_QMM(4, 2, true, kXBf16)
  ITT_QMM(4, 4, true, kXBf16) ITT_QMM(8, 1, true, kXBf16)
  ITT_QMM(8, 2, true, kXBf16) ITT_QMM(8, 4, true, kXBf16)
#define ITT_QMM_X(XF)                                                         \
  ITT_QMM(4, 1, false, XF) ITT_QMM(4, 2, false, XF) ITT_QMM(4, 4, false, XF)  \
  ITT_QMM(8, 1, false, XF) ITT_QMM(8, 2, false, XF) ITT_QMM(8, 4, false, XF)
  ITT_QMM_X(kXBf16) ITT_QMM_X(kXF16) ITT_QMM_X(kXF32)
#undef ITT_QMM_X
#undef ITT_QMM
  return (int)cudaErrorInvalidValue;
}

// As qmm_group without the norm, through int8 activations (W4A8; bits=8
// gives W8A8); x bf16 or f32 (x_kind kXBf16 or kXF32), out in x's type.
ITT_EXPORT int qmm_w4a8(const void* x, int x_kind, const void* qw,
                        const void* sc, int sc_bf16, void* out, int rows,
                        int din, int dout_p, int bits, int group,
                        void* stream) {
  return w4a8(x, x_kind, nullptr, qw, sc, sc_bf16, out, rows, din,
              dout_p, bits, group, false, 0.f, stream);
}

// RMSNorm(x) * nw (nw bf16 [din]) ahead of qmm_w4a8's quantize and dots.
ITT_EXPORT int qmm_norm_w4a8(const void* x, const void* nw, const void* qw,
                             const void* sc, int sc_bf16, void* out, int rows,
                             int din, int dout_p, int bits, int group,
                             float eps, void* stream) {
  return w4a8(x, kXBf16, nw, qw, sc, sc_bf16, out, rows, din, dout_p, bits,
              group, true, eps, stream);
}

// The id of the graph capture under way on `stream`, or 0 where none is:
// the wrapper gives each capture its own split-form counters.
ITT_EXPORT unsigned long long itt_capture_id(void* stream) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status,
                               &id) != cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}
