// The LayerNorm-fused and the paired-scale ("slab") weight-only matmuls,
// hand-written for Hopper (sm_90a) over the group-dot body of
// quant_matmul.cuh. Python wrappers: kernels/quant_matmul.py.
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/quant_matmul.py:
//   qmm_group_ln             <- _kernel_group_ln         (:300, via quant_matmul_ln :321)
//   qmm_slab (has_norm=0)    <- _kernel_group_slab       (:203, _group_dots_slab :170)
//   qmm_slab (has_norm=1)    <- _kernel_group_norm_slab  (:208)
//
// qmm_group_ln is GPT-2 decode's pre-matmul pattern in one launch:
// LayerNorm(x; gamma, beta), the int8 (or unpaired int4) group dots, and
// the output bias. What bounds it on this card: at 64 rows of 1024
// features the weights are 3-4 MB (w_qkv 3.15 MB, w_up 4.19 MB with f32
// scales), about 0.001 ms of device memory, and 0.4-0.5 GFLOP, less than
// that of tensor-core time: a launch is latency-bound, and this kernel runs
// it as f32 FMAs, 16 blocks of 4 rows re-reading each weight tile from L2
// with only 8 of the block's 16 warps owning a scale group. Both are left
// for the redesign (a tensor-core form for tens of rows).
//
// qmm_slab reads a PAIRED int4 weight (quantize_weight(paired=True): one
// scale row covers both split halves of a group). The TPU kernel takes one
// 2g-deep dot of [x_lo, x_hi / 16] . [u & 15; u & 0xF0] minus 8 * sum(x_lo)
// and multiplies by s[c]; here the nibbles decode to their exact values,
// so both partials of packed group c are simply scaled by s[c]. Bound at
// one row: the packed weights + scales over device-memory bandwidth, with
// half the scale bytes of the unpaired layout.
#include "quant_matmul.cuh"

using namespace qmm_detail;

ITT_DEFINE_ERROR_STRING()

// x bf16 [rows, din]; gamma, beta [din], both bf16 or (norm_bf16 = 0) both
// f32; qw int8 [din/2 or din,
// dout_p]; sc bf16/f32 [ng, dout_p] (int4: ng even, unpaired); bias bf16 or
// f32 [nbias], nbias <= dout_p, or null with nbias 0; out bf16
// [rows, dout_p] = bf16(bf16(LN(x) @ W) + bias).
ITT_EXPORT int qmm_group_ln(const void* x, const void* gamma, const void* beta,
                            int norm_bf16, const void* qw, const void* sc, int sc_bf16,
                            const void* bias, int bias_bf16, int nbias,
                            void* out, int rows, int din, int dout_p, int bits,
                            int group, float eps, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int R = rows_per_block(rows, sizeof(float) * din);
  if (group_smem(R, din) > kSmemMax) return (int)cudaErrorInvalidValue;
#define ITT_QMM_LN(B, RR)                                                     \
  if (bits == B && R == RR)                                                   \
    return (int)launch_group<B, RR, kLayerNorm, false>(                       \
        x, gamma, beta, norm_bf16, qw, sc, sc_bf16, bias, bias_bf16, nbias,   \
        out, rows, din, dout_p, group, eps, s);
  ITT_QMM_LN(4, 1) ITT_QMM_LN(4, 2) ITT_QMM_LN(4, 4)
  ITT_QMM_LN(8, 1) ITT_QMM_LN(8, 2) ITT_QMM_LN(8, 4)
#undef ITT_QMM_LN
  return (int)cudaErrorInvalidValue;
}

// x [rows, din] bf16, or without the norm f16 or f32 (x_kind, common.cuh);
// nw bf16 [din] (the RMSNorm weight, read when has_norm); qw int8 [din/2,
// dout_p] split-half int4; sc bf16/f32 [din / (2 * group), dout_p]; out
// [rows, dout_p] in x's type. splits > 1 (without the norm): the split
// form of quant_matmul.cuh, with part and counters as for qmm_group.
ITT_EXPORT int qmm_slab(const void* x, int x_kind, const void* nw,
                        const void* qw, const void* sc, int sc_bf16,
                        void* out, int rows, int din, int dout_p, int group,
                        int has_norm, float eps, int splits, void* part,
                        void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits > 1) {
    if (has_norm) return (int)cudaErrorInvalidValue;
    const int R = ksplit_rows(rows);
#define ITT_SLAB_KS(RR, XF)                                                   \
  if (R == RR && x_kind == XF)                                               \
    return (int)launch_ksplit<4, RR, true, kGroupDots, XF>(                  \
        x, qw, sc, sc_bf16, out, rows, din, dout_p, group, splits,           \
        static_cast<float*>(part), static_cast<int*>(counters), s);
    ITT_SLAB_KS(1, kXBf16) ITT_SLAB_KS(2, kXBf16) ITT_SLAB_KS(4, kXBf16)
    ITT_SLAB_KS(1, kXF16) ITT_SLAB_KS(2, kXF16) ITT_SLAB_KS(4, kXF16)
    ITT_SLAB_KS(1, kXF32) ITT_SLAB_KS(2, kXF32) ITT_SLAB_KS(4, kXF32)
#undef ITT_SLAB_KS
    return (int)cudaErrorInvalidValue;
  }
  const int R = rows_per_block(rows, sizeof(float) * din);
  if (group_smem(R, din) > kSmemMax) return (int)cudaErrorInvalidValue;
#define ITT_QMM_SLAB(RR, N, XF)                                               \
  if (R == RR && (bool)has_norm == N && x_kind == XF)                        \
    return (int)launch_group<4, RR, (N ? kRmsNorm : kNoNorm), true,           \
                             kGroupDots, XF>(                                 \
        x, nw, nullptr, true, qw, sc, sc_bf16, nullptr, false, 0, out, rows,  \
        din, dout_p, group, eps, s);
  ITT_QMM_SLAB(1, true, kXBf16) ITT_QMM_SLAB(2, true, kXBf16)
  ITT_QMM_SLAB(4, true, kXBf16)
  ITT_QMM_SLAB(1, false, kXBf16) ITT_QMM_SLAB(2, false, kXBf16)
  ITT_QMM_SLAB(4, false, kXBf16) ITT_QMM_SLAB(1, false, kXF16)
  ITT_QMM_SLAB(2, false, kXF16) ITT_QMM_SLAB(4, false, kXF16)
  ITT_QMM_SLAB(1, false, kXF32) ITT_QMM_SLAB(2, false, kXF32)
  ITT_QMM_SLAB(4, false, kXF32)
#undef ITT_QMM_SLAB
  return (int)cudaErrorInvalidValue;
}
