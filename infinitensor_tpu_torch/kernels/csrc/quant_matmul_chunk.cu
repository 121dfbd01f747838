// The chunk (dequantize-then-dot) and the split-K weight-only matmuls,
// hand-written for Hopper (sm_90a) over the group-dot body of
// quant_matmul.cuh. Python wrappers: kernels/quant_matmul.py.
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/quant_matmul.py:
//   qmm_chunk    <- _kernel         (:44, via quant_matmul :721-723)
//   qmm_group2d  <- _kernel_group2d (:404, via quant_matmul_2d :468-508)
//
// qmm_chunk is the route for a scale group that is no multiple of 128
// (Llama at group 64, as __graft_entry__.entry() quantizes it) and for
// variant "chunk". Its rounding point is the TPU kernel's: each weight is
// its exact value times its group's scale in f32, rounded to bf16, and
// only then multiplied by x (body MODE kDequant). What bounds it here: at
// one row, the packed weights and the scale rows over device-memory
// bandwidth (group 64 doubles the scale rows: +104 MB over a 7B decode
// step's 3.68 GB at group 128), but the scale multiply and the bf16
// rounding of every weight cost ~3 more instructions per weight than the
// group-dot form, so at a few rows it is closer to instruction-bound. On a
// short grid (wo and w_down at 1-8 rows: 32 column tiles) it takes the K
// split of quant_matmul.cuh (KSPLIT), one launch, as qmm_group does.
//
// qmm_group2d is the group dots of qmm_group split along K: grid (column
// tiles of 128, row blocks, krows / kb), block z covering the packed rows
// [z * kb, (z + 1) * kb) (for int4 the x_hi columns start at
// din / 2 + z * kb), writing f32 partials to a workspace; a second kernel
// sums the partials in z order and rounds to bf16 once, so the result
// repeats bit for bit (no atomics). It is for the short grids of
// wo (32 column tiles) and w_down on 132 SMs: with kb = 256 wo runs 256
// blocks instead of 32. The TPU kernel carried its f32 sum in scratch
// across the sequential k steps of its grid; here the splits run in
// parallel and the second pass takes that sum's place. Bound: the weights
// and scales over device-memory bandwidth, plus the workspace written and
// read once (0.7 MB at w_down with kb = 128).
#include "quant_matmul.cuh"

using namespace qmm_detail;

namespace {

// out[i] = the sum over z of part[z][i], z in order, as the type OK.
template <int OK>
__global__ void splitk_sum(const float* __restrict__ part, int nsplit,
                           size_t n, void* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < nsplit; ++z) s += part[z * n + i];
    store_out<OK>(out, i, s);
  }
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// x [rows, din] bf16, f16 or f32 (x_kind, common.cuh); qw int8 [din/2 or
// din, dout_p] (unpaired); sc bf16/f32 [ng, dout_p]; out [rows, dout_p] in
// x's type; any group dividing the packed rows. splits > 1: the split
// form of quant_matmul.cuh (the rounding point stays per weight), with
// part and counters as for qmm_group.
ITT_EXPORT int qmm_chunk(const void* x, int x_kind, const void* qw,
                         const void* sc, int sc_bf16, void* out, int rows,
                         int din, int dout_p, int bits, int group, int splits,
                         void* part, void* counters, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int krows = bits == 4 ? din / 2 : din;
  if (group <= 0 || krows % group) return (int)cudaErrorInvalidValue;
  if (splits > 1) {
    const int R = ksplit_rows(rows);
#define ITT_CHUNK_KS(B, RR, XF)                                               \
  if (bits == B && R == RR && x_kind == XF)                                  \
    return (int)launch_ksplit<B, RR, false, kDequant, XF>(                   \
        x, qw, sc, sc_bf16, out, rows, din, dout_p, group, splits,           \
        static_cast<float*>(part), static_cast<int*>(counters), s);
#define ITT_CHUNK_KS_X(XF)                                                    \
  ITT_CHUNK_KS(4, 1, XF) ITT_CHUNK_KS(4, 2, XF) ITT_CHUNK_KS(4, 4, XF)        \
  ITT_CHUNK_KS(8, 1, XF) ITT_CHUNK_KS(8, 2, XF) ITT_CHUNK_KS(8, 4, XF)
    ITT_CHUNK_KS_X(kXBf16) ITT_CHUNK_KS_X(kXF16) ITT_CHUNK_KS_X(kXF32)
#undef ITT_CHUNK_KS_X
#undef ITT_CHUNK_KS
    return (int)cudaErrorInvalidValue;
  }
  const int R = rows_per_block(rows, sizeof(float) * din);
  if (group_smem(R, din) > kSmemMax) return (int)cudaErrorInvalidValue;
#define ITT_CHUNK(B, RR, XF)                                                  \
  if (bits == B && R == RR && x_kind == XF)                                  \
    return (int)launch_group<B, RR, kNoNorm, false, kDequant, XF>(            \
        x, nullptr, nullptr, true, qw, sc, sc_bf16, nullptr, false, 0, out,   \
        rows, din, dout_p, group, 0.f, s);
#define ITT_CHUNK_X(XF)                                                       \
  ITT_CHUNK(4, 1, XF) ITT_CHUNK(4, 2, XF) ITT_CHUNK(4, 4, XF)                 \
  ITT_CHUNK(8, 1, XF) ITT_CHUNK(8, 2, XF) ITT_CHUNK(8, 4, XF)
  ITT_CHUNK_X(kXBf16) ITT_CHUNK_X(kXF16) ITT_CHUNK_X(kXF32)
#undef ITT_CHUNK_X
#undef ITT_CHUNK
  return (int)cudaErrorInvalidValue;
}

// As qmm_group without the norm, split along K into krows / kb blocks of
// kb packed rows (kb a multiple of group dividing the packed rows). part
// f32 [krows / kb, rows, dout_p] is scratch.
ITT_EXPORT int qmm_group2d(const void* x, int x_kind, const void* qw,
                           const void* sc, int sc_bf16, void* part, void* out,
                           int rows, int din, int dout_p, int bits, int group,
                           int kb, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int krows = bits == 4 ? din / 2 : din;
  if (group <= 0 || kb <= 0 || kb % group || krows % kb)
    return (int)cudaErrorInvalidValue;
  // rows per work item: halve the group until every warp has an item
  int unit = group;
  while (unit % 16 == 0 && kb / unit < kWarps) unit /= 2;
  const int xw = bits == 4 ? 2 * kb : kb;
  const int R = rows_per_block(rows, sizeof(float) * xw);
  if (group_smem(R, xw) > kSmemMax) return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
  cudaError_t e = cudaErrorInvalidValue;
#define ITT_2D(B, RR, XF)                                                     \
  if (bits == B && R == RR && x_kind == XF)                                  \
    e = launch_group<B, RR, kNoNorm, false, kSplitK, XF>(                     \
        x, nullptr, nullptr, true, qw, sc, sc_bf16, nullptr, false, 0,        \
        nullptr, rows, din, dout_p, group, 0.f, s, kb, unit, p);
#define ITT_2D_X(XF)                                                          \
  ITT_2D(4, 1, XF) ITT_2D(4, 2, XF) ITT_2D(4, 4, XF)                          \
  ITT_2D(8, 1, XF) ITT_2D(8, 2, XF) ITT_2D(8, 4, XF)
  ITT_2D_X(kXBf16) ITT_2D_X(kXF16) ITT_2D_X(kXF32)
#undef ITT_2D_X
#undef ITT_2D
  if (e != cudaSuccess) return (int)e;
  const size_t n = (size_t)rows * dout_p;
  const int threads = 256;
  const int blocks = (int)((n + threads - 1) / threads < 1024
                               ? (n + threads - 1) / threads : 1024);
  if (x_kind == kXF32)
    splitk_sum<kXF32><<<blocks, threads, 0, s>>>(p, krows / kb, n, out);
  else if (x_kind == kXF16)
    splitk_sum<kXF16><<<blocks, threads, 0, s>>>(p, krows / kb, n, out);
  else
    splitk_sum<kXBf16><<<blocks, threads, 0, s>>>(p, krows / kb, n, out);
  return (int)cudaGetLastError();
}
