// The body shared by the port's weight-only group-dot matmul kernels
// (sm_90a): quant_matmul.cu instantiates it as qmm_group / qmm_group_norm
// (and holds qmm_w4a8 / qmm_norm_w4a8), quant_matmul_fused.cu as
// qmm_group_ln, qmm_slab and qmm_slab_norm, quant_matmul_chunk.cu as
// qmm_chunk and qmm_group2d.
//
// Design, kept simple (no wgmma or TMA yet):
//  * a block owns 128 output columns; its 32 lanes each read 4 adjacent
//    columns as one 32-bit load, so a warp reads 128 contiguous bytes of a
//    packed row, and the 16 warps of the block split the work items of
//    the contraction between them (an item is one scale group, or in the
//    split-K form a slice of one); partials meet in shared memory in a
//    fixed order (no atomics, so results repeat bit for bit);
//  * the activation rows (<= 4 per block; more rows take more blocks) sit
//    in shared memory as f32, normalized there first by the prologue, in
//    the TPU kernel's rounding order: RMSNorm = f32 mean of squares,
//    x * 1/sqrt(ms + eps) rounded to bf16, times the bf16 norm weight
//    rounded to bf16; LayerNorm = f32 mean, f32 variance of x - mean,
//    ((x - mean) * 1/sqrt(var + eps)) * gamma + beta all in f32, rounded
//    to bf16 once;
//  * nibbles decode to floats with the 2^23 bit trick (no I2F), the
//    offset-binary low nibble and the signed high nibble both to their
//    exact values, so the per-group partials need no -8*sum(x)
//    correction; the group scale multiplies the f32 partial once per
//    group, as in the TPU kernel. A PAIRED int4 weight has one scale row
//    per packed group (din / (2 * group) rows): both nibble partials of
//    packed group c take s[c];
//  * the LayerNorm form ends as the TPU kernel does: the f32 sum rounded
//    to bf16, plus the bias in f32, rounded again;
//  * XK, the x type (kXBf16, kXF16 or kXF32; common.cuh): the forms
//    without a prologue also take an f16 or f32 x and write x's type, as
//    the TPU kernels take any float x and write x's type; the arithmetic
//    is the same f32 (x is read into f32 as it is).
//
// MODE says where the scale enters and where the sum goes:
//  * kGroupDots: as above (the TPU's _group_dots);
//  * kDequant (the TPU's chunk kernel, _kernel): every weight is scaled
//    in f32 (q * s[g]) and rounded to bf16 BEFORE its product with x, the
//    sum of x * w taken in f32 and rounded to bf16 once at the end;
//  * kSplitK (the TPU's _kernel_group2d): block z covers the packed rows
//    [z * kb, (z + 1) * kb) only, holds only their x columns in shared
//    memory, splits them into work items of `unit` rows (unit divides
//    the group, so that all 16 warps work when kb holds few groups), and
//    writes its f32 partial sums to part[z]; a second pass sums the
//    partials in z order and rounds to bf16 once.
//
// KSPLIT, the split form of a short grid (kGroupDots for qmm_group /
// qmm_slab, kDequant for qmm_chunk, both without a prologue; kGroupDots
// with the LayerNorm prologue for qmm_group_ln). At one row wo and w_down
// (dout 4096) are 32 column tiles: 32 blocks on 132 SMs, each walking all
// of K, so the launch was held by 32 SMs' load rate (GPT-2's w_qkv and
// w_up at one row: 24 and 32).
// Here ns = gridDim.z blocks share one tile of 128 columns and one row
// block and split K between them: block z takes the work items
// [z nu / ns, (z + 1) nu / ns) of nu = packed rows / unit, a work item
// being `unit` packed rows of one scale group (unit divides the group and
// is halved until each block holds about kWarps items, so all 16 warps
// work), and holds only those rows' x columns (lo, then hi for int4) in
// shared memory. The scale enters where MODE says, per work item
// (kGroupDots: the item's f32 partial times its group's scale; kDequant:
// every weight, rounded to bf16 first, as before). A block sums its
// warps' partials in warp order and writes them to part[z]; the last
// block of the tile to arrive (a counter per tile, counters[], which that
// block sets back to 0, so the counters stay zero between launches and
// one buffer serves every launch on a stream) sums part[0 .. ns - 1] in z
// order and writes the tile. With the LayerNorm prologue every block
// takes the row's statistics over all of din (a 2 KB row at GPT-2's
// width, from L2) and normalizes only its own slice of x; the last block
// rounds the sum to bf16 and adds the bias as write_out does. No atomics
// on the values: results repeat bit for bit, in one launch. The split
// count comes from the shapes only (the wrapper's group_splits), so one
// captured graph serves every step.
// A thread-block cluster meeting in distributed shared memory was tried
// first and was slower on the H100: most of the gap was the cluster
// launch itself (PERF.md §6).
#pragma once

#include "common.cuh"

namespace qmm_detail {

constexpr int kLanes = 32;          // 4 columns each -> 128 columns/block
constexpr int kWarps = 16;          // split the work items of K
constexpr int kCols = kLanes * 4;
constexpr int kSmemMax = 232448;    // dynamic shared memory per block

// The prologue run on the activation rows in shared memory.
constexpr int kNoNorm = 0, kRmsNorm = 1, kLayerNorm = 2;
// Where the scale enters and where the sum goes (see above).
constexpr int kGroupDots = 0, kDequant = 1, kSplitK = 2;

// Block-wide reduction of one value per thread (sum or max); every thread
// gets the result. `part` holds kWarps floats.
template <bool MAX>
__device__ float block_reduce(float v, float* part) {
  v = MAX ? warp_max(v) : warp_sum(v);
  if (threadIdx.x == 0) part[threadIdx.y] = v;
  __syncthreads();
  float r = part[0];
  for (int w = 1; w < kWarps; ++w) r = MAX ? fmaxf(r, part[w]) : r + part[w];
  __syncthreads();
  return r;
}

// x [., din] as f32: bf16, f16 or f32 elements (XK).
template <int XK>
__device__ __forceinline__ float load_x(const void* x, size_t i) {
  if (XK == kXF32) return static_cast<const float*>(x)[i];
  if (XK == kXF16) return __half2float(static_cast<const __half*>(x)[i]);
  return bf16_to_f32(static_cast<const __nv_bfloat16*>(x)[i]);
}

// Store f32 v as an element of an output of the type XK.
template <int XK>
__device__ __forceinline__ void store_out(void* out, size_t i, float v) {
  if (XK == kXF32)
    static_cast<float*>(out)[i] = v;
  else if (XK == kXF16)
    static_cast<__half*>(out)[i] = __float2half_rn(v);
  else
    static_cast<__nv_bfloat16*>(out)[i] = __float2bfloat16_rn(v);
}

// Sum the kWarps partial tiles in `red` and write outputs of the type OK
// (kXBf16, kXF16 or kXF32). With BIAS the sum is rounded to bf16 first,
// then bias[n] (bf16 or f32, zero past nbias) is added in f32 and the
// result rounded again. With `part` the f32 sums go to part[blockIdx.z]
// ([rows, dout_p] each) instead.
template <int R, bool BIAS, int OK = kXBf16>
__device__ void write_out(const float* red, const float* row_scale,
                          const void* bias, bool bias_bf16, int nbias,
                          void* out, float* part, int rows, int row0,
                          int nrows, int dout_p) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  for (int o = tid; o < R * kCols; o += kLanes * kWarps) {
    const int r = o / kCols, cc = o % kCols;
    const int n = blockIdx.x * kCols + cc;
    if (r >= nrows || n >= dout_p) continue;
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += red[(w * R + r) * kCols + cc];
    if (row_scale) s *= row_scale[r];
    if (part) {
      part[((size_t)blockIdx.z * rows + row0 + r) * dout_p + n] = s;
      continue;
    }
    if (BIAS) {
      const float b = n < nbias ? load_scale(bias, bias_bf16, n) : 0.f;
      s = __fadd_rn(round_bf16(s), b);
    }
    store_out<OK>(out, (size_t)(row0 + r) * dout_p + n, s);
  }
}

// The LayerNorm statistics of the bf16 row starting at x[xr]: the f32
// mean, then 1/sqrt(var + eps) of the f32 variance of x - mean, reduced
// in the order of a kLanes x kWarps block. Every form that normalizes
// a row with it and layer_norm_value gets the same bits (qmm_group_ln's
// prologue and the pre-pass of its tensor-core form).
__device__ __forceinline__ void layer_norm_stats(const void* x, size_t xr,
                                                 int din, float eps,
                                                 float* rpart, float& mu,
                                                 float& rinv) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int nthr = kLanes * kWarps;
  float sm = 0.f;
  for (int k = tid; k < din; k += nthr) sm += load_x<kXBf16>(x, xr + k);
  mu = block_reduce<false>(sm, rpart) / (float)din;
  float ss = 0.f;
  for (int k = tid; k < din; k += nthr) {
    const float d = load_x<kXBf16>(x, xr + k) - mu;
    ss += d * d;
  }
  const float var = block_reduce<false>(ss, rpart) / (float)din;
  rinv = 1.f / sqrtf(var + eps);
}

// 1/sqrt(ms + eps) of the f32 mean of squares ms of the row starting at
// x[xr] (XK: its type), reduced in the order of a kLanes x kWarps block.
// Every form that normalizes a row with it and rms_norm_value gets the
// same bits (qmm_group_norm's and qmm_norm_w4a8's prologues and the
// pre-pass of qmm_group_norm's tensor-core form).
template <int XK>
__device__ __forceinline__ float rms_norm_rinv(const void* x, size_t xr,
                                               int din, float eps,
                                               float* rpart) {
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  float ss = 0.f;
  for (int k = tid; k < din; k += kLanes * kWarps) {
    const float v = load_x<XK>(x, xr + k);
    ss = fmaf(v, v, ss);
  }
  return 1.f / sqrtf(block_reduce<false>(ss, rpart) / (float)din + eps);
}

// The fused kernels' RMSNorm of one value: v * rinv rounded to bf16, times
// the bf16 weight nw[k], rounded to bf16 again.
__device__ __forceinline__ float rms_norm_value(float v, float rinv,
                                                const __nv_bfloat16* nw,
                                                int k) {
  return round_bf16(round_bf16(v * rinv) * bf16_to_f32(nw[k]));
}

// ((v - mu) * rinv) * gamma[k] + beta[k] in f32, rounded to bf16 once;
// gamma and beta are both bf16 or (norm_bf16 false) both f32.
__device__ __forceinline__ float layer_norm_value(float v, float mu,
                                                  float rinv, const void* nw,
                                                  const void* nb,
                                                  bool norm_bf16, int k) {
  return round_bf16(__fadd_rn(
      __fmul_rn(__fmul_rn(v - mu, rinv), load_scale(nw, norm_bf16, k)),
      load_scale(nb, norm_bf16, k)));
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// The LayerNorm split form's block, before its prologue: ask L2 for the
// 128-byte lines it will read after the row statistics and their
// barriers (its packed weight rows k0 .. k0 + span of columns blockIdx.x
// * kCols + 128, their scale rows, the gamma and beta of its x slice), so
// that their device-memory latency overlaps the statistics instead of
// following them (the forms without a prologue, timed with it on the
// H100, gained nothing).
template <int BITS, bool PAIRED>
__device__ __forceinline__ void prefetch_slice(
    const int8_t* qw, const void* sc, bool sc_bf16, const void* nw,
    const void* nb, bool norm_bf16, int dout_p, int krows, int group, int k0,
    int span, int tid, int nthr) {
  const int col0 = blockIdx.x * kCols;
  const int ssz = sc_bf16 ? 2 : 4;
  const int g0 = k0 / group, ng = (k0 + span - 1) / group - g0 + 1;
  const int sl = (kCols * ssz + 127) / 128;          // lines a scale row
  const int nsc = (BITS == 4 && !PAIRED ? 2 : 1) * ng * sl;
  for (int i = tid; i < span + nsc; i += nthr) {
    if (i < span) {
      prefetch_l2(qw + (size_t)(k0 + i) * dout_p + col0);
    } else {
      const int j = i - span, c = j / sl % ng, h = j / (sl * ng);
      const size_t row = (size_t)(h ? krows / group + g0 + c : g0 + c);
      if (col0 + 128 * (j % sl) / ssz < dout_p)
        prefetch_l2(static_cast<const char*>(sc) + (row * dout_p + col0) * ssz +
                    128 * (j % sl));
    }
  }
  const int nsz = norm_bf16 ? 2 : 4;
  const int nl = (span * nsz + 127) / 128;           // lines a slice
  const int halves = BITS == 4 ? 2 : 1;
  for (int i = tid; i < 2 * halves * nl; i += nthr) {
    const int h = i / (2 * nl), j = i % nl;
    const char* base = static_cast<const char*>(i / nl % 2 ? nb : nw);
    prefetch_l2(base + (size_t)(h * krows + k0) * nsz + 128 * j);
  }
}

// bf16 of the f32 product of a weight value and its scale (kDequant).
__device__ __forceinline__ float scaled_bf16(float v, float s) {
  return round_bf16(__fmul_rn(v, s));
}

// x bf16 [rows, din] (f16 or f32 by XK without a prologue); nw [din]: the
// RMSNorm weight (bf16) or the LayerNorm
// gamma; nb [din]: the LayerNorm beta; gamma and beta are both bf16 or, with
// norm_bf16 false, both f32, and are used in f32 either way; qw int8 [din/2 or din, dout_p];
// sc bf16/f32 [ng, dout_p] (PAIRED: ng = din / (2 * group)); bias bf16/f32
// [nbias] (LayerNorm form only, may be null with nbias 0); out bf16
// [rows, dout_p]. kSplitK only: kb packed rows per block (a multiple of
// group dividing the packed rows), unit rows per work item (dividing
// group), part f32 [krows / kb, rows, dout_p]. KSPLIT only: kb the most
// packed rows a block holds (the row stride of its x slice is kb, 2 kb for
// int4), unit rows per work item (dividing group), part f32 [gridDim.z,
// rows, dout_p], counters int32 [gridDim.x * gridDim.y], zero.
template <int BITS, int R, int PRO, bool PAIRED, int MODE = kGroupDots,
          int XK = kXBf16, bool KSPLIT = false>
__global__ void __launch_bounds__(kLanes * kWarps)
qmm_group_kernel(const void* __restrict__ x,
                 const void* __restrict__ nw, const void* __restrict__ nb,
                 bool norm_bf16,
                 const int8_t* __restrict__ qw, const void* __restrict__ sc,
                 bool sc_bf16, const void* __restrict__ bias, bool bias_bf16,
                 int nbias, void* __restrict__ out, int rows,
                 int din, int dout_p, int group, float eps, int kb, int unit,
                 float* __restrict__ part, int* __restrict__ counters) {
  static_assert(MODE != kSplitK || PRO == kNoNorm, "split-K has no prologue");
  static_assert(XK == kXBf16 || PRO == kNoNorm,
                "only a bf16 x takes a prologue");
  static_assert(!KSPLIT || (PRO != kRmsNorm && MODE != kSplitK),
                "the split form takes no RMSNorm prologue");
  constexpr bool SLICE = MODE == kSplitK || KSPLIT;    // a slice of K
  extern __shared__ float smem[];
  const int krows = BITS == 4 ? din / 2 : din;   // stored (packed) rows
  // this block's packed rows [k0, k0 + span), and the x columns it holds
  // per row: all of them, or (a slice) lo then hi of its rows only, in a
  // row of xw floats
  int k0 = 0, span = krows;
  if (MODE == kSplitK) {
    k0 = blockIdx.z * kb;
    span = kb;
  }
  if (KSPLIT) {
    const int nu = krows / unit, ns = gridDim.z;
    const int u0 = (int)((long long)blockIdx.z * nu / ns);
    k0 = u0 * unit;
    span = (int)((long long)(blockIdx.z + 1) * nu / ns) * unit - k0;
  }
  const int xw = SLICE ? (BITS == 4 ? 2 * kb : kb) : din;
  const int xload = SLICE ? (BITS == 4 ? 2 * span : span) : din;
  float* xs = smem;                       // [R][xw]
  float* red = smem + R * xw;             // [kWarps][R][kCols]
  __shared__ float rpart[kWarps];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane, nthr = kLanes * kWarps;
  const int row0 = blockIdx.y * R;
  const int nrows = min(R, rows - row0);
  if constexpr (KSPLIT && PRO == kLayerNorm)
    prefetch_slice<BITS, PAIRED>(qw, sc, sc_bf16, nw, nb, norm_bf16, dout_p,
                                 krows, group, k0, span, tid, nthr);

  for (int r = 0; r < R; ++r) {
    const size_t xr = (size_t)(row0 + r) * din;    // the row's first x
    if (r >= nrows) {
      for (int k = tid; k < xw; k += nthr) xs[r * xw + k] = 0.f;
      continue;
    }
    float rinv = 1.f, mu = 0.f;
    if (PRO == kRmsNorm) rinv = rms_norm_rinv<XK>(x, xr, din, eps, rpart);
    if (PRO == kLayerNorm) layer_norm_stats(x, xr, din, eps, rpart, mu, rinv);
    for (int k = tid; k < xload; k += nthr) {
      const int src = !SLICE    ? k
                      : k < span ? k0 + k
                                 : krows + k0 + (k - span);
      float v = load_x<XK>(x, xr + src);
      if (PRO == kRmsNorm)
        v = rms_norm_value(v, rinv, static_cast<const __nv_bfloat16*>(nw),
                           src);
      if (PRO == kLayerNorm)
        v = layer_norm_value(v, mu, rinv, nw, nb, norm_bf16, src);
      xs[r * xw + k] = v;
    }
  }
  __syncthreads();

  const int col = blockIdx.x * kCols + lane * 4;
  const int ngs = krows / group;                 // stored groups
  const int urows = SLICE ? unit : group;
  const int items = span / urows;
  float acc[R][4];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  if (col < dout_p) {
    for (int it = warp; it < items; it += kWarps) {
      const int p0 = k0 + it * urows;              // its first packed row
      const int c = SLICE ? p0 / group : it;   // its scale group
      float s_lo[4], s_hi[4];
      auto load_scales = [&]() {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s_lo[j] = load_scale(sc, sc_bf16, (size_t)c * dout_p + col + j);
          s_hi[j] = BITS != 4 ? 0.f
                    : PAIRED  ? s_lo[j]
                              : load_scale(sc, sc_bf16,
                                           (size_t)(ngs + c) * dout_p + col + j);
        }
      };
      // kDequant: each weight needs its scale; the split form (few items
      // a warp) issues the scale loads with the weight loads
      if (MODE == kDequant || KSPLIT) load_scales();
      float pl[R][4], ph[R][4];
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int j = 0; j < 4; ++j) pl[r][j] = ph[r][j] = 0.f;
      const int8_t* qp = qw + (size_t)p0 * dout_p + col;
#pragma unroll 16
      for (int i = 0; i < urows; ++i) {
        const uint32_t w =
            __ldg(reinterpret_cast<const uint32_t*>(qp + (size_t)i * dout_p));
        const int k = p0 - k0 + i;                 // its x column in xs
        float wl[4], wh[4];                        // this row's 4 columns
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wl[j] = BITS == 4 ? nib_lo(w, 8 * j) : i8_val(w, 8 * j);
          wh[j] = BITS == 4 ? nib_hi(w, 8 * j + 4) : 0.f;
          if (MODE == kDequant) {
            wl[j] = scaled_bf16(wl[j], s_lo[j]);
            wh[j] = scaled_bf16(wh[j], s_hi[j]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float xl = xs[r * xw + k];
#pragma unroll
          for (int j = 0; j < 4; ++j) pl[r][j] = fmaf(xl, wl[j], pl[r][j]);
          if (BITS == 4) {
            const float xh = xs[r * xw + span + k];
#pragma unroll
            for (int j = 0; j < 4; ++j) ph[r][j] = fmaf(xh, wh[j], ph[r][j]);
          }
        }
      }
      if (MODE != kDequant && !KSPLIT) load_scales();   // one multiply per partial
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int r = 0; r < R; ++r)
          acc[r][j] += MODE == kDequant ? pl[r][j] + ph[r][j]
                       : BITS == 4      ? pl[r][j] * s_lo[j] + ph[r][j] * s_hi[j]
                                        : pl[r][j] * s_lo[j];
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      red[(warp * R + r) * kCols + lane * 4 + j] = acc[r][j];
  __syncthreads();
  if constexpr (KSPLIT) {
    // this block's sum over its warps to part[z]; the tile's last block
    // to arrive sums the blocks' partials in z order
    const int ns = gridDim.z;
    for (int o = tid; o < R * kCols; o += nthr) {
      const int r = o / kCols, cc = o % kCols, n = blockIdx.x * kCols + cc;
      float s = 0.f;
      for (int w = 0; w < kWarps; ++w) s += red[(w * R + r) * kCols + cc];
      if (r < nrows && n < dout_p)
        part[((size_t)blockIdx.z * rows + row0 + r) * dout_p + n] = s;
    }
    __threadfence();
    __syncthreads();
    __shared__ bool last;
    int* count = counters + blockIdx.y * gridDim.x + blockIdx.x;
    if (tid == 0) last = atomicAdd(count, 1) == ns - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int o = tid; o < R * kCols; o += nthr) {
      const int r = o / kCols, n = blockIdx.x * kCols + o % kCols;
      if (r >= nrows || n >= dout_p) continue;
      float s = 0.f;
      for (int z = 0; z < ns; ++z)
        s += __ldcg(part + ((size_t)z * rows + row0 + r) * dout_p + n);
      if (PRO == kLayerNorm) {   // as write_out: bf16, + bias in f32
        const float b = n < nbias ? load_scale(bias, bias_bf16, n) : 0.f;
        s = __fadd_rn(round_bf16(s), b);
      }
      store_out<XK>(out, (size_t)(row0 + r) * dout_p + n, s);
    }
    if (tid == 0) *count = 0;
  } else {
    write_out<R, PRO == kLayerNorm, XK>(red, nullptr, bias, bias_bf16, nbias,
                                        out, MODE == kSplitK ? part : nullptr,
                                        rows, row0, nrows, dout_p);
  }
}

// Shared memory of a block holding R activation rows of xw floats each.
inline size_t group_smem(int R, int xw) {
  return sizeof(float) * ((size_t)R * xw + (size_t)kWarps * R * kCols);
}

template <int BITS, int R, int PRO, bool PAIRED, int MODE = kGroupDots,
          int XK = kXBf16>
cudaError_t launch_group(const void* x, const void* nw, const void* nb,
                         bool norm_bf16, const void* qw, const void* sc, bool sc_bf16,
                         const void* bias, bool bias_bf16, int nbias,
                         void* out, int rows, int din, int dout_p, int group,
                         float eps, cudaStream_t stream, int kb = 0,
                         int unit = 0, float* part = nullptr) {
  static SmemGrant granted;
  auto kernel = qmm_group_kernel<BITS, R, PRO, PAIRED, MODE, XK>;
  const int krows = BITS == 4 ? din / 2 : din;
  const int xw = MODE == kSplitK ? (BITS == 4 ? 2 * kb : kb) : din;
  const size_t smem = group_smem(R, xw);
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  dim3 grid((dout_p + kCols - 1) / kCols, (rows + R - 1) / R,
            MODE == kSplitK ? krows / kb : 1);
  kernel<<<grid, dim3(kLanes, kWarps), smem, stream>>>(
      x, nw, nb, norm_bf16, static_cast<const int8_t*>(qw), sc,
      sc_bf16, bias, bias_bf16, nbias, out, rows,
      din, dout_p, group, eps, kb, unit, part, nullptr);
  return cudaGetLastError();
}

// The split form of a launch without a prologue or (PRO = kLayerNorm,
// with gamma nw, beta nb, the bias and eps as for the unsplit form) with
// the LayerNorm one: ns blocks (2 to 64) split the packed rows of each
// 128-column tile and row block; see KSPLIT above. R rows per block (1, 2
// or 4); unit rows per work item, halved from the group (while a multiple
// of 16) until a block holds kWarps items. part f32 [ns, rows, dout_p] is
// scratch; counters int32 [tiles * row blocks] must be zero, and are zero
// again after the launch.
template <int BITS, int R, bool PAIRED, int MODE, int XK, int PRO = kNoNorm>
cudaError_t launch_ksplit(const void* x, const void* qw, const void* sc,
                          bool sc_bf16, void* out, int rows, int din,
                          int dout_p, int group, int ns, float* part,
                          int* counters, cudaStream_t stream,
                          const void* nw = nullptr, const void* nb = nullptr,
                          bool norm_bf16 = true, const void* bias = nullptr,
                          bool bias_bf16 = false, int nbias = 0,
                          float eps = 0.f) {
  static SmemGrant granted;
  auto kernel = qmm_group_kernel<BITS, R, PRO, PAIRED, MODE, XK, true>;
  const int krows = BITS == 4 ? din / 2 : din;
  if (ns < 2 || ns > 64 || group <= 0 || krows % group || krows / group < ns ||
      !part || !counters)
    return cudaErrorInvalidValue;
  int unit = group;
  while (unit % 16 == 0 && krows / unit / ns < kWarps) unit /= 2;
  const int kb = (krows / unit + ns - 1) / ns * unit;   // most rows a block holds
  const int xw = BITS == 4 ? 2 * kb : kb;
  const size_t smem = group_smem(R, xw);
  if (smem > kSmemMax) return cudaErrorInvalidValue;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  dim3 grid((dout_p + kCols - 1) / kCols, (rows + R - 1) / R, ns);
  kernel<<<grid, dim3(kLanes, kWarps), smem, stream>>>(
      x, nw, nb, norm_bf16, static_cast<const int8_t*>(qw), sc, sc_bf16,
      bias, bias_bf16, nbias, out, rows, din, dout_p, group, eps, kb, unit,
      part, counters);
  return cudaGetLastError();
}

// Rows per block of the split form: up to 4.
inline int ksplit_rows(int rows) { return rows >= 4 ? 4 : rows >= 2 ? 2 : 1; }

// Rows per block: up to 4, fewer when the activation tile would not fit.
inline int rows_per_block(int rows, size_t bytes_per_row) {
  int r = rows >= 4 ? 4 : rows >= 2 ? 2 : 1;
  while (r > 1 && r * bytes_per_row + sizeof(float) * kWarps * r * kCols > kSmemMax)
    r /= 2;
  return r;
}

}  // namespace qmm_detail
