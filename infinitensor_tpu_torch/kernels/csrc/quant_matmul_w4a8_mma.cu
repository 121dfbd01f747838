// qmm_w4a8 on Hopper's int8 tensor cores (sm_90a): the W4A8 / W8A8
// group-dot matmul for 2 to 256 activation rows of bf16 or f32, with
// mma.sync m16n8k32 (s8 x s8 -> s32) fed by the cp.async ring of
// mma_tile.cuh, and the same with the RMSNorm ahead (qmm_norm_w4a8, bf16
// x). Python wrapper: kernels/quant_matmul.py (_launch_w4a8, form "mma";
// w4a8_form says when a launch takes it, mma_plan its tile and split).
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/quant_matmul.py:
//   qmm_w4a8_mma       <- _kernel_group_w4a8 (:283; _quantize_rows_i8 :217,
//                         _group_dots_w4a8 :229)
//   qmm_norm_w4a8_mma  <- _kernel_group_norm_w4a8 (:288, via
//                         quant_matmul_norm; a bf16 x)
// The first computes what qmm_w4a8_plain computes: each row quantized to int8
// (sx = max(amax, 1e-30) * f32(1/127), xq = clip(rint(x / sx), +-127),
// a true IEEE division, round half to even), exact int32 dots per scale
// group, each group folded once into an f32 accumulator with its scales,
// the accumulator times sx once at the end, rounded once to x's type.
// The second computes qmm_norm_w4a8_plain: the RMSNorm folded into the
// quantize pre-pass (w4a8_norm_quantize_rows: rms_norm_rinv over the raw
// row, then the amax and the quantize of rms_norm_value of each element,
// recomputed for each, as qmm_norm_w4a8's CUDA-core prologue does in
// quant_matmul.cu, in the same reduction order, so xq and sx equal that
// prologue's bit for bit), then this tile as it is.
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 1,979 TOPS int8):
// the Llama lm_head (4096 -> 32000, int4, bf16 scales) at 256 rows is
// 67.1 G int8 ops, 0.0339 ms at the peak; at 8 rows its 67.6 MB of
// weights and scales, 0.0203 ms of device memory.
//
// The design:
//  * the quantize is a pre-pass (w4a8_quantize_rows, one block a row):
//    the row max needs the whole row, and a dot block that quantized all
//    of its rows again (as the TPU kernel and the CUDA-core form do)
//    would re-read up to 2 MB of x per block at 256 rows; it writes xq
//    int8 [rows, din] and sx f32 [rows], and the result is the same;
//  * swap-AB as in quant_matmul_mma.cu: M = 16 output columns, N = 8
//    activation rows, the same fragment-row permutation (a lane's 4
//    adjacent columns of a packed row are one 32-bit word; its C
//    fragment holds 4 adjacent output columns of 2 rows);
//  * an s8 A register holds 4 consecutive K of one column, while memory
//    holds 4 consecutive columns of one packed row: a lane reads rows
//    4t .. 4t + 3 (and 4t + 16 ..) of its column word and transposes the
//    4 x 4 bytes with 8 byte permutes (common.cuh transpose_bytes; ldmatrix
//    has no .trans for 8-bit data). The weight tile's rows with bit 3 set
//    are staged 32 bytes over (mma_tile.cuh wcol), so those reads hit 32
//    distinct banks. xq's B fragments (K contiguous per row) come from
//    ldmatrix on b16 pairs, as the 16-bit tile's do;
//  * the nibbles decode in two integer operations a word, both halves to
//    16 times their signed value: (b & 0xF0) read as a signed byte is 16
//    hi (the TPU kernel's operand), and ((b << 4) & 0xF0) ^ 0x80 is 16 lo
//    (the offset-binary low nibble lo + 8 shifted up, minus 128). So no
//    -8 * sum(xq_lo) correction is needed, and the group's scales are
//    taken / 16: (16 p) * (s / 16) is p * s exactly in f32, the TPU
//    kernel's (pd_lo - 8 sum) * s_lo + pd_hi * (s_hi / 16) to the bit
//    (|16 p| < 2^24: exact in f32 up to groups of 1024). int8 weights are
//    one dot a group, their bytes as they lie;
//  * the per-group s32 partials sit in fragments of their own (one per
//    nibble half), folded into the f32 accumulator once per group.
//  * the block shape, split-K by whole scale groups and the fixed-order
//    second pass (no atomics: results repeat bit for bit) are
//    qmm_group_mma's, and so is quant_matmul.py's mma_plan, which picks
//    tile and split;
//  * row tiles are the grid's fastest dimension, so the blocks that share
//    a column block's weights run together and read them from device
//    memory once (the lm_head's 67 MB does not fit the 50 MB L2: with
//    column blocks first, each row tile of a 256-row call read it again).
// What still holds it back (PERF.md §6-7): at 1-8 rows it streams the
// lm_head's weights at 1.2-1.4 TB/s (qmm_group_mma's tile: about 1.0),
// where the CUDA-core form reaches 1.55 at one row; a ring of 6 stages,
// K split in 4, scales staged through the ring and I2F-free folds were
// each no faster on the card. At 256 rows the 64-row tile takes 255
// registers (2 blocks, 8 warps an SM) and reaches about 230 TOPS, 12 %
// of the int8 peak.
#include "mma_tile.cuh"
#include "quant_matmul.cuh"

namespace {

using namespace mma_tile;

constexpr int kXStride = kBK + 16;   // bytes per staged xq row (80)
constexpr int kQThreads = 256;       // threads of the quantize pre-pass

// xq[r] = clip(rint(x[r] / sx[r]), +-127), sx[r] = max(amax, 1e-30) *
// f32(1/127) for row r = blockIdx.x of x [rows, din] (XK: bf16 or f32).
template <int XK>
__global__ void __launch_bounds__(kQThreads)
w4a8_quantize_rows(const void* __restrict__ x, int din,
                   int8_t* __restrict__ xq, float* __restrict__ sx) {
  __shared__ float part[kQThreads / 32];
  const size_t xr = (size_t)blockIdx.x * din;
  float amax = 0.f;
  for (int k = threadIdx.x; k < din; k += kQThreads)
    amax = fmaxf(amax, fabsf(qmm_detail::load_x<XK>(x, xr + k)));
  amax = warp_max(amax);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = amax;
  __syncthreads();
  amax = part[0];
  for (int w = 1; w < kQThreads / 32; ++w) amax = fmaxf(amax, part[w]);
  const float s = qmm_detail::w4a8_row_scale(amax);
  for (int k = threadIdx.x; k < din; k += kQThreads)
    xq[xr + k] = qmm_detail::w4a8_code(qmm_detail::load_x<XK>(x, xr + k), s);
  if (threadIdx.x == 0) sx[blockIdx.x] = s;
}

// As w4a8_quantize_rows, on the row normalized as the CUDA-core
// prologue of qmm_norm_w4a8 normalizes it (x bf16; nw bf16 [din]; block:
// qmm_detail's kLanes x kWarps threads, that prologue's reduction order).
__global__ void __launch_bounds__(qmm_detail::kLanes * qmm_detail::kWarps)
w4a8_norm_quantize_rows(const void* __restrict__ x,
                        const __nv_bfloat16* __restrict__ nw, float eps,
                        int din, int8_t* __restrict__ xq,
                        float* __restrict__ sx) {
  namespace qd = qmm_detail;
  __shared__ float part[qd::kWarps];
  const int tid = threadIdx.y * qd::kLanes + threadIdx.x;
  const int nthr = qd::kLanes * qd::kWarps;
  const size_t xr = (size_t)blockIdx.x * din;
  const float rinv = qd::rms_norm_rinv<kXBf16>(x, xr, din, eps, part);
  auto xn = [&](int k) {
    return qd::rms_norm_value(qd::load_x<kXBf16>(x, xr + k), rinv, nw, k);
  };
  float amax = 0.f;
  for (int k = tid; k < din; k += nthr) amax = fmaxf(amax, fabsf(xn(k)));
  const float s = qd::w4a8_row_scale(qd::block_reduce<true>(amax, part));
  for (int k = tid; k < din; k += nthr) xq[xr + k] = qd::w4a8_code(xn(k), s);
  if (tid == 0) sx[blockIdx.x] = s;
}

// d += a * b on the int8 tensor cores, s32 sums.
__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// xq int8 [rows, din], sx f32 [rows] (the pre-pass); qw int8 [krows,
// dout_p] (split-half int4 or int8, unpaired); sc bf16/f32 [ngs (int4: 2
// ngs), dout_p]; out [rows, dout_p] of the type XK (bf16 or f32) = acc *
// sx, or with splits > 1 part f32 [splits, rows, dout_p] = acc. Block
// (bx, by, bz): rows [bx * BR, +BR), columns [by * kBN, +kBN), scale
// groups as in qmm_group_mma_kernel; warps as there.
template <int BITS, int XK, int NT>
__device__ __forceinline__ void w4a8_mma_tile(
    const int8_t* __restrict__ xq, const float* __restrict__ sx,
    const int8_t* __restrict__ qw, const void* __restrict__ sc, bool sc_bf16,
    void* __restrict__ out, float* __restrict__ part, int rows, int din,
    int dout_p, int group, int splits) {
  constexpr int BR = 8 * NT;                      // rows per block
  constexpr int kHalves = BITS == 4 ? 2 : 1;      // xq tiles: lo (and hi)
  constexpr int kWBytes = kBK * kWStride;
  constexpr int kXBytes = BR * kXStride;
  constexpr int kStage = kWBytes + kHalves * kXBytes;
  extern __shared__ __align__(16) uint8_t w4a8_smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int krows = BITS == 4 ? din / 2 : din;
  const int ngs = krows / group;
  const int row0 = blockIdx.x * BR, col0 = blockIdx.y * kBN;
  const int c0 = (int)((long long)blockIdx.z * ngs / splits);
  const int c1 = (int)((long long)(blockIdx.z + 1) * ngs / splits);
  const int p0 = c0 * group;
  const int nst = (c1 - c0) * group / kBK;

  // Stage st of this block (packed rows p0 + st * kBK ...) into ring slot.
  auto load_stage = [&](int slot, int st) {
    uint8_t* base = w4a8_smem + slot * kStage;
    const int p = p0 + st * kBK;
    load_weight_tile<true>(base, qw, p, col0, dout_p);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      uint8_t* xs = base + kWBytes + h * kXBytes;
      const int k0 = h * krows + p;             // the half's first xq column
      for (int i = threadIdx.x; i < BR * (kBK / 16); i += kThreads) {
        const int r = i / (kBK / 16), c = (i % (kBK / 16)) * 16;
        const bool ok = row0 + r < rows;
        cp_async16(xs + r * kXStride + c,
                   ok ? xq + (size_t)(row0 + r) * din + k0 + c : xq,
                   ok ? 16 : 0);
      }
    }
  };

  float acc[2][NT][4];
  int plo[2][NT][4], phi[2][NT][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[f][j][e] = 0.f;
        plo[f][j][e] = phi[f][j][e] = 0;
      }
  const int wc = warp * 32 + 4 * g;              // the lane's column word
  const int ncol = col0 + wc;                    // its 4 output columns
  float s_lo[4] = {0.f, 0.f, 0.f, 0.f}, s_hi[4] = {0.f, 0.f, 0.f, 0.f};

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nst) load_stage(s, s);
    cp_async_commit();
  }
  for (int st = 0; st < nst; ++st) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (st + kStages - 1 < nst)
      load_stage((st + kStages - 1) % kStages, st + kStages - 1);
    cp_async_commit();
    const int p = p0 + st * kBK;
    if (p % group == 0 && ncol < dout_p) {     // a group starts: its scales
      const int c = p / group;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (BITS == 4) {                       // partials are 16 x the dot
          s_lo[j] = load_scale(sc, sc_bf16, (size_t)c * dout_p + ncol + j)
                    * 0.0625f;
          s_hi[j] = load_scale(sc, sc_bf16,
                               (size_t)(ngs + c) * dout_p + ncol + j)
                    * 0.0625f;
        } else {
          s_lo[j] = load_scale(sc, sc_bf16, (size_t)c * dout_p + ncol + j);
        }
      }
    }
    const uint8_t* base = w4a8_smem + (st % kStages) * kStage;
    const uint32_t xb = smem_addr(base + kWBytes);
#pragma unroll
    for (int ks = 0; ks < kBK / 32; ++ks) {
      // cw[kk][j]: column wc + j of packed rows ks * 32 + 16 kk + 4t .. + 3
      uint32_t cw[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = ks * 32 + kk * 16 + 4 * t + i;
          w[i] = *reinterpret_cast<const uint32_t*>(
              base + r * kWStride + wcol<true>(r, wc));
        }
        transpose_bytes(w, cw[kk]);
      }
      // A fragments of M-tiles f = 0, 1: registers {m g, k 4t..},
      // {m g + 8, k 4t..}, {m g, k 4t + 16..}, {m g + 8, k 4t + 16..}; row
      // g of tile f is column wc + 2f, row g + 8 column wc + 2f + 1
      uint32_t alo[2][4], ahi[2][4];
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const uint32_t v = cw[e >> 1][2 * f + (e & 1)];
          if (BITS == 4) {
            alo[f][e] = ((v << 4) & 0xF0F0F0F0u) ^ 0x80808080u;   // 16 lo
            ahi[f][e] = v & 0xF0F0F0F0u;                          // 16 hi
          } else {
            alo[f][e] = v;
          }
        }
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        // B fragments: xq rows of the warp's n-tiles, k bytes ks * 32 ..
        const uint32_t xs = xb + h * kXBytes + ks * 32 + ((lane & 8) << 1);
#pragma unroll
        for (int j = 0; j < NT; j += 2) {
          uint32_t b[4];
          // x4: lanes 16-31 address n-tile j + 1 (x2: lanes 0-15 only)
          const int r = j * 8 + (lane & 7) + (NT > 1 ? (lane & 16) >> 1 : 0);
          if (NT > 1)
            ldsm_x4(b, xs + r * kXStride);
          else
            ldsm_x2(b, xs + r * kXStride);
#pragma unroll
          for (int jj = 0; jj < 2 && j + jj < NT; ++jj)
#pragma unroll
            for (int f = 0; f < 2; ++f) {
              if (BITS == 4 && h == 1)
                mma_s8(phi[f][j + jj], ahi[f], b[2 * jj], b[2 * jj + 1]);
              else
                mma_s8(plo[f][j + jj], alo[f], b[2 * jj], b[2 * jj + 1]);
            }
        }
      }
    }
    if ((p + kBK) % group == 0) {              // a group ends: fold it
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // C element e: column wc + 2f + e / 2, row 2t + e % 2
            const int sj = 2 * f + e / 2;
            acc[f][j][e] += BITS == 4
                ? (float)plo[f][j][e] * s_lo[sj]
                      + (float)phi[f][j][e] * s_hi[sj]
                : (float)plo[f][j][e] * s_lo[sj];
            plo[f][j][e] = phi[f][j][e] = 0;
          }
    }
  }

  if (ncol >= dout_p) return;
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {          // rows 2t, 2t + 1 of n-tile j
      const int r = row0 + j * 8 + 2 * t + e;
      if (r >= rows) continue;
      // columns ncol .. ncol + 3: (f 0, m g), (f 0, m g+8), (f 1, m g), ...
      const float v0 = acc[0][j][e], v1 = acc[0][j][2 + e];
      const float v2 = acc[1][j][e], v3 = acc[1][j][2 + e];
      if (splits > 1) {
        *reinterpret_cast<float4*>(
            part + ((size_t)blockIdx.z * rows + r) * dout_p + ncol) =
            make_float4(v0, v1, v2, v3);
      } else {
        const float s = sx[r];
        store4<XK>(out, (size_t)r * dout_p + ncol, v0 * s, v1 * s, v2 * s,
                   v3 * s);
      }
    }
}

template <int BITS, int XK, int NT>
__global__ void __launch_bounds__(kThreads)
qmm_w4a8_mma_kernel(const int8_t* __restrict__ xq,
                    const float* __restrict__ sx,
                    const int8_t* __restrict__ qw,
                    const void* __restrict__ sc, bool sc_bf16,
                    void* __restrict__ out, float* __restrict__ part,
                    int rows, int din, int dout_p, int group, int splits) {
  w4a8_mma_tile<BITS, XK, NT>(xq, sx, qw, sc, sc_bf16, out, part, rows, din,
                              dout_p, group, splits);
}

// The tile of the RMSNorm form (a kernel of its own name, so that a
// profile gives its time to qmm_norm_w4a8): xq, sx of the normalized rows.
template <int BITS, int NT>
__global__ void __launch_bounds__(kThreads)
qmm_norm_w4a8_mma_kernel(const int8_t* __restrict__ xq,
                         const float* __restrict__ sx,
                         const int8_t* __restrict__ qw,
                         const void* __restrict__ sc, bool sc_bf16,
                         void* __restrict__ out, float* __restrict__ part,
                         int rows, int din, int dout_p, int group,
                         int splits) {
  w4a8_mma_tile<BITS, kXBf16, NT>(xq, sx, qw, sc, sc_bf16, out, part, rows,
                                  din, dout_p, group, splits);
}

// out[i] = (the sum over z of part[z][i], z in order) * sx[row of i],
// rounded to XK.
template <int XK>
__global__ void w4a8_splitk_sum(const float* __restrict__ part, int splits,
                                size_t n, int dout_p,
                                const float* __restrict__ sx,
                                void* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    qmm_detail::store_out<XK>(out, i, s * sx[i / dout_p]);
  }
}

// The quantize pre-pass (NORM: with the RMSNorm of nw, eps; bf16 x), the
// tile (NORM: under the name qmm_norm_w4a8_mma_kernel), then the split sum
// where K is split.
template <int BITS, int XK, int NT, bool NORM = false>
cudaError_t launch_w4a8_mma(const void* x, int8_t* xq, float* sx,
                            const void* qw, const void* sc, bool sc_bf16,
                            void* out, float* part, int rows, int din,
                            int dout_p, int group, int splits,
                            cudaStream_t stream, const void* nw = nullptr,
                            float eps = 0.f) {
  static_assert(!NORM || XK == kXBf16, "the RMSNorm form is bf16");
  static SmemGrant granted;
  constexpr int BR = 8 * NT;
  if (NORM)
    w4a8_norm_quantize_rows<<<rows,
                              dim3(qmm_detail::kLanes, qmm_detail::kWarps),
                              0, stream>>>(
        x, static_cast<const __nv_bfloat16*>(nw), eps, din, xq, sx);
  else
    w4a8_quantize_rows<XK><<<rows, kQThreads, 0, stream>>>(x, din, xq, sx);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  auto kernel = NORM ? qmm_norm_w4a8_mma_kernel<BITS, NT>
                     : qmm_w4a8_mma_kernel<BITS, XK, NT>;
  const size_t smem =
      (size_t)kStages * (kBK * kWStride + (BITS == 4 ? 2 : 1) * BR * kXStride);
  e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  dim3 grid((rows + BR - 1) / BR, (dout_p + kBN - 1) / kBN, splits);
  kernel<<<grid, kThreads, smem, stream>>>(
      xq, sx, static_cast<const int8_t*>(qw), sc, sc_bf16, out, part, rows,
      din, dout_p, group, splits);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return e;
  const size_t n = (size_t)rows * dout_p;
  const unsigned blocks =
      (unsigned)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024);
  w4a8_splitk_sum<XK><<<blocks, 256, 0, stream>>>(part, splits, n, dout_p,
                                                  sx, out);
  return cudaGetLastError();
}

// The checks both C entries make on a launch.
bool w4a8_refuses(const void* xq, const void* sx, const void* qw,
                  const void* part, int rows, int din, int dout_p, int bits,
                  int group, int splits) {
  const int krows = bits == 4 ? din / 2 : din;
  return rows < 1 || group <= 0 || group % kBK || krows % group ||
         dout_p % 4 || splits < 1 || splits > krows / group ||
         (splits > 1 && !part) || din % 16 || !sx ||
         reinterpret_cast<uintptr_t>(xq) % 16 ||
         reinterpret_cast<uintptr_t>(qw) % 16;
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// x [rows, din] bf16 or f32 (x_kind kXBf16 or kXF32), any alignment; xq
// int8 [rows, din] and sx f32 [rows] buffers for the quantized rows (xq
// 16-byte aligned); qw int8 [din/2 or din, dout_p] (unpaired), 16-byte
// aligned, dout_p a multiple of 4; sc bf16/f32 [ng, dout_p]; group a
// multiple of 64 dividing the packed rows; row_tile 8, 16, 32 or 64;
// splits in [1, packed rows / group], part f32 [splits, rows, dout_p]
// when splits > 1 (a buffer); out [rows, dout_p] in x's type.
ITT_EXPORT int qmm_w4a8_mma(const void* x, int x_kind, void* xq, void* sx,
                            const void* qw, const void* sc, int sc_bf16,
                            void* part, void* out, int rows, int din,
                            int dout_p, int bits, int group, int row_tile,
                            int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w4a8_refuses(xq, sx, qw, part, rows, din, dout_p, bits, group, splits))
    return (int)cudaErrorInvalidValue;
  int8_t* q = static_cast<int8_t*>(xq);
  float* f = static_cast<float*>(sx);
  float* p = static_cast<float*>(part);
#define ITT_W4A8_MMA(B, XF, NT)                                               \
  if (bits == B && x_kind == XF && row_tile == 8 * NT)                        \
    return (int)launch_w4a8_mma<B, XF, NT>(x, q, f, qw, sc, sc_bf16, out, p,  \
                                           rows, din, dout_p, group, splits, \
                                           s);
#define ITT_W4A8_MMA_TILES(B, XF)                                             \
  ITT_W4A8_MMA(B, XF, 1) ITT_W4A8_MMA(B, XF, 2) ITT_W4A8_MMA(B, XF, 4)        \
  ITT_W4A8_MMA(B, XF, 8)
  ITT_W4A8_MMA_TILES(4, kXBf16) ITT_W4A8_MMA_TILES(4, kXF32)
  ITT_W4A8_MMA_TILES(8, kXBf16) ITT_W4A8_MMA_TILES(8, kXF32)
#undef ITT_W4A8_MMA_TILES
#undef ITT_W4A8_MMA
  return (int)cudaErrorInvalidValue;
}

// x bf16 [rows, din], any alignment; nw bf16 [din], the RMSNorm weight;
// xq, sx, qw, sc, part, row_tile, splits as qmm_w4a8_mma; out bf16 [rows,
// dout_p] = qmm_w4a8_mma of bf16(bf16(x * 1/sqrt(mean(x^2) + eps)) * nw).
ITT_EXPORT int qmm_norm_w4a8_mma(const void* x, const void* nw, void* xq,
                                 void* sx, const void* qw, const void* sc,
                                 int sc_bf16, void* part, void* out, int rows,
                                 int din, int dout_p, int bits, int group,
                                 float eps, int row_tile, int splits,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w4a8_refuses(xq, sx, qw, part, rows, din, dout_p, bits, group,
                   splits) || !x || !nw)
    return (int)cudaErrorInvalidValue;
  int8_t* q = static_cast<int8_t*>(xq);
  float* f = static_cast<float*>(sx);
  float* p = static_cast<float*>(part);
#define ITT_NORM_W4A8_MMA(B, NT)                                              \
  if (bits == B && row_tile == 8 * NT)                                        \
    return (int)launch_w4a8_mma<B, kXBf16, NT, true>(                         \
        x, q, f, qw, sc, sc_bf16, out, p, rows, din, dout_p, group, splits,   \
        s, nw, eps);
  ITT_NORM_W4A8_MMA(4, 1) ITT_NORM_W4A8_MMA(4, 2) ITT_NORM_W4A8_MMA(4, 4)
  ITT_NORM_W4A8_MMA(4, 8) ITT_NORM_W4A8_MMA(8, 1) ITT_NORM_W4A8_MMA(8, 2)
  ITT_NORM_W4A8_MMA(8, 4) ITT_NORM_W4A8_MMA(8, 8)
#undef ITT_NORM_W4A8_MMA
  return (int)cudaErrorInvalidValue;
}
