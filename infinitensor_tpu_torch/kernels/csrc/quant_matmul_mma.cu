// qmm_group on Hopper's tensor cores (sm_90a): the weight-only int4/int8
// group-dot matmul for 1 to 256 activation rows of bf16 or f16, with
// mma.sync m16n8k16 (16-bit operands, f32 sums) fed by a ring of cp.async
// stages. Python wrapper: kernels/quant_matmul.py (_launch_group, form
// "mma"; group_form says when a launch takes it, with or without the
// RMSNorm; _launch_group_ln for the LayerNorm form, ln_form; _launch_slab
// for the paired forms, slab_form).
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/quant_matmul.py:
//   qmm_group_mma       <- _kernel_group (:100, body _group_dots :115-166)
//   qmm_group_norm_mma  <- _kernel_group_norm (:85, via quant_matmul_norm)
//   qmm_group_ln_mma    <- _kernel_group_ln (:300, via quant_matmul_ln :321)
//   qmm_chunk_mma       <- _kernel (:44, the chunk kernel; a group that is
//                          no multiple of 128, as at group 64)
//   qmm_slab_mma        <- _kernel_group_slab (:203, body _group_dots_slab
//                          :170-200; a paired int4 weight)
//   qmm_slab_norm_mma   <- _kernel_group_norm_slab (:208)
// the first and qmm_slab_mma for a bf16 or f16 x without a norm, the
// others for a bf16 x:
// the Llama decode step's RMSNorm ahead of wqkv and w_gateup, GPT-2's
// pre-matmul LayerNorm (then the output bias). The RMSNorm form is a
// pre-pass and this tile: group_norm_rows writes the rows normalized to
// bf16 [rows, din] (8 x 4096 at the dense 7B serving step: 64 KB) with
// the arithmetic and reduction order of qmm_group_norm's CUDA-core
// prologue (quant_matmul.cuh rms_norm_rinv / rms_norm_value), so both
// forms agree to the bit on the normalized x; the CUDA-core form has each
// of wqkv's 96 and w_gateup's 176 column blocks normalize the same rows
// again. The tile is qmm_group_mma's as it is. The LayerNorm form is a
// pre-pass and this tile too: group_ln_norm_rows writes the rows
// normalized to bf16 [rows, din] (64 x 1024 at GPT-2's step: 128 KB)
// with the arithmetic and reduction order of qmm_group_ln's CUDA-core
// prologue (quant_matmul.cuh layer_norm_stats / layer_norm_value), so
// both forms agree to the bit on the normalized x; a prologue in the
// tile would have each of the 24-32 column blocks of GPT-2's matrices
// normalize the same rows again. The tile then ends as the TPU kernel
// does: the f32 sum rounded to bf16, the bias added in f32, rounded again
// (in its direct store and in its split sum alike). Both launches come
// from one C entry; the step that runs it is a captured CUDA graph.
// qmm_group_mma computes _group_dots' function:
// per scale group, x times the weight's exact integer values, summed in
// f32 to a per-group partial; the partial times that group's scale in f32,
// added to the f32 accumulator; rounded once to x's type at the end. The
// nibbles decode to their exact signed values (offset-binary low nibble
// W[p], signed high nibble W[half + p] of packed row p; scales s[c] and
// s[ngs + c] of packed group c), so no -8 * sum(x) correction is needed.
// An f32 x keeps the CUDA-core form of quant_matmul.cuh: rounding it to 16
// bits for the tensor cores would change its numbers.
//
// qmm_chunk_mma computes the chunk kernel's function (qmm_chunk_plain):
// each weight is its exact value times its group's scale in f32, rounded
// to bf16, and only then multiplied by x; the products summed in f32,
// rounded once to bf16. That is a bf16 x bf16 mma with f32 sums, so the
// tile runs as above with two changes. The scale enters each A register
// before the mma (the rounding point of quant_matmul.cuh's kDequant): a
// decoded register holds two exact integers of one output column (column
// ncol + 2f + (e & 1) for register e of M-tile f; int4 lo with s[c], hi
// with s[ngs + c]); with bf16 scales one fma.rn.bf16x2 by {s, s} (plus
// -0) rounds the exact product (a 4- or 8-bit integer times an 8-bit
// significand fits 16 bits) once, as round_bf16(__fmul_rn(v, s)) does;
// with f32 scales each value goes through __fmul_rn in f32, then
// cvt.rn.bf16x2, the plain version's two roundings. And there are no
// per-group partials: the mma sums straight into acc (64 f32 a lane at
// the 64-row tile, not 192). It takes a bf16 x only (an f16 or f32 x
// stays on quant_matmul_chunk.cu: the chunk multiplies x as it is by bf16
// weights in f32, and no 16-bit mma takes an f16 x bf16 pair), a group
// that is a multiple of 64 (kBK; group 32 stays there too), int4
// (split-half) or int8, bf16 or f32 scales, dout_p a multiple of 4.
//
// qmm_slab_mma computes _group_dots_slab's function over a paired int4
// weight (quantize_weight(paired=True): the split halves as above, but
// one scale row [krows / group, dout_p] for both halves of a packed
// group): per packed group c, one f32 partial over both halves' exact
// nibble values, times the one scale s[c], added to acc. So the tile runs
// with PAIRED: both halves' mma.sync sum into the same partial fragment
// (plo), which is folded once a group, acc += plo * s[c]. The TPU
// kernel's -8 * sum(x_lo) correction and its x_hi / 16 step vanish, as
// the nibbles decode to their signed values. phi is dead, so the 64-row
// tile keeps 2 x 64 f32 sums a lane, not 3 x 64. qmm_slab_norm_mma is
// group_norm_rows' pre-pass (_kernel_group_norm_slab normalizes as
// _kernel_group_norm does), then that tile. An f32 x stays on the CUDA
// cores here too (quant_matmul.cuh's paired body).
//
// What bounds it on this card (H100 SXM: 3.35 TB/s, 989 TFLOP/s bf16):
// at 8 rows every weight byte feeds 4 (int4) or 2 (int8) multiply-adds
// per row, far below the ~295 ops/byte ridge, so the packed weights and
// scales over device memory bound it (wqkv 25.95 MB: 0.0078 ms); at 256
// rows of int4 the bytes and the tensor-core rate bound it about equally
// (wqkv: 25.8 GFLOP is 0.026 ms at the peak).
//
// The design, one answer to each thing that held the CUDA-core form back:
//  * tensor cores: swap-AB, out^T = W^T x^T, so M = 16 runs over output
//    columns and N = 8 over activation rows (a row count pads to a multiple
//    of 8, not 16). The fragment rows are permuted: row m of a warp's
//    M-tile f is column 4 * (m % 8) + 2 * f + m / 8 of its 32 columns, so
//    one 32-bit shared load gives a lane the 4 adjacent columns it needs
//    from one packed row, and its C fragment holds 4 adjacent output
//    columns of 2 rows (one 8-byte store each). The permutation is the
//    same for A and the sums, so no value moves between lanes;
//  * the per-group partial sits in fragments of its own (one per nibble
//    half), folded into the accumulator once per group: acc += plo * s_lo
//    + phi * s_hi, the TPU kernel's order;
//  * the weight is read few times: a block of 4 warps owns 128 output
//    columns (32 a warp) and a tile of 8, 16, 32 or 64 rows, all of them
//    in each warp, so a lane decodes a weight once for up to 8 n-tiles (a
//    256-row call reads each weight byte 4 times, mostly from L2). Where
//    column and row tiles give too few blocks to fill the SMs, K is split
//    across blocks by whole scale groups (grid z); the splits write f32
//    partials that a second pass sums in z order, so results repeat bit
//    for bit (no atomics). The tile and split rule (quant_matmul.py
//    mma_plan) are the fastest of the variants timed on the card;
//  * x is staged as 16-bit tiles [rows][64] per nibble half, not whole f32
//    rows, and read into B fragments with ldmatrix (row stride 144 bytes:
//    conflict-free); the int8 weight tile [64][128] is staged as it lies
//    (row stride 144 bytes: a warp's 32-bit loads from rows 2t, 2t+1,
//    2t+8, 2t+9 hit 32 distinct banks) and decoded into A fragments in
//    registers: a nibble pair to two bf16 (f16) values by OR-ing it into
//    the mantissa of 128.0 (1024.0) and subtracting 136 (1032) in one
//    bf16x2 (f16x2) FMA, an int8 pair through f32;
//  * the copies are asynchronous: a ring of 3 stages of 64 packed rows,
//    filled with 16-byte cp.async (4-byte where the columns are no
//    multiple of 16), so the next tiles load while this one is multiplied.
// What still holds it back at 256 rows (2-3.6x the library call, PERF.md):
// the 64-row tile keeps 3 x 64 f32 sums a lane (acc, plo, phi: 255
// registers, 2 blocks an SM), too few warps to hide the latency of the
// decode -> mma chain; the mma.sync rate itself is not reached. (The
// paired tile keeps 2 x 64, 203 registers, and takes 12-15 % less time
// than the unpaired one at 256 rows of the 7B shapes.) Later:
// wgmma with TMA (A from registers, a producer warp), and decoding with
// byte permutes straight from global memory.
#include "mma_tile.cuh"
#include "quant_matmul.cuh"

namespace {

using namespace mma_tile;

constexpr int kXStride = 2 * kBK + 16;     // bytes per staged x row

// Byte J of w0 in byte 0 and byte J of w1 in byte 2 (bytes 1 and 3 are
// masked off by the decoders): one weight of two consecutive packed rows.
template <int J>
__device__ __forceinline__ uint32_t pair_bytes(uint32_t w0, uint32_t w1) {
  return __byte_perm(w0, w1, J | (J << 4) | ((J + 4) << 8) | ((J + 4) << 12));
}

// The two nibbles (HI: the signed high ones, else the offset-binary low
// ones) of a pair_bytes word as two exact 16-bit values of the type XK:
// w + 8 OR-ed into the mantissa of 128.0 (f16: 1024.0), minus 136 (1032).
template <int XK, bool HI>
__device__ __forceinline__ uint32_t nibble_pair(uint32_t p) {
  constexpr uint32_t kMagic = XK == kXF16 ? 0x64006400u : 0x43004300u;
  constexpr uint32_t kOne = XK == kXF16 ? 0x3C003C00u : 0x3F803F80u;
  constexpr uint32_t kBias = XK == kXF16 ? 0xE408E408u : 0xC308C308u;
  const uint32_t v = HI ? ((p >> 4) & 0x000F000Fu) ^ (kMagic | 0x00080008u)
                        : (p & 0x000F000Fu) | kMagic;
  uint32_t d;
  if (XK == kXF16)
    asm("fma.rn.f16x2 %0, %1, %2, %3;\n"
        : "=r"(d) : "r"(v), "r"(kOne), "r"(kBias));
  else
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(d) : "r"(v), "r"(kOne), "r"(kBias));
  return d;
}

// The two signed bytes of a pair_bytes word as two exact 16-bit values.
template <int XK>
__device__ __forceinline__ uint32_t int8_pair(uint32_t p) {
  const float lo = i8_val(p, 0), hi = i8_val(p, 16);
  return pack_out<XK>(lo, hi);
}

// Where a scale enters the tile (group_mma_tile's DEQ): per group, on the
// f32 partial (the group dots), or on each weight before the mma (the
// chunk kernel), with bf16 or f32 scales.
constexpr int kNoDeq = 0, kDeqBf16 = 1, kDeqF32 = 2;

// A pair of exact bf16 weight values v (one output column) times its
// scale, rounded to bf16: DEQ kDeqBf16, s = {s, s} in bf16, the exact
// product rounded once (fma with -0, so that 0 * s stays +0);
// kDeqF32, s an f32 scale's bits, __fmul_rn in f32 then to bf16.
template <int DEQ>
__device__ __forceinline__ uint32_t scaled_pair(uint32_t v, uint32_t s) {
  if (DEQ == kDeqBf16) {
    uint32_t d;
    asm("fma.rn.bf16x2 %0, %1, %2, %3;\n"
        : "=r"(d) : "r"(v), "r"(s), "r"(0x80008000u));
    return d;
  }
  const float f = __uint_as_float(s);
  return pack_out<kXBf16>(__fmul_rn(__uint_as_float(v << 16), f),
                          __fmul_rn(__uint_as_float(v & 0xFFFF0000u), f));
}

// The scale word of element i of sc for scaled_pair<DEQ>.
template <int DEQ>
__device__ __forceinline__ uint32_t scale_word(const void* sc, size_t i) {
  if (DEQ == kDeqBf16) {
    const uint32_t b = static_cast<const uint16_t*>(sc)[i];
    return b | (b << 16);
  }
  return __float_as_uint(static_cast<const float*>(sc)[i]);
}

// x [rows, din] 16-bit (XK: kXBf16 or kXF16); qw int8 [krows, dout_p]
// (split-half int4 or int8, unpaired); sc bf16/f32 [ngs (int4: 2 ngs),
// dout_p]; out [rows, dout_p] of x's type, or with splits > 1 part f32
// [splits, rows, dout_p]. Block (bx, by, bz): columns [bx * kBN, +kBN),
// rows [by * BR, +BR), scale groups [bz * ngs / splits, (bz + 1) * ngs /
// splits) of the packed rows. Warp w: columns w * 32 .. + 32 and all
// BR = 8 * NT rows of the block's tile. LN (bf16 only): out = bf16(
// bf16(sum) + bias[n]), bias bf16/f32 [nbias] (0 past nbias, or none).
// DEQ kDeqBf16 / kDeqF32 (bf16 x, no LN; sc bf16 / f32 as sc_bf16 says):
// the chunk kernel's function, each weight scaled and rounded to bf16
// before the mma, which sums into acc (no per-group partials). PAIRED
// (int4, no LN, no DEQ): sc [ngs, dout_p] holds one scale row a packed
// group, and both halves sum into one partial (plo).
template <int BITS, int XK, int NT, bool LN, int DEQ = kNoDeq,
          bool PAIRED = false>
__device__ __forceinline__ void group_mma_tile(
    const uint16_t* __restrict__ x, const int8_t* __restrict__ qw,
    const void* __restrict__ sc, bool sc_bf16, const void* __restrict__ bias,
    bool bias_bf16, int nbias, void* __restrict__ out,
    float* __restrict__ part, int rows, int din, int dout_p, int group,
    int splits) {
  static_assert(!LN || XK == kXBf16, "the LayerNorm form is bf16");
  static_assert(DEQ == kNoDeq || (XK == kXBf16 && !LN),
                "the chunk form is bf16, without a LayerNorm");
  static_assert(!PAIRED || (BITS == 4 && !LN && DEQ == kNoDeq),
                "the paired form is int4, without a LayerNorm or DEQ");
  constexpr bool kChunk = DEQ != kNoDeq;
  constexpr int BR = 8 * NT;                      // rows per block
  constexpr int kHalves = BITS == 4 ? 2 : 1;      // x tiles: lo (and hi)
  constexpr int kWBytes = kBK * kWStride;
  constexpr int kXBytes = BR * kXStride;
  constexpr int kStage = kWBytes + kHalves * kXBytes;
  extern __shared__ __align__(16) uint8_t mma_smem[];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int krows = BITS == 4 ? din / 2 : din;
  const int ngs = krows / group;
  const int col0 = blockIdx.x * kBN, row0 = blockIdx.y * BR;
  const int c0 = (int)((long long)blockIdx.z * ngs / splits);
  const int c1 = (int)((long long)(blockIdx.z + 1) * ngs / splits);
  const int p0 = c0 * group;
  const int nst = (c1 - c0) * group / kBK;

  // Stage st of this block (packed rows p0 + st * kBK ...) into ring slot.
  auto load_stage = [&](int slot, int st) {
    uint8_t* base = mma_smem + slot * kStage;
    const int p = p0 + st * kBK;
    load_weight_tile<false>(base, qw, p, col0, dout_p);
#pragma unroll
    for (int h = 0; h < kHalves; ++h) {
      uint8_t* xs = base + kWBytes + h * kXBytes;
      const int k0 = h * krows + p;             // the half's first x column
      for (int i = threadIdx.x; i < BR * (kBK / 8); i += kThreads) {
        const int r = i / (kBK / 8), c = (i % (kBK / 8)) * 8;
        const bool ok = row0 + r < rows;
        cp_async16(xs + r * kXStride + 2 * c,
                   ok ? x + (size_t)(row0 + r) * din + k0 + c : x,
                   ok ? 16 : 0);
      }
    }
  };

  // (the chunk form sums into acc alone: its plo and phi are dead; the
  // paired form sums both halves into plo: its phi is dead)
  float acc[2][NT][4], plo[2][NT][4], phi[2][NT][4];
#pragma unroll
  for (int f = 0; f < 2; ++f)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[f][j][e] = plo[f][j][e] = phi[f][j][e] = 0.f;
  const int ncol = col0 + warp * 32 + 4 * g;     // this lane's 4 columns
  float s_lo[4] = {0.f, 0.f, 0.f, 0.f}, s_hi[4] = {0.f, 0.f, 0.f, 0.f};
  uint32_t w_lo[4] = {0, 0, 0, 0}, w_hi[4] = {0, 0, 0, 0};  // scaled_pair's

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
        const size_t lo = (size_t)c * dout_p + ncol + j;
        const size_t hi = (size_t)(ngs + c) * dout_p + ncol + j;
        if (kChunk) {
          w_lo[j] = scale_word<DEQ>(sc, lo);
          if (BITS == 4) w_hi[j] = scale_word<DEQ>(sc, hi);
        } else {
          s_lo[j] = load_scale(sc, sc_bf16, lo);
          if (BITS == 4 && !PAIRED) s_hi[j] = load_scale(sc, sc_bf16, hi);
        }
      }
    }
    const uint8_t* base = mma_smem + (st % kStages) * kStage;
    const uint8_t* wb = base + warp * 32 + 4 * g;
    const uint32_t xb = smem_addr(base + kWBytes);
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      // the lane's 4 columns of packed rows 2t, 2t + 1, 2t + 8, 2t + 9
      const uint8_t* wk = wb + (ks * 16 + 2 * t) * kWStride;
      const uint32_t w0 = *reinterpret_cast<const uint32_t*>(wk);
      const uint32_t w1 = *reinterpret_cast<const uint32_t*>(wk + kWStride);
      const uint32_t w8 = *reinterpret_cast<const uint32_t*>(wk + 8 * kWStride);
      const uint32_t w9 = *reinterpret_cast<const uint32_t*>(wk + 9 * kWStride);
      // A fragments of M-tiles f = 0, 1: registers {row g, k 2t..},
      // {row g + 8, k 2t..}, {row g, k 2t + 8..}, {row g + 8, k 2t + 8..};
      // row g of tile f is byte 2f of the lane's word, row g + 8 byte 2f + 1
      uint32_t alo[2][4], ahi[2][4];
      const uint32_t q[2][4] = {
          {pair_bytes<0>(w0, w1), pair_bytes<1>(w0, w1),
           pair_bytes<0>(w8, w9), pair_bytes<1>(w8, w9)},
          {pair_bytes<2>(w0, w1), pair_bytes<3>(w0, w1),
           pair_bytes<2>(w8, w9), pair_bytes<3>(w8, w9)}};
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (BITS == 4) {
            alo[f][e] = nibble_pair<XK, false>(q[f][e]);
            ahi[f][e] = nibble_pair<XK, true>(q[f][e]);
          } else {
            alo[f][e] = int8_pair<XK>(q[f][e]);
          }
          if (kChunk) {                  // column ncol + 2f + (e & 1)
            alo[f][e] = scaled_pair<DEQ>(alo[f][e], w_lo[2 * f + (e & 1)]);
            if (BITS == 4)
              ahi[f][e] = scaled_pair<DEQ>(ahi[f][e], w_hi[2 * f + (e & 1)]);
          }
        }
#pragma unroll
      for (int h = 0; h < kHalves; ++h) {
        // B fragments: x rows of the warp's n-tiles, k columns ks * 16 ..
        const uint32_t xs = xb + h * kXBytes + (ks * 16 + (lane & 8)) * 2;
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
              float (&d)[4] = kChunk ? acc[f][j + jj]
                              : BITS == 4 && h && !PAIRED ? phi[f][j + jj]
                                                          : plo[f][j + jj];
              mma16816<XK>(d, BITS == 4 && h == 1 ? ahi[f] : alo[f],
                           b[2 * jj], b[2 * jj + 1]);
            }
        }
      }
    }
    if (!kChunk && (p + kBK) % group == 0) {   // a group ends: fold it
#pragma unroll
      for (int f = 0; f < 2; ++f)
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // C element e: column 4g + 2f + e / 2, row 2t + e % 2
            const int sj = 2 * f + e / 2;
            acc[f][j][e] += BITS == 4 && !PAIRED
                ? plo[f][j][e] * s_lo[sj] + phi[f][j][e] * s_hi[sj]
                : plo[f][j][e] * s_lo[sj];
            plo[f][j][e] = phi[f][j][e] = 0.f;
          }
    }
  }

  if (ncol >= dout_p) return;
  float b[4] = {0.f, 0.f, 0.f, 0.f};
  if (LN && bias && splits == 1)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ncol + j < nbias) b[j] = load_scale(bias, bias_bf16, ncol + j);
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {          // rows 2t, 2t + 1 of n-tile j
      const int r = row0 + j * 8 + 2 * t + e;
      if (r >= rows) continue;
      // columns ncol .. ncol + 3: (f 0, m g), (f 0, m g+8), (f 1, m g), ...
      float v[4] = {acc[0][j][e], acc[0][j][2 + e], acc[1][j][e],
                    acc[1][j][2 + e]};
      if (splits > 1) {
        *reinterpret_cast<float4*>(
            part + ((size_t)blockIdx.z * rows + r) * dout_p + ncol) =
            make_float4(v[0], v[1], v[2], v[3]);
        continue;
      }
      if (LN && bias)
#pragma unroll
        for (int c = 0; c < 4; ++c) v[c] = __fadd_rn(round_bf16(v[c]), b[c]);
      store4<XK>(out, (size_t)r * dout_p + ncol, v[0], v[1], v[2], v[3]);
    }
}

template <int BITS, int XK, int NT>
__global__ void __launch_bounds__(kThreads)
qmm_group_mma_kernel(const uint16_t* __restrict__ x,
                     const int8_t* __restrict__ qw,
                     const void* __restrict__ sc, bool sc_bf16,
                     void* __restrict__ out, float* __restrict__ part,
                     int rows, int din, int dout_p, int group, int splits) {
  group_mma_tile<BITS, XK, NT, false>(x, qw, sc, sc_bf16, nullptr, false, 0,
                                      out, part, rows, din, dout_p, group,
                                      splits);
}

// The tile of the RMSNorm form, as qmm_group_mma_kernel (a kernel of its
// own name, so that a profile gives its time to qmm_group_norm): x holds
// the normalized rows.
template <int BITS, int NT>
__global__ void __launch_bounds__(kThreads)
qmm_group_norm_mma_kernel(const uint16_t* __restrict__ x,
                          const int8_t* __restrict__ qw,
                          const void* __restrict__ sc, bool sc_bf16,
                          void* __restrict__ out, float* __restrict__ part,
                          int rows, int din, int dout_p, int group,
                          int splits) {
  group_mma_tile<BITS, kXBf16, NT, false>(x, qw, sc, sc_bf16, nullptr, false,
                                          0, out, part, rows, din, dout_p,
                                          group, splits);
}

// The tile of the chunk kernel (a kernel of its own name, so that a
// profile gives its time to qmm_chunk): bf16 x, bf16 (SC_BF16) or f32
// scales, each weight scaled and rounded to bf16 before the mma.
template <int BITS, int NT, bool SC_BF16>
__global__ void __launch_bounds__(kThreads)
qmm_chunk_mma_kernel(const uint16_t* __restrict__ x,
                     const int8_t* __restrict__ qw,
                     const void* __restrict__ sc, void* __restrict__ out,
                     float* __restrict__ part, int rows, int din, int dout_p,
                     int group, int splits) {
  group_mma_tile<BITS, kXBf16, NT, false, SC_BF16 ? kDeqBf16 : kDeqF32>(
      x, qw, sc, SC_BF16, nullptr, false, 0, out, part, rows, din, dout_p,
      group, splits);
}

// The paired tile (a kernel of its own name, so that a profile gives its
// time to qmm_slab): one scale row a packed group for both halves.
template <int XK, int NT>
__global__ void __launch_bounds__(kThreads)
qmm_slab_mma_kernel(const uint16_t* __restrict__ x,
                    const int8_t* __restrict__ qw,
                    const void* __restrict__ sc, bool sc_bf16,
                    void* __restrict__ out, float* __restrict__ part,
                    int rows, int din, int dout_p, int group, int splits) {
  group_mma_tile<4, XK, NT, false, kNoDeq, true>(
      x, qw, sc, sc_bf16, nullptr, false, 0, out, part, rows, din, dout_p,
      group, splits);
}

// The paired tile of the RMSNorm form (qmm_slab_norm): x holds the
// normalized rows.
template <int NT>
__global__ void __launch_bounds__(kThreads)
qmm_slab_norm_mma_kernel(const uint16_t* __restrict__ x,
                         const int8_t* __restrict__ qw,
                         const void* __restrict__ sc, bool sc_bf16,
                         void* __restrict__ out, float* __restrict__ part,
                         int rows, int din, int dout_p, int group,
                         int splits) {
  group_mma_tile<4, kXBf16, NT, false, kNoDeq, true>(
      x, qw, sc, sc_bf16, nullptr, false, 0, out, part, rows, din, dout_p,
      group, splits);
}

// The tile of the LayerNorm form (a kernel of its own name, so that a
// profile gives its time to qmm_group_ln): x holds the normalized rows.
template <int BITS, int NT>
__global__ void __launch_bounds__(kThreads)
qmm_group_ln_mma_kernel(const uint16_t* __restrict__ x,
                        const int8_t* __restrict__ qw,
                        const void* __restrict__ sc, bool sc_bf16,
                        const void* __restrict__ bias, bool bias_bf16,
                        int nbias, void* __restrict__ out,
                        float* __restrict__ part, int rows, int din,
                        int dout_p, int group, int splits) {
  group_mma_tile<BITS, kXBf16, NT, true>(x, qw, sc, sc_bf16, bias, bias_bf16,
                                         nbias, out, part, rows, din, dout_p,
                                         group, splits);
}

// out[i] = the sum over z of part[z][i], z in order, rounded to XK; with
// LN and a bias as the tile's direct store ends: rounded to bf16, plus
// bias[i % dout_p] in f32, rounded again.
template <int XK, bool LN>
__device__ __forceinline__ void splitk_sum_body(
    const float* __restrict__ part, int splits, size_t n, int dout_p,
    const void* __restrict__ bias, bool bias_bf16, int nbias,
    void* __restrict__ out) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int z = 0; z < splits; ++z) s += part[z * n + i];
    if (LN && bias) {
      const int col = (int)(i % dout_p);
      s = __fadd_rn(round_bf16(s),
                    col < nbias ? load_scale(bias, bias_bf16, col) : 0.f);
    }
    qmm_detail::store_out<XK>(out, i, s);
  }
}

template <int XK>
__global__ void mma_splitk_sum(const float* __restrict__ part, int splits,
                               size_t n, void* __restrict__ out) {
  splitk_sum_body<XK, false>(part, splits, n, 1, nullptr, false, 0, out);
}

// The chunk tile's split sum, as mma_splitk_sum<kXBf16> (a kernel of its
// own name, so that a profile gives its time to qmm_chunk).
__global__ void chunk_splitk_sum(const float* __restrict__ part, int splits,
                                 size_t n, void* __restrict__ out) {
  splitk_sum_body<kXBf16, false>(part, splits, n, 1, nullptr, false, 0, out);
}

__global__ void group_ln_splitk_sum(const float* __restrict__ part,
                                    int splits, size_t n, int dout_p,
                                    const void* __restrict__ bias,
                                    bool bias_bf16, int nbias,
                                    void* __restrict__ out) {
  splitk_sum_body<kXBf16, true>(part, splits, n, dout_p, bias, bias_bf16,
                                nbias, out);
}

// One thread per output of the split sum, at most 1024 blocks.
inline dim3 sum_grid(size_t n) {
  return dim3((unsigned)((n + 255) / 256 < 1024 ? (n + 255) / 256 : 1024));
}

// Launch the tile `kernel` (qmm_group_mma_kernel, qmm_group_norm_mma_kernel,
// qmm_chunk_mma_kernel or qmm_group_ln_mma_kernel, BR rows per block) on
// its grid with the shared memory it needs; `args` are its arguments.
template <int BITS, int NT, typename K, typename... A>
cudaError_t launch_tile(K kernel, SmemGrant* granted, int rows, int dout_p,
                        int splits, cudaStream_t stream, A... args) {
  constexpr int BR = 8 * NT;
  const size_t smem =
      (size_t)kStages * (kBK * kWStride + (BITS == 4 ? 2 : 1) * BR * kXStride);
  cudaError_t e = allow_smem(kernel, smem, granted);
  if (e != cudaSuccess) return e;
  dim3 grid((dout_p + kBN - 1) / kBN, (rows + BR - 1) / BR, splits);
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// After a tile launch that returned e: where K is split, the sum of its
// splits' partials into out [n] by the kernel `sum` (mma_splitk_sum<XK>
// or chunk_splitk_sum).
template <typename K>
cudaError_t sum_splits(K sum, cudaError_t e, const float* part, int splits,
                       size_t n, void* out, cudaStream_t stream) {
  if (e != cudaSuccess || splits == 1) return e;
  sum<<<sum_grid(n), 256, 0, stream>>>(part, splits, n, out);
  return cudaGetLastError();
}

// qmm_group_mma's tile (NORM: under the name qmm_group_norm_mma_kernel,
// on rows the pre-pass normalized; PAIRED: the paired tile, under the
// name qmm_slab_mma_kernel or qmm_slab_norm_mma_kernel), then the split
// sum where K is split.
template <int BITS, int XK, int NT, bool NORM = false, bool PAIRED = false>
cudaError_t launch_mma(const void* x, const void* qw, const void* sc,
                       bool sc_bf16, void* out, float* part, int rows,
                       int din, int dout_p, int group, int splits,
                       cudaStream_t stream) {
  static_assert(!NORM || XK == kXBf16, "the RMSNorm form is bf16");
  static_assert(!PAIRED || BITS == 4, "the paired form is int4");
  static SmemGrant granted;
  auto kernel = [] {
    if constexpr (PAIRED)
      return NORM ? qmm_slab_norm_mma_kernel<NT> : qmm_slab_mma_kernel<XK, NT>;
    else
      return NORM ? qmm_group_norm_mma_kernel<BITS, NT>
                  : qmm_group_mma_kernel<BITS, XK, NT>;
  }();
  cudaError_t e = launch_tile<BITS, NT>(
      kernel, &granted, rows, dout_p, splits,
      stream, static_cast<const uint16_t*>(x),
      static_cast<const int8_t*>(qw), sc, sc_bf16, out, part, rows, din,
      dout_p, group, splits);
  return sum_splits(mma_splitk_sum<XK>, e, part, splits,
                    (size_t)rows * dout_p, out, stream);
}

// qmm_chunk_mma's tile, then the split sum where K is split.
template <int BITS, int NT, bool SC_BF16>
cudaError_t launch_chunk_mma(const void* x, const void* qw, const void* sc,
                             void* out, float* part, int rows, int din,
                             int dout_p, int group, int splits,
                             cudaStream_t stream) {
  static SmemGrant granted;
  cudaError_t e = launch_tile<BITS, NT>(
      qmm_chunk_mma_kernel<BITS, NT, SC_BF16>, &granted, rows, dout_p,
      splits, stream, static_cast<const uint16_t*>(x),
      static_cast<const int8_t*>(qw), sc, out, part, rows, din, dout_p,
      group, splits);
  return sum_splits(chunk_splitk_sum, e, part, splits, (size_t)rows * dout_p,
                    out, stream);
}

// The LayerNorm pre-pass: row blockIdx.x of x bf16 [rows, din] normalized
// to xn bf16 [rows, din] (block: qmm_detail's kLanes x kWarps threads,
// the CUDA-core prologue's reduction order).
__global__ void __launch_bounds__(qmm_detail::kLanes * qmm_detail::kWarps)
group_ln_norm_rows(const void* __restrict__ x, const void* __restrict__ gamma,
                   const void* __restrict__ beta, bool norm_bf16, float eps,
                   int din, __nv_bfloat16* __restrict__ xn) {
  __shared__ float rpart[qmm_detail::kWarps];
  const size_t xr = (size_t)blockIdx.x * din;
  float mu, rinv;
  qmm_detail::layer_norm_stats(x, xr, din, eps, rpart, mu, rinv);
  const int nthr = qmm_detail::kLanes * qmm_detail::kWarps;
  for (int k = threadIdx.y * qmm_detail::kLanes + threadIdx.x; k < din;
       k += nthr)
    xn[xr + k] = __float2bfloat16_rn(qmm_detail::layer_norm_value(
        qmm_detail::load_x<kXBf16>(x, xr + k), mu, rinv, gamma, beta,
        norm_bf16, k));
}

// The RMSNorm pre-pass: row blockIdx.x of x bf16 [rows, din] normalized
// and times nw to xn bf16 [rows, din] (block: qmm_detail's kLanes x kWarps
// threads, the CUDA-core prologue's reduction order).
__global__ void __launch_bounds__(qmm_detail::kLanes * qmm_detail::kWarps)
group_norm_rows(const void* __restrict__ x,
                const __nv_bfloat16* __restrict__ nw, float eps, int din,
                __nv_bfloat16* __restrict__ xn) {
  __shared__ float rpart[qmm_detail::kWarps];
  const int tid = threadIdx.y * qmm_detail::kLanes + threadIdx.x;
  const size_t xr = (size_t)blockIdx.x * din;
  const float rinv = qmm_detail::rms_norm_rinv<kXBf16>(x, xr, din, eps, rpart);
  const int nthr = qmm_detail::kLanes * qmm_detail::kWarps;
  for (int k = tid; k < din; k += nthr)
    xn[xr + k] = __float2bfloat16_rn(qmm_detail::rms_norm_value(
        qmm_detail::load_x<kXBf16>(x, xr + k), rinv, nw, k));
}

// The RMSNorm pre-pass, then launch_mma's tile (PAIRED: the paired one).
template <int BITS, int NT, bool PAIRED = false>
cudaError_t launch_norm_mma(const void* x, const void* nw, void* xn,
                            const void* qw, const void* sc, bool sc_bf16,
                            void* out, float* part, int rows, int din,
                            int dout_p, int group, float eps, int splits,
                            cudaStream_t stream) {
  group_norm_rows<<<rows, dim3(qmm_detail::kLanes, qmm_detail::kWarps), 0,
                    stream>>>(x, static_cast<const __nv_bfloat16*>(nw), eps,
                              din, static_cast<__nv_bfloat16*>(xn));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_mma<BITS, kXBf16, NT, true, PAIRED>(
      xn, qw, sc, sc_bf16, out, part, rows, din, dout_p, group, splits,
      stream);
}

template <int BITS, int NT>
cudaError_t launch_ln_mma(const void* x, const void* gamma, const void* beta,
                          bool norm_bf16, void* xn, const void* qw,
                          const void* sc, bool sc_bf16, const void* bias,
                          bool bias_bf16, int nbias, void* out, float* part,
                          int rows, int din, int dout_p, int group,
                          float eps, int splits, cudaStream_t stream) {
  static SmemGrant granted;
  group_ln_norm_rows<<<rows, dim3(qmm_detail::kLanes, qmm_detail::kWarps), 0,
                       stream>>>(x, gamma, beta, norm_bf16, eps, din,
                                 static_cast<__nv_bfloat16*>(xn));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  e = launch_tile<BITS, NT>(
      qmm_group_ln_mma_kernel<BITS, NT>, &granted, rows, dout_p, splits,
      stream, static_cast<const uint16_t*>(xn),
      static_cast<const int8_t*>(qw), sc, sc_bf16, bias, bias_bf16, nbias,
      out, part, rows, din, dout_p, group, splits);
  if (e != cudaSuccess || splits == 1) return e;
  const size_t n = (size_t)rows * dout_p;
  group_ln_splitk_sum<<<sum_grid(n), 256, 0, stream>>>(
      part, splits, n, dout_p, bias, bias_bf16, nbias, out);
  return cudaGetLastError();
}

// The checks the C entries make on a launch of the tile.
bool tile_refuses(const void* x, const void* qw, const void* part, int rows,
                  int din, int dout_p, int bits, int group, int splits) {
  const int krows = bits == 4 ? din / 2 : din;
  return rows < 1 || group <= 0 || group % kBK || krows % group ||
         dout_p % 4 || splits < 1 || splits > krows / group ||
         (splits > 1 && !part) || reinterpret_cast<uintptr_t>(x) % 16 ||
         reinterpret_cast<uintptr_t>(qw) % 16;
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// x [rows, din] bf16 or f16 (x_kind kXBf16 or kXF16), 16-byte aligned; qw
// int8 [din/2 or din, dout_p] (unpaired), dout_p a multiple of 4; sc
// bf16/f32 [ng, dout_p]; group a multiple of 64 dividing the packed rows;
// row_tile 8, 16, 32 or 64 (rows per block); splits in [1, packed rows /
// group] (K split across blocks by whole groups), part f32 [splits, rows,
// dout_p] scratch when splits > 1; out [rows, dout_p] in x's type.
ITT_EXPORT int qmm_group_mma(const void* x, int x_kind, const void* qw,
                             const void* sc, int sc_bf16, void* part,
                             void* out, int rows, int din, int dout_p,
                             int bits, int group, int row_tile, int splits,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_refuses(x, qw, part, rows, din, dout_p, bits, group, splits))
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
#define ITT_MMA(B, XF, NT)                                                    \
  if (bits == B && x_kind == XF && row_tile == 8 * NT)                        \
    return (int)launch_mma<B, XF, NT>(x, qw, sc, sc_bf16, out, p, rows, din,  \
                                      dout_p, group, splits, s);
#define ITT_MMA_TILES(B, XF)                                                  \
  ITT_MMA(B, XF, 1) ITT_MMA(B, XF, 2) ITT_MMA(B, XF, 4) ITT_MMA(B, XF, 8)
  ITT_MMA_TILES(4, kXBf16) ITT_MMA_TILES(4, kXF16)
  ITT_MMA_TILES(8, kXBf16) ITT_MMA_TILES(8, kXF16)
#undef ITT_MMA_TILES
#undef ITT_MMA
  return (int)cudaErrorInvalidValue;
}

// x bf16 [rows, din], 16-byte aligned; qw, part, row_tile, splits as
// qmm_group_mma; sc bf16 (sc_bf16) or f32 [ng, dout_p]; out bf16 [rows,
// dout_p] = bf16(x @ bf16(q * s)), each weight scaled in f32 and rounded
// to bf16 before its product (the chunk kernel).
ITT_EXPORT int qmm_chunk_mma(const void* x, const void* qw, const void* sc,
                             int sc_bf16, void* part, void* out, int rows,
                             int din, int dout_p, int bits, int group,
                             int row_tile, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_refuses(x, qw, part, rows, din, dout_p, bits, group, splits))
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
#define ITT_CHUNK_MMA(B, NT, SB)                                              \
  if (bits == B && row_tile == 8 * NT && (sc_bf16 != 0) == SB)                \
    return (int)launch_chunk_mma<B, NT, SB>(x, qw, sc, out, p, rows, din,     \
                                            dout_p, group, splits, s);
#define ITT_CHUNK_MMA_TILES(B, SB)                                            \
  ITT_CHUNK_MMA(B, 1, SB) ITT_CHUNK_MMA(B, 2, SB) ITT_CHUNK_MMA(B, 4, SB)     \
  ITT_CHUNK_MMA(B, 8, SB)
  ITT_CHUNK_MMA_TILES(4, true) ITT_CHUNK_MMA_TILES(4, false)
  ITT_CHUNK_MMA_TILES(8, true) ITT_CHUNK_MMA_TILES(8, false)
#undef ITT_CHUNK_MMA_TILES
#undef ITT_CHUNK_MMA
  return (int)cudaErrorInvalidValue;
}

// x bf16 [rows, din]; nw bf16 [din], the RMSNorm weight; xn bf16 [rows,
// din] (16-byte aligned) buffer for the normalized rows; qw, sc, part,
// row_tile, splits as qmm_group_mma; out bf16 [rows, dout_p] =
// bf16(bf16(bf16(x * 1/sqrt(mean(x^2) + eps)) * nw) @ W).
ITT_EXPORT int qmm_group_norm_mma(const void* x, const void* nw, void* xn,
                                  const void* qw, const void* sc, int sc_bf16,
                                  void* part, void* out, int rows, int din,
                                  int dout_p, int bits, int group, float eps,
                                  int row_tile, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_refuses(xn, qw, part, rows, din, dout_p, bits, group, splits) ||
      !x || !nw)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
#define ITT_NORM_MMA(B, NT)                                                   \
  if (bits == B && row_tile == 8 * NT)                                        \
    return (int)launch_norm_mma<B, NT>(x, nw, xn, qw, sc, sc_bf16, out, p,    \
                                       rows, din, dout_p, group, eps, splits, \
                                       s);
  ITT_NORM_MMA(4, 1) ITT_NORM_MMA(4, 2) ITT_NORM_MMA(4, 4) ITT_NORM_MMA(4, 8)
  ITT_NORM_MMA(8, 1) ITT_NORM_MMA(8, 2) ITT_NORM_MMA(8, 4) ITT_NORM_MMA(8, 8)
#undef ITT_NORM_MMA
  return (int)cudaErrorInvalidValue;
}

// x bf16 [rows, din]; gamma, beta [din], both bf16 or (norm_bf16 = 0)
// both f32; xn bf16 [rows, din] (16-byte aligned) buffer for the
// normalized rows; qw, sc, part, row_tile, splits as qmm_group_mma; bias
// bf16 or f32 [nbias], nbias <= dout_p, or null with nbias 0; out bf16
// [rows, dout_p] = bf16(bf16(LN(x) @ W) + bias).
ITT_EXPORT int qmm_group_ln_mma(const void* x, const void* gamma,
                                const void* beta, int norm_bf16, void* xn,
                                const void* qw, const void* sc, int sc_bf16,
                                const void* bias, int bias_bf16, int nbias,
                                void* part, void* out, int rows, int din,
                                int dout_p, int bits, int group, float eps,
                                int row_tile, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_refuses(xn, qw, part, rows, din, dout_p, bits, group, splits) ||
      nbias < 0 || nbias > dout_p || (nbias > 0 && !bias))
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
#define ITT_LN_MMA(B, NT)                                                     \
  if (bits == B && row_tile == 8 * NT)                                        \
    return (int)launch_ln_mma<B, NT>(x, gamma, beta, norm_bf16, xn, qw, sc,   \
                                     sc_bf16, bias, bias_bf16, nbias, out, p, \
                                     rows, din, dout_p, group, eps, splits, s);
  ITT_LN_MMA(4, 1) ITT_LN_MMA(4, 2) ITT_LN_MMA(4, 4) ITT_LN_MMA(4, 8)
  ITT_LN_MMA(8, 1) ITT_LN_MMA(8, 2) ITT_LN_MMA(8, 4) ITT_LN_MMA(8, 8)
#undef ITT_LN_MMA
  return (int)cudaErrorInvalidValue;
}

// x [rows, din] bf16 or f16 (x_kind kXBf16 or kXF16), 16-byte aligned; qw
// int8 [din/2, dout_p], a paired int4 weight; sc bf16/f32 [din/2/group,
// dout_p], one scale row a packed group for both halves; part, row_tile,
// splits as qmm_group_mma; out [rows, dout_p] in x's type.
ITT_EXPORT int qmm_slab_mma(const void* x, int x_kind, const void* qw,
                            const void* sc, int sc_bf16, void* part,
                            void* out, int rows, int din, int dout_p,
                            int group, int row_tile, int splits,
                            void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_refuses(x, qw, part, rows, din, dout_p, 4, group, splits))
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
#define ITT_SLAB_MMA(XF, NT)                                                  \
  if (x_kind == XF && row_tile == 8 * NT)                                     \
    return (int)launch_mma<4, XF, NT, false, true>(                           \
        x, qw, sc, sc_bf16, out, p, rows, din, dout_p, group, splits, s);
  ITT_SLAB_MMA(kXBf16, 1) ITT_SLAB_MMA(kXBf16, 2) ITT_SLAB_MMA(kXBf16, 4)
  ITT_SLAB_MMA(kXBf16, 8) ITT_SLAB_MMA(kXF16, 1) ITT_SLAB_MMA(kXF16, 2)
  ITT_SLAB_MMA(kXF16, 4) ITT_SLAB_MMA(kXF16, 8)
#undef ITT_SLAB_MMA
  return (int)cudaErrorInvalidValue;
}

// x bf16 [rows, din]; nw bf16 [din]; xn bf16 [rows, din] (16-byte
// aligned) buffer for the normalized rows; qw, sc, part, row_tile, splits
// as qmm_slab_mma; out bf16 [rows, dout_p] = the paired tile over
// bf16(bf16(x * 1/sqrt(mean(x^2) + eps)) * nw).
ITT_EXPORT int qmm_slab_norm_mma(const void* x, const void* nw, void* xn,
                                 const void* qw, const void* sc, int sc_bf16,
                                 void* part, void* out, int rows, int din,
                                 int dout_p, int group, float eps,
                                 int row_tile, int splits, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (tile_refuses(xn, qw, part, rows, din, dout_p, 4, group, splits) ||
      !x || !nw)
    return (int)cudaErrorInvalidValue;
  float* p = static_cast<float*>(part);
#define ITT_SLAB_NORM_MMA(NT)                                                 \
  if (row_tile == 8 * NT)                                                     \
    return (int)launch_norm_mma<4, NT, true>(x, nw, xn, qw, sc, sc_bf16, out, \
                                             p, rows, din, dout_p, group,     \
                                             eps, splits, s);
  ITT_SLAB_NORM_MMA(1) ITT_SLAB_NORM_MMA(2) ITT_SLAB_NORM_MMA(4)
  ITT_SLAB_NORM_MMA(8)
#undef ITT_SLAB_NORM_MMA
  return (int)cudaErrorInvalidValue;
}
