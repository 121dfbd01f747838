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
//  * a balanced persistent grid (stream-K): the work is the list of units
//    (128-column tile t, packed scale group c), flattened t-major, U =
//    tiles x din / (2 group) of them; block b of the nb blocks (one an SM,
//    ring_plan) takes the contiguous share [b U / nb, (b + 1) U / nb), so
//    the shares differ by at most one unit whatever the tile count (wqkv
//    1536 units, 11-12 a block; w_gateup 2816, 21-22). The plan comes from
//    the shapes and the SM count only, so one captured graph serves every
//    step;
//  * a tile whose units lie in one block is written by it; a tile shared
//    by blocks leaves each block's f32 sum over its units in part[b][0]
//    (the block's first tile) or part[b][1] (its last), and once a block's
//    stream is done (one fence, none inside the ring) the last block to
//    arrive at a tile (a counter per tile, set back to 0 by that block: the
//    KSPLIT protocol of quant_matmul.cuh) sums them in block order and
//    writes the bf16 result. No atomics on values: results repeat bit for
//    bit;
//  * an asynchronous-copy ring: a stage is one 128-column tile's 128
//    packed rows (16 KB) and its two scale rows (lo and hi, 0.5 KB in
//    bf16, 1 KB in f32), 17,408 bytes a slot; kStages = 4 slots, so 3
//    stages (52,224 bytes) are in flight while the 16 warps decode the
//    fourth, against the ~25 KB an SM needs at 3.35 TB/s / 132 SMs and
//    about 1 us of latency. Each of the 512 threads issues its 16-byte
//    cp.async copies (4-byte ones where the columns are no multiple of 16),
//    one wait_group and one barrier a stage;
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
#include "mma_tile.cuh"
#include "quant_matmul.cuh"

namespace {

using mma_tile::cp_async16;
using mma_tile::cp_async4;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using qmm_detail::kLanes;
using qmm_detail::kWarps;

constexpr int kCols = 128;                    // output columns of a tile
constexpr int kRows = 128;                    // packed rows of a stage
constexpr int kStages = 4;                    // ring slots
constexpr int kThreads = kLanes * kWarps;     // 512: the prologue's block
constexpr int kRowsWarp = kRows / kWarps;     // 8 packed rows a warp
constexpr int kWBytes = kRows * kCols;        // 16 KB of packed weights
constexpr int kSBytes = 2 * kCols * 4;        // lo + hi scale rows (f32 max)
constexpr int kStageBytes = kWBytes + kSBytes;

inline size_t ring_smem(int din) {
  return (size_t)kStages * kStageBytes + sizeof(float) * ((size_t)din + kWarps * kCols);
}

// The block that owns unit u of U units over nb blocks (shares [b U / nb,
// (b + 1) U / nb)).
__device__ __forceinline__ int owner(int u, int U, int nb) {
  return (int)(((long long)(u + 1) * nb - 1) / U);
}

__device__ __forceinline__ int share_start(int b, int U, int nb) {
  return (int)((long long)b * U / nb);
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
                           int din, int dout_p, int group, float eps) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem;
  float* xs = reinterpret_cast<float*>(smem + kStages * kStageBytes);   // [din]
  float* red = xs + din;                                                // [kWarps][kCols]
  __shared__ float rpart[kWarps];
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int krows = din / 2, ngs = krows / group;   // packed rows, groups
  const int spg = group / kRows;                   // stages a group
  const int U = (dout_p + kCols - 1) / kCols * ngs;
  const int nb = gridDim.x, b = blockIdx.x;
  const int u0 = share_start(b, U, nb), u1 = share_start(b + 1, U, nb);
  const int n = (u1 - u0) * spg;                   // this block's stages
  constexpr int ssz = SCB ? 2 : 4;

  // a stage's place: tile t, its packed rows p0 .. p0 + kRows, their scale
  // group c (sg: the stage within the group). The copies and the consumer
  // each step through the stages in order, so no division runs a stage.
  struct Pos {
    int t, p0, c, sg;
  };
  const Pos first{u0 / ngs, u0 % ngs * group, u0 % ngs, 0};
  auto advance = [&](Pos& s) {
    s.p0 += kRows;
    if (++s.sg == spg) s.sg = 0, ++s.c;
    if (s.p0 == krows) s.p0 = 0, s.c = 0, ++s.t;
  };
  // this thread's 16-byte chunks of a stage: rows r16 and r16 + 64, bytes
  // cb16 .. cb16 + 15
  const int r16 = tid / (kCols / 16), cb16 = tid % (kCols / 16) * 16;
  static_assert(kRows * kCols / 16 == 2 * kThreads, "two 16-byte chunks a thread");

  // stage i of the block into slot i % kStages (i = 0, 1, ... in order): packed
  // rows p0 .. p0 + kRows of tile t, then the lo and hi scale rows of their
  // group (zero past dout_p)
  Pos ip = first;
  auto issue = [&](int i) {
    if (i >= n) return;
    const int t = ip.t, p0 = ip.p0, c = ip.c, col0 = t * kCols;
    advance(ip);
    unsigned char* st = ring + (i % kStages) * kStageBytes;
    const char* slo = static_cast<const char*>(sc) + ((size_t)c * dout_p + col0) * ssz;
    const char* shi = slo + (size_t)ngs * dout_p * ssz;
    if (A16) {
      const bool in = col0 + cb16 < dout_p;
      const int8_t* src = qw + (size_t)(p0 + r16) * dout_p + (in ? col0 + cb16 : 0);
      cp_async16(st + r16 * kCols + cb16, src, in ? 16 : 0);
      cp_async16(st + (r16 + kRows / 2) * kCols + cb16, src + (size_t)kRows / 2 * dout_p,
                 in ? 16 : 0);
      constexpr int per = kCols * ssz / 16;           // chunks a scale row
      if (tid < 2 * per) {
        const int h = tid / per, cb = tid % per * 16;
        const bool in = col0 + cb / ssz < dout_p;
        cp_async16(st + kWBytes + h * kCols * ssz + cb, in ? (h ? shi : slo) + cb : slo - col0 * ssz,
                   in ? 16 : 0);
      }
    } else {
      for (int k = tid; k < kRows * kCols / 4; k += kThreads) {
        const int r = k / (kCols / 4), cb = k % (kCols / 4) * 4;
        const bool in = col0 + cb < dout_p;
        cp_async4(st + r * kCols + cb,
                  qw + (size_t)(p0 + r) * dout_p + (in ? col0 + cb : 0), in ? 4 : 0);
      }
      constexpr int per = kCols * ssz / 4;
      for (int k = tid; k < 2 * per; k += kThreads) {
        const int h = k / per, cb = k % per * 4;
        const bool in = col0 + cb / ssz < dout_p;
        cp_async4(st + kWBytes + h * kCols * ssz + cb, in ? (h ? shi : slo) + cb : slo - col0 * ssz,
                  in ? 4 : 0);
      }
    }
  };

  // the first kStages - 1 stages go out before the row statistics
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue(i);
    cp_async_commit();
  }
  const float rinv = qmm_detail::rms_norm_rinv<kXBf16>(x, 0, din, eps, rpart);
  {
    // the x columns of this block's groups (a cyclic run of them), lo and hi
    const int g0 = u0 % ngs, gn = min(u1 - u0, ngs);
#pragma unroll 4
    for (int k = tid; k < gn * group; k += kThreads) {
      const int p = (g0 + k / group) % ngs * group + k % group;
      xs[p] = qmm_detail::rms_norm_value(qmm_detail::load_x<kXBf16>(x, p), rinv, nw, p);
      xs[krows + p] = qmm_detail::rms_norm_value(
          qmm_detail::load_x<kXBf16>(x, krows + p), rinv, nw, krows + p);
    }
  }

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int shared0 = -1, shared1 = -1;   // this block's tiles other blocks share
  // the 16 warps' sums of tile t: written (a tile of this block alone) or
  // left in part[b][slot] (slot 0: the block's first tile, 1: its last)
  auto flush = [&](int t) {
    *reinterpret_cast<float4*>(red + warp * kCols + lane * 4) =
        make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = 0.f;
    __syncthreads();
    const int col = t * kCols + tid;
    float s = 0.f;
    if (tid < kCols)
      for (int w = 0; w < kWarps; ++w) s += red[w * kCols + tid];
    if (t * ngs >= u0 && (t + 1) * ngs <= u1) {
      if (tid < kCols && col < dout_p) out[col] = __float2bfloat16_rn(s);
    } else {
      const int slot = t == u0 / ngs ? 0 : 1;
      if (tid < kCols) part[((size_t)b * 2 + slot) * kCols + tid] = s;
      (slot ? shared1 : shared0) = t;
    }
    __syncthreads();
  };

  Pos cpos = first;
  int tile = first.t;
  for (int i = 0; i < n; ++i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();          // stage i landed; slot (i - 1) % kStages is free
    issue(i + kStages - 1);
    cp_async_commit();
    const int t = cpos.t, p = cpos.p0 + warp * kRowsWarp;
    advance(cpos);
    if (t != tile) {
      flush(tile);
      tile = t;
    }
    const unsigned char* st = ring + (i % kStages) * kStageBytes;
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
    float sl[4], sh[4];
    if constexpr (SCB) {
      const uint2 a = *reinterpret_cast<const uint2*>(st + kWBytes + lane * 8);
      const uint2 h = *reinterpret_cast<const uint2*>(st + kWBytes + kCols * 2 + lane * 8);
      sl[0] = __uint_as_float(a.x << 16), sl[1] = __uint_as_float(a.x & 0xffff0000u);
      sl[2] = __uint_as_float(a.y << 16), sl[3] = __uint_as_float(a.y & 0xffff0000u);
      sh[0] = __uint_as_float(h.x << 16), sh[1] = __uint_as_float(h.x & 0xffff0000u);
      sh[2] = __uint_as_float(h.y << 16), sh[3] = __uint_as_float(h.y & 0xffff0000u);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(st + kWBytes + lane * 16);
      const float4 h = *reinterpret_cast<const float4*>(st + kWBytes + kCols * 4 + lane * 16);
      sl[0] = a.x, sl[1] = a.y, sl[2] = a.z, sl[3] = a.w;
      sh[0] = h.x, sh[1] = h.y, sh[2] = h.z, sh[3] = h.w;
    }
    // the partials hold the exact values times 1 or 256 (lo), 16 or 4096
    // (hi) by the column's byte within its pair: undone on the scale
#pragma unroll
    for (int j = 0; j < 4; ++j)
      acc[j] = fmaf(ph[j], sh[j] * (j & 1 ? 1.f / 4096.f : 1.f / 16.f),
                    fmaf(pl[j], sl[j] * (j & 1 ? 1.f / 256.f : 1.f), acc[j]));
  }
  if (n > 0) flush(tile);
  cp_async_wait<0>();
  // the shared tiles, once the stream is done (no fence stalls the ring):
  // the last of a tile's blocks to arrive sums their partials in block
  // order and writes the tile
  if (shared0 < 0 && shared1 < 0) return;
  // both shared tiles at once: thread 32 h signals the tile of slot h
  // (after the barrier that orders the block's stores of part, and a fence),
  // threads 128 h .. 128 h + 127 sum it where this block came last
  __syncthreads();
  __shared__ bool last2[2];
  if (lane == 0 && warp < 2) {
    const int t = warp ? shared1 : shared0;
    bool l = false;
    if (t >= 0) {
      __threadfence();
      l = atomicAdd(counters + t, 1) ==
          owner((t + 1) * ngs - 1, U, nb) - owner(t * ngs, U, nb);
      if (l) counters[t] = 0;
    }
    last2[warp] = l;
  }
  __syncthreads();
  const int h = tid / kCols, c = tid % kCols;
  if (h < 2 && last2[h]) {
    const int t = h ? shared1 : shared0;
    __threadfence();
    float v = 0.f;
    for (int o = owner(t * ngs, U, nb); o <= owner((t + 1) * ngs - 1, U, nb); ++o) {
      const int os = t == share_start(o, U, nb) / ngs ? 0 : 1;
      v += __ldcg(part + ((size_t)o * 2 + os) * kCols + c);
    }
    if (t * kCols + c < dout_p) out[t * kCols + c] = __float2bfloat16_rn(v);
  }
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
  kernel<<<blocks, dim3(kLanes, kWarps), smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(nw),
      static_cast<const int8_t*>(qw), sc, static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(part), static_cast<int*>(counters), din, dout_p, group, eps);
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
  if (din <= 0 || din % 2 || group <= 0 || group % kRows || krows % group ||
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
