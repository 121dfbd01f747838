// The one-row ring of the int4 group-dot matmuls, shared by
// qmm_group_norm_ring, qmm_slab_norm_ring and qmm_group2d_ring
// (quant_matmul_ring.cu) and qmm_w4a8_ring / qmm_norm_w4a8_ring
// (quant_matmul_w4a8_ring.cu): a balanced persistent grid over (128-column
// tile, packed scale group) units, an asynchronous-copy ring of stages,
// the merge of the tiles that blocks share, and the launch. Python side:
// kernels/quant_matmul.py ring_plan.
//
//  * stream-K: the work is the list of units (tile t, packed scale group
//    c), flattened t-major, U = tiles x din / (2 group) of them; block b of
//    the nb blocks (one an SM, ring_plan) takes the contiguous share
//    [b U / nb, (b + 1) U / nb), so the shares differ by at most one unit
//    whatever the tile count. The plan comes from the shapes and the SM
//    count only, so one captured graph serves every step;
//  * a stage is one tile's kRows packed rows (16 KB) and its group's two
//    scale rows (lo and hi, 0.5 KB in bf16, 1 KB in f32; PAIRED, the
//    paired layout of qmm_slab: the one scale row both halves share),
//    kStageBytes a slot; kStages slots, so kStages - 1 stages are in
//    flight while the 16 warps take the last one. Where the rows are
//    16-byte aligned (dout_p a multiple of 16) one thread issues a stage
//    as TMA tensor copies (the 128 x 128-byte weight box, the scale rows;
//    columns past dout_p zero-filled) that complete on the slot's
//    mbarrier; else each of the 512 threads issues its 4-byte cp.async
//    copies. One wait and one barrier a stage;
//  * a tile whose units lie in one block is written by it; a tile shared
//    by blocks leaves each block's f32 sum over its units in part[b][0]
//    (the block's first tile) or part[b][1] (its last), and once a block's
//    stream is done (no fence inside the ring) the last block to arrive at
//    a tile (a counter per tile, set back to 0 by that block: the KSPLIT
//    protocol of quant_matmul.cuh, with one acquire-release atomic a tile
//    in place of a release fence, an atomic and an acquire fence: one
//    round trip to L2 instead of three) sums them in block order and
//    writes the tile. No atomics on values: results repeat bit for bit;
//  * the launch (launch below) is a programmatic dependent launch: a block
//    may start while the kernel before it on the stream still runs, and
//    does there only what no earlier kernel can change: it initializes its
//    mbarriers, prefetches its tensor maps and issues its first kStages - 1
//    weight and scale stages (the model's constants; what the kernel just
//    before this launch writes need not be visible to these copies yet,
//    so that kernel must not be the one that writes qw or sc). Then
//    griddepcontrol.wait (the earlier kernels done, their writes
//    visible) comes before any read of x or nw and any touch of part,
//    counters or out, so consecutive ring launches on a stream share the
//    tile counters safely; and each block lets the next kernel launch
//    (griddepcontrol.launch_dependents), whose own wait keeps it off this
//    kernel's results. The fixed cost a launch pays before its first
//    weight arrives (PERF.md section 6, tools/ring_variants.py) overlaps
//    the kernel before it. Stream capture takes the launch as a
//    programmatic edge of the graph; where it refuses, the launch fails.
#pragma once

#include <cuda.h>

#include "mma_tile.cuh"
#include "quant_matmul.cuh"

namespace ring {

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
constexpr size_t kRingBytes = (size_t)kStages * kStageBytes;

// The TMA tensor maps of a launch whose rows are 16-byte aligned: the
// packed weights qw int8 [krows, dout_p] in boxes of kRows x kCols, and the
// scales sc [srows, dout_p] (2 ngs rows, PAIRED ngs) in boxes of one row of
// kCols.
struct Maps {
  CUtensorMap w, s;
};

// Encode `m` for qw and sc (scales of ssz bytes; the host side of a
// launch). cudaErrorNotSupported where no cuTensorMapEncodeTiled entry
// point is found, cudaErrorInvalidValue where it refuses.
inline cudaError_t encode_maps(Maps* m, const void* qw, const void* sc, int ssz, int krows,
                               int dout_p, int srows) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault) !=
            cudaSuccess || !fn)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint32_t one[2] = {1, 1};
  const cuuint64_t wdim[2] = {(cuuint64_t)dout_p, (cuuint64_t)krows};
  const cuuint64_t wstride[1] = {(cuuint64_t)dout_p};
  const cuuint32_t wbox[2] = {kCols, kRows};
  const cuuint64_t sdim[2] = {(cuuint64_t)dout_p, (cuuint64_t)srows};
  const cuuint64_t sstride[1] = {(cuuint64_t)dout_p * ssz};
  const cuuint32_t sbox[2] = {kCols, 1};
  if (encode(&m->w, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(qw), wdim, wstride,
             wbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS ||
      encode(&m->s, ssz == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
             2, const_cast<void*>(sc), sdim, sstride, sbox, one, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(mma_tile::smem_addr(bar)),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   mma_tile::smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` of bar to complete. A stage lands in
// microseconds; a wait that outlasts kWaitTries tries (seconds) traps, so a
// copy that never completes fails the launch instead of hanging the card.
constexpr uint32_t kWaitTries = 1u << 24;
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done = 0;
  for (uint32_t n = 0; !done; ++n) {
    if (n == kWaitTries) __trap();
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(mma_tile::smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// A TMA copy of the box at (x, y) (x the column) of `map` into dst,
// completing on bar.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map, int x, int y,
                                       uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(mma_tile::smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(x), "r"(y), "r"(mma_tile::smem_addr(bar))
      : "memory");
}

// Bring a tensor map (a __grid_constant__ parameter) into the cache of
// tensor maps ahead of its first copy.
__device__ __forceinline__ void prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// Programmatic dependent launch, device side: wait until the kernels before
// this one on the stream are done and their writes visible (a no-op in a
// launch without the attribute), and let the next kernel launch.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// The first 128-byte boundary at or after p in shared memory: TMA boxes
// land on one; a launch asks for kAlignPad bytes beyond its layout.
constexpr int kAlignPad = 128;
__device__ __forceinline__ unsigned char* aligned(unsigned char* p) {
  return p + ((kAlignPad - (mma_tile::smem_addr(p) & (kAlignPad - 1))) & (kAlignPad - 1));
}

// *p += 1 at gpu scope with acquire-release order, returning the old value:
// the tile counters' arrival. Its release side (after the barrier that
// orders the block's stores) publishes the block's partials; its acquire
// side (before the barrier that hands them on) lets the last block read
// the others'.
__device__ __forceinline__ int arrive_acq_rel(int* p) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;\n" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// The block that owns unit u of U units over nb blocks (shares [b U / nb,
// (b + 1) U / nb)).
__device__ __forceinline__ int owner(int u, int U, int nb) {
  return (int)(((long long)(u + 1) * nb - 1) / U);
}

__device__ __forceinline__ int share_start(int b, int U, int nb) {
  return (int)((long long)b * U / nb);
}

// A stage's place: tile t, its packed rows p0 .. p0 + kRows, their scale
// group c (sg: the stage within the group).
struct Pos {
  int t, p0, c, sg;
};

// This block's share [u0, u1) of the U units and its n stages. The copies
// and the consumer each step through the stages in order (advance), so no
// division runs a stage.
struct Share {
  int krows, group, ngs, spg, U, nb, b, u0, u1, n;

  __device__ Share(int din, int dout_p, int group_)
      : krows(din / 2), group(group_), ngs(krows / group_),
        spg(group_ / kRows), U((dout_p + kCols - 1) / kCols * ngs),
        nb(gridDim.x), b(blockIdx.x), u0(share_start(b, U, nb)),
        u1(share_start(b + 1, U, nb)), n((u1 - u0) * spg) {}

  __device__ Pos first() const { return {u0 / ngs, u0 % ngs * group, u0 % ngs, 0}; }

  __device__ void advance(Pos& s) const {
    s.p0 += kRows;
    if (++s.sg == spg) s.sg = 0, ++s.c;
    if (s.p0 == krows) s.p0 = 0, s.c = 0, ++s.t;
  }

  // tile t's units all lie in this share
  __device__ bool alone(int t) const { return t * ngs >= u0 && (t + 1) * ngs <= u1; }
};

// Stage i of the share (i = 0, 1, ... in order; ip its place, advanced)
// into slot i % kStages: packed rows p0 .. p0 + kRows of tile t of qw int8
// [krows, dout_p], then the lo and hi scale rows of their group c of sc
// [2 ngs, dout_p] (PAIRED: the one row c of sc [ngs, dout_p]; SSZ bytes a
// scale), zero past dout_p. A16: the rows are 16-byte aligned (dout_p % 16
// == 0), and thread 0 copies the stage with TMA (maps) onto the slot's
// mbarrier full[i % kStages].
template <bool A16, int SSZ, bool PAIRED = false>
__device__ __forceinline__ void issue(unsigned char* slots, int i, const Share& sh, Pos& ip,
                                      const int8_t* __restrict__ qw, const void* __restrict__ sc,
                                      int dout_p, const Maps& maps, uint64_t* full) {
  if (i >= sh.n) return;
  const int tid = threadIdx.y * kLanes + threadIdx.x;
  const int t = ip.t, p0 = ip.p0, c = ip.c, col0 = t * kCols;
  sh.advance(ip);
  unsigned char* st = slots + (i % kStages) * kStageBytes;
  if constexpr (A16) {
    if (tid == 0) {
      uint64_t* bar = full + i % kStages;
      mbar_expect_tx(bar, kWBytes + (PAIRED ? 1 : 2) * kCols * SSZ);
      tma_2d(st, &maps.w, col0, p0, bar);
      tma_2d(st + kWBytes, &maps.s, col0, c, bar);
      if (!PAIRED) tma_2d(st + kWBytes + kCols * SSZ, &maps.s, col0, sh.ngs + c, bar);
    }
  } else {
    const char* slo = static_cast<const char*>(sc) + ((size_t)c * dout_p + col0) * SSZ;
    const char* shi = slo + (size_t)sh.ngs * dout_p * SSZ;
    for (int k = tid; k < kRows * kCols / 4; k += kThreads) {
      const int r = k / (kCols / 4), cb = k % (kCols / 4) * 4;
      const bool in = col0 + cb < dout_p;
      cp_async4(st + r * kCols + cb, qw + (size_t)(p0 + r) * dout_p + (in ? col0 + cb : 0),
                in ? 4 : 0);
    }
    constexpr int per = kCols * SSZ / 4;
    for (int k = tid; k < (PAIRED ? 1 : 2) * per; k += kThreads) {
      const int h = k / per, cb = k % per * 4;
      const bool in = col0 + cb / SSZ < dout_p;
      cp_async4(st + kWBytes + h * kCols * SSZ + cb, in ? (h ? shi : slo) + cb : slo - col0 * SSZ,
                in ? 4 : 0);
    }
  }
}

// A stage's lo and hi scale rows at this lane's columns 4 l .. 4 l + 3, as
// f32 (SCB: stored bf16; PAIRED: its one row, both halves' scale).
template <bool SCB, bool PAIRED = false>
__device__ __forceinline__ void stage_scales(const unsigned char* st, float (&sl)[4],
                                             float (&sh)[4]) {
  // row r (0: lo, 1: hi) at this lane's columns into v
  auto row = [&](int r, float(&v)[4]) {
    const int lane = threadIdx.x;
    if constexpr (SCB) {
      const uint2 a = *reinterpret_cast<const uint2*>(st + kWBytes + r * kCols * 2 + lane * 8);
      v[0] = __uint_as_float(a.x << 16), v[1] = __uint_as_float(a.x & 0xffff0000u);
      v[2] = __uint_as_float(a.y << 16), v[3] = __uint_as_float(a.y & 0xffff0000u);
    } else {
      const float4 a = *reinterpret_cast<const float4*>(st + kWBytes + r * kCols * 4 + lane * 16);
      v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    }
  };
  row(0, sl);
  row(PAIRED ? 0 : 1, sh);
}

// The 16 warps' sums of tile t (acc: this lane's 4 columns, zeroed), in
// warp order through red f32 [kWarps][kCols]: written with write(col, sum)
// where the tile lies in this share alone, else left in part[b][slot]
// (slot 0: the share's first tile, 1: its last), shared[slot] = t.
template <typename Write>
__device__ __forceinline__ void flush(float (&acc)[4], float* red, float* __restrict__ part,
                                      int t, const Share& sh, int (&shared)[2], int dout_p,
                                      Write write) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  *reinterpret_cast<float4*>(red + warp * kCols + lane * 4) =
      make_float4(acc[0], acc[1], acc[2], acc[3]);
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = 0.f;
  __syncthreads();
  const int col = t * kCols + tid;
  float s = 0.f;
  if (tid < kCols)
    for (int w = 0; w < kWarps; ++w) s += red[w * kCols + tid];
  if (sh.alone(t)) {
    if (tid < kCols && col < dout_p) write(col, s);
  } else {
    const int slot = t == sh.u0 / sh.ngs ? 0 : 1;
    if (tid < kCols) part[((size_t)sh.b * 2 + slot) * kCols + tid] = s;
    (slot ? shared[1] : shared[0]) = t;
  }
  __syncthreads();
}

// The block's whole stream: the first kStages - 1 stages go out, then
// (after grid_dependency_wait: launch's order) prologue() runs while they
// land; each stage i then waits for its slot
// (wait_group, one barrier: slot (i - 1) % kStages is free), issues stage
// i + kStages - 1 and is consumed by consume(st, pos, acc) (st: its slot;
// acc: this lane's 4 column sums of the tile), each tile flushed when the
// stream leaves it; once done (no fence stalls the ring) the last of a
// shared tile's blocks to arrive sums the partials in block order and
// writes the tile with write(col, sum). part f32 [gridDim.x, 2, kCols];
// counters int32 [tiles], zero, and zero again after.
template <bool A16, int SSZ, bool PAIRED = false, typename Prologue, typename Consume,
          typename Write>
__device__ __forceinline__ void stream(unsigned char* slots, float* red,
                                       const int8_t* __restrict__ qw,
                                       const void* __restrict__ sc, const Maps& maps,
                                       float* __restrict__ part, int* __restrict__ counters,
                                       const Share& sh, int dout_p, Prologue prologue,
                                       Consume consume, Write write) {
  const int lane = threadIdx.x, warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  __shared__ __align__(8) uint64_t full[kStages];     // the slots' mbarriers (A16)
  if constexpr (A16) {
    if (tid == 0) {
      prefetch_map(&maps.w);
      prefetch_map(&maps.s);
      for (int s = 0; s < kStages; ++s) mbar_init(full + s, 1);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    }
    __syncthreads();
  }
  Pos ip = sh.first();
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) {
    issue<A16, SSZ, PAIRED>(slots, i, sh, ip, qw, sc, dout_p, maps, full);
    cp_async_commit();
  }
  grid_dependency_wait();     // from here the earlier kernels' writes are seen
  launch_dependents();
  prologue();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  int shared[2] = {-1, -1};   // this block's tiles other blocks share
  Pos cpos = sh.first();
  int tile = cpos.t;
  for (int i = 0; i < sh.n; ++i) {
    if constexpr (A16)
      mbar_wait(full + i % kStages, i / kStages & 1);
    else
      cp_async_wait<kStages - 2>();
    __syncthreads();          // stage i landed; slot (i - 1) % kStages is free
    issue<A16, SSZ, PAIRED>(slots, i + kStages - 1, sh, ip, qw, sc, dout_p, maps, full);
    cp_async_commit();
    const Pos at = cpos;
    sh.advance(cpos);
    if (at.t != tile) {
      flush(acc, red, part, tile, sh, shared, dout_p, write);
      tile = at.t;
    }
    consume(slots + (i % kStages) * kStageBytes, at, acc);
  }
  if (sh.n > 0) flush(acc, red, part, tile, sh, shared, dout_p, write);
  cp_async_wait<0>();
  if (shared[0] < 0 && shared[1] < 0) return;
  // both shared tiles at once: thread 32 h signals the tile of slot h
  // (after the barrier that orders the block's stores of part: the
  // counter's acquire-release atomic), and where this block came last the
  // same atomic acquires the other blocks' partials for threads 128 h ..
  // 128 h + 127 to sum
  __syncthreads();
  __shared__ bool last2[2];
  if (lane == 0 && warp < 2) {
    const int t = warp ? shared[1] : shared[0];
    bool l = false;
    if (t >= 0) {
      l = arrive_acq_rel(counters + t) ==
          owner((t + 1) * sh.ngs - 1, sh.U, sh.nb) - owner(t * sh.ngs, sh.U, sh.nb);
      if (l) counters[t] = 0;
    }
    last2[warp] = l;
  }
  __syncthreads();
  const int h = tid / kCols, c = tid % kCols;
  if (h < 2 && last2[h]) {
    const int t = h ? shared[1] : shared[0];
    float v = 0.f;
    for (int o = owner(t * sh.ngs, sh.U, sh.nb); o <= owner((t + 1) * sh.ngs - 1, sh.U, sh.nb);
         ++o) {
      const int os = t == share_start(o, sh.U, sh.nb) / sh.ngs ? 0 : 1;
      v += __ldcg(part + ((size_t)o * 2 + os) * kCols + c);
    }
    if (t * kCols + c < dout_p) write(t * kCols + c, v);
  }
}

// Launch kernel over `blocks` blocks of kLanes x kWarps threads with smem
// bytes of dynamic shared memory on stream, as a programmatic dependent
// launch (stream()'s order makes it safe; see above). The error of the
// launch itself: a refused attribute fails it.
template <typename... P, typename... A>
cudaError_t launch(void (*kernel)(P...), int blocks, size_t smem, cudaStream_t stream,
                   A&&... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kLanes, kWarps);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<A&&>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace ring
