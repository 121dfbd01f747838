// Band matmuls of Longformer local attention in their ring form,
// hand-written for Hopper (sm_90a). Python wrappers: kernels/band.py
// g2bmm_band, gbmm_band (band_form answers "ring").
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/band.py:
//   g2bmm_ring <- _g2bmm_kernel (:44, via g2bmm_band :109-130)
//   gbmm_ring  <- _gbmm_kernel  (:68, via gbmm_band  :133-154)
// band.cu keeps the first CUDA forms (one FMA per two shared loads, the
// window staged whole), forced only as the yardstick, and the route of
// what this form does not take (a mixed bf16 / f32 pair, k not a multiple
// of 8 from 8 to 256).
//
// What they compute (dilation 1; J = 2w + 1 band columns):
//   g2bmm: out[b, i, j] = sum_k A[b, i, k] * B[b, i + j - w, k], 0 where
//          i + j - w falls outside [0, m); f32 sums rounded to A's type;
//   gbmm:  out[b, i, k] = sum_j W[b, i, j] * B[b, i + j - w, k], the terms
//          whose i + j - w falls outside [0, m) left out; f32 sums rounded
//          to B's type.
// Both operands are bf16, or both f32.
//
// What bounds them on this card: each of a block's 64 rows takes k
// (g2bmm) or J (gbmm) multiply-adds against window rows the block shares,
// so at the Longformer shapes (k 64-128, w 64-256) the work is 42-50
// operations per device byte, far under the ~295 of the bf16 tensor
// cores: the bytes (A or W, B, out, each once) are the floor, 0.0038 ms
// at phase 13's bf16 shape and 0.0188 ms at Longformer-base; the band
// tensor [bz, m, J] is most of them (50.4 of 63.0 MB at Longformer-base).
// In f32 the FMA units (67 TFLOP/s) bound it.
//
// Design. The TPU kernel held three R-row blocks of B in VMEM and walked
// the 2w + 1 diagonals in a static unroll; here the band is cut into
// matmul tiles for the tensor cores:
//  - A block of 4 warps owns 64 consecutive rows of one batch row, 16 a
//    warp (mma.sync M = 16). Window column c is B's row r0 - w + c; the
//    block's rows reach c in [0, nrows + 2w), of which [c_lo, c_hi) are
//    rows of B.
//  - The window streams: B's rows pass through a ring of kStages = 2
//    tiles of 64 rows x k by 16-byte cp.async, zero-filled through the
//    copy's src-size outside [c_lo, c_hi) and in the columns k .. kp (kp:
//    k rounded up to 32), as flash_attention.cu does for its K / V ring.
//    Tile t + 1 is in flight while tile t's products run; one wait and
//    one barrier a tile. Nothing of the window, nor of the band, is held
//    whole, so shared memory does not grow with w and no w is refused for
//    its size. (A third stage holds fewer blocks an SM:
//    tools/band_variants.py "three_stages".)
//  - Only the band is computed: warp rows [i0, i0 + 16) reach window
//    columns [i0, i0 + 16 + 2w); a warp skips the tiles, the n8 column
//    groups (g2bmm) and the k16 steps (gbmm) outside that range (and
//    outside [c_lo, c_hi)), so its products are (16 + 2w) / (2w + 1) of the
//    useful work (1.12x at w 64, 1.03x at w 256).
//  - The shear between (row i, window column c) and band column j = c - i
//    moves a row's 64 columns of a tile at once: row i's band columns
//    c0 - i .. c0 - i + 63 are one contiguous piece of the band tensor
//    [bz, m, J]. The walk starts at a column where that piece is aligned
//    (one to seven columns early at most, outside the band): as J is odd
//    a bf16 pair (c, c + 1) is then an aligned word in every row, and
//    when w is a multiple of 4 an 8-column chunk is 16 bytes on a 16-byte
//    boundary in every row.
//  - g2bmm (bf16): Q.K^T as in flash_attention.cu: the warp's A fragments
//    ([64 x k] A tile staged once by 16-byte cp.async, ldmatrix once) in
//    registers, each window tile's rows the col-major B operand
//    (ldmatrix), mma.sync m16n8k16, f32 sums; the scores rounded once to
//    bf16 into a per-warp [16 x 64] stage, then stored a row at a time, a
//    word a lane: 128 contiguous bytes a store. Every band element of the
//    block's rows is written (0 where c is no row of B), so nothing zeroes
//    the output first. Through the stage, not from the fragments, whose
//    stores go 16 bytes to a row, 8 rows apart (tools/band_variants.py
//    "fragments"); drafts that built a [64 x J] output tile in shared
//    memory and stored it as one span (fewer blocks an SM), or stored
//    16-byte chunks of 4 rows at a time, were slower at Longformer-base.
//  - gbmm (bf16): P.V as in flash_attention.cu. P[i, c] = W[r0 + i, c - i]
//    inside the band and 0 outside it and where c is no row of B comes
//    through a second ring, beside the window's: each stage is the
//    sheared [64 x 64] P tile copied from W by cp.async, 16 bytes (8
//    columns) a copy when w is a multiple of 4, else 4 bytes (a pair). A
//    copy's src-size is 0 where it holds no term and covers only the
//    terms of one that starts on a term; the one copy a row that starts
//    before the row's first term is made whole (its bytes lie in 16-byte
//    segments that hold W's elements) and its warp zeroes what it holds
//    outside the terms once it lands. P is read with ldmatrix as the A
//    operand, the window tile through ldmatrix.trans as the B operand;
//    [16 x kp] f32 sums a warp, rounded once to B's type. A draft that
//    staged the block's [64 x J] W tile whole, as one span, held 2 blocks
//    an SM at Longformer-base and was slower; tools/band_variants.py
//    "pairs" times the 4-byte copies at every w.
//  - f32 (both ops): the same rings and walk, the tiles at a row stride of
//    kp + 4 floats, with a register-tiled FMA consumer, not TF32 (its
//    10-bit mantissa cannot hold 1e-5 of max|plain|): a lane owns 4 rows x
//    8 window columns (g2bmm; 32 FMAs per 3 16-byte loads) or 4 rows x
//    kp / 8 output columns (gbmm; 4 * kp / 8 FMAs per 4 scalar and kp / 32
//    16-byte loads), each quarter-warp's 16-byte loads on 8 distinct bank
//    groups; W comes in 4-byte copies, one element each.
//
// Shared memory a block (bytes; the card gives 233,472 an SM, 1,024 of it
// reserved a block), independent of w: at k 128 (phase 13) bf16 g2bmm
// 34,816 ring + 17,408 A + 9,216 stages = 61,440 (3 blocks an SM), gbmm
// 34,816 + 18,432 P ring = 53,248 (4); at k 64 (Longformer-base) 36,864
// each (6). f32 at k 128: 118,272 (1 an SM) and 101,376 (2). nvcc
// -Xptxas -v prints the registers (55-168 a thread by op and k).
#include <type_traits>

#include "mma_tile.cuh"

namespace {

using mma_tile::cp_async16;
using mma_tile::cp_async4;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::ldsm_x4;
using mma_tile::ldsm_x4_t;
using mma_tile::mma16816;
using mma_tile::pack_out;
using mma_tile::smem_addr;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;              // rows a block, window columns a tile
constexpr int kWarps = 4;              // 16 rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxW = 1 << 20;
constexpr int kG2 = 0, kG = 1;         // the op: g2bmm, gbmm

template <typename T>
__host__ __device__ constexpr bool is_f32() { return std::is_same<T, float>::value; }
constexpr int kStages = 2;             // window tiles (and P tiles) in flight
// Row stride (elements) of a tile 64 window columns wide (g2bmm's stages,
// gbmm's P tiles): bf16 rows 144 bytes apart (ldmatrix and a fragment's
// 32-bit stores without conflicts), f32 66 words (a lane's 4 rows on
// distinct banks).
template <typename T>
__host__ __device__ constexpr int pitch() { return is_f32<T>() ? 66 : 72; }
// Elements a 16-byte copy.
template <typename T>
__host__ __device__ constexpr int vec() { return 16 / (int)sizeof(T); }

// A block's shared memory: the window ring at 0, g2bmm's A tile at a,
// then g2bmm's 4 warp stages or gbmm's P ring at sp (byte offsets).
struct Layout {
  int kp, ld;   // k rounded up to 32; a window row's stride (elements)
  int a, sp, bytes;
};

template <typename T, int OP>
__host__ __device__ inline Layout layout(int k) {
  Layout L;
  L.kp = (k + 31) & ~31;
  L.ld = L.kp + vec<T>();     // bf16 rows 16 bytes past a 64-byte multiple
  const int tile = kRows * L.ld * (int)sizeof(T);
  L.a = kStages * tile;
  L.sp = L.a + (OP == kG2 ? tile : 0);
  L.bytes = L.sp + (OP == kG2 ? 1 : kStages) * kRows * pitch<T>() * (int)sizeof(T);
  return L;
}

// How many elements p lies past a 16-byte boundary.
template <typename T>
__device__ __forceinline__ int misalign(const T* p) {
  return (int)((reinterpret_cast<uintptr_t>(p) / sizeof(T)) & (vec<T>() - 1));
}

// Whether the window tile at c0 holds a row of B.
__device__ __forceinline__ bool has_rows(int c0, int c_lo, int c_hi) {
  return c0 + kRows > c_lo && c0 < c_hi;
}

// Stage rows c0 .. c0 + 63 of a [., k] operand as rows of kp columns
// (stride ld): row c is src row g0 + c when c_lo <= c < c_hi, zeros
// otherwise and past column k. 16-byte cp.async (the caller commits).
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, const T* src, int c0, int c_lo,
                                          int c_hi, int g0, int k, int kp, int ld) {
  constexpr int E = vec<T>();
  const int cpr = kp / E;
  for (int i = threadIdx.x; i < kRows * cpr; i += kThreads) {
    const int r = i / cpr, col = (i - r * cpr) * E, c = c0 + r;
    const bool ok = c >= c_lo && c < c_hi && col < k;
    cp_async16(dst + r * ld + col, ok ? src + (size_t)(g0 + c) * k + col : src,
               ok ? 16 : 0);
  }
}

// Stage gbmm's P tile at c0 (stride pitch): P[r][c - c0] = W[r][c - r]
// for the window columns c of row r's terms, [max(r, c_lo), min(r + 2w,
// c_hi - 1)], 0 elsewhere; wb is the block's first W row, dummy any
// 16-byte aligned address (read by no copy). With gran 8 (bf16, w a
// multiple of 4: every row of W then sits at one alignment, and c0 puts
// each 8-column chunk on 16 bytes) 16-byte cp.async of a row's chunks;
// else 4-byte ones, a bf16 pair or one f32 a copy. The src-size is 0
// for a copy of no term and covers only the terms of one that starts on
// a term; a copy that starts before the row's first term is made whole,
// and g_tile_bf16 zeroes what it holds outside the terms.
template <typename T>
__device__ __forceinline__ void load_p_tile(T* dst, const T* wb, const T* dummy,
                                            int c0, int nrows, int c_lo, int c_hi,
                                            int w, int J, int gran) {
  constexpr int P = pitch<T>();
  if (!is_f32<T>() && gran == 8) {
    for (int q = threadIdx.x; q < kRows * 8; q += kThreads) {
      const int r = q >> 3, c = c0 + 8 * (q & 7);
      const int lo = max(r, c_lo), hi = min(r + 2 * w, c_hi - 1);
      int bytes = 0;
      if (r < nrows && lo <= c + 7 && hi >= c)
        bytes = lo <= c ? 2 * (min(hi, c + 7) - c + 1) : 16;
      cp_async16(dst + r * P + (c - c0), bytes ? wb + (size_t)r * J + (c - r) : dummy,
                 bytes);
    }
    return;
  }
  // a thread copies one column (pair) of rows r0t, r0t + rstep, ...
  constexpr int per = is_f32<T>() ? 1 : 2;
  constexpr int cpr = kRows / per, rstep = kThreads / cpr;
  const int q = threadIdx.x % cpr, c = c0 + q * per, r0t = threadIdx.x / cpr;
  const bool in0 = c >= c_lo && c < c_hi, in1 = per == 2 && c + 1 >= c_lo && c + 1 < c_hi;
  T* d = dst + r0t * P + q * per;
  const T* src = wb + (size_t)r0t * J + (c - r0t);   // element (r, c - r)
  for (int r = r0t; r < kRows; r += rstep, d += rstep * P, src += (size_t)rstep * (J - 1)) {
    const int j = c - r;
    const bool v0 = in0 && r < nrows && j >= 0 && j <= 2 * w;
    const bool v1 = in1 && r < nrows && j + 1 >= 0 && j + 1 <= 2 * w;
    const int bytes = v0 ? (v1 || per == 1 ? 4 : 2) : (v1 ? 4 : 0);
    cp_async4(d, bytes ? src : dummy, bytes);
  }
}

// What a warp's consumer reads of the walk.
struct Walk {
  int lane, i0, nrows, w, J, k, kp, ld, c_lo, c_hi;
  int lo, hi;   // the window columns with terms for this warp's rows: [lo, hi]
  int gran;     // columns of a band-tensor copy or store: 1 (f32), 2 or 8
};

// Whether window column c is band element (i, c - i) of row i.
__device__ __forceinline__ bool in_band(const Walk& x, int i, int c) {
  return i < x.nrows && c - i >= 0 && c - i <= 2 * x.w;
}
// Whether window column c is a row of B (inside [c_lo, c_hi)).
__device__ __forceinline__ bool in_rows(const Walk& x, int c) {
  return c >= x.c_lo && c < x.c_hi;
}
// Whether every (row, column) of the warp's 16 rows by the 64 window
// columns from c0 is a band element with a row of B: the stores then
// check nothing.
__device__ __forceinline__ bool interior(const Walk& x, int c0) {
  return x.i0 + 16 <= x.nrows && c0 >= x.i0 + 15 && c0 + kRows - 1 <= x.i0 + 2 * x.w &&
         c0 >= x.c_lo && c0 + kRows <= x.c_hi;
}

constexpr int kPitchWords = pitch<bf16>() / 2;

// g2bmm, bf16: the warp's scores against the window tile at c0 (rows
// i0 .. i0 + 15 by columns c0 .. c0 + 63), rounded to bf16 into its stage,
// then stored a row a step, a word a lane, to band (the block's first
// output row): element (i, c - i).
template <int KP>
__device__ __forceinline__ void g2_tile_bf16(const Walk& x,
                                             const uint32_t (&qa)[KP / 16][4],
                                             const bf16* tb, bf16* st, bf16* band,
                                             int c0) {
  const int lane = x.lane, g = lane >> 2, t4 = lane & 3;
  uint32_t* sw = reinterpret_cast<uint32_t*>(st);
  __syncwarp();   // the last tile's stores have read the stage
#pragma unroll
  for (int f = 0; f < 8; ++f) {   // window columns c0 + 8f .. + 7
    float s[4] = {0.f, 0.f, 0.f, 0.f};
    const int fc = c0 + 8 * f;
    if (fc <= x.hi && fc + 7 >= x.lo) {
#pragma unroll
      for (int k2 = 0; k2 < KP / 32; ++k2) {
        if (32 * k2 >= x.kp) break;
        // matrices: window rows fc .. fc + 7 x columns 32 k2 + 8i (i = lane / 8)
        uint32_t bq[4];
        ldsm_x4(bq, smem_addr(tb + (8 * f + (lane & 7)) * x.ld + 32 * k2 +
                              8 * (lane >> 3)));
        mma16816<kXBf16>(s, qa[2 * k2], bq[0], bq[1]);
        mma16816<kXBf16>(s, qa[2 * k2 + 1], bq[2], bq[3]);
      }
    }
    sw[g * kPitchWords + 4 * f + t4] = pack_out<kXBf16>(s[0], s[1]);
    sw[(g + 8) * kPitchWords + 4 * f + t4] = pack_out<kXBf16>(s[2], s[3]);
  }
  __syncwarp();
  const int c = c0 + 2 * lane;
  if (interior(x, c0)) {
#pragma unroll
    for (int ii = 0; ii < 16; ++ii)
      *reinterpret_cast<uint32_t*>(band + (size_t)(x.i0 + ii) * x.J + (c - x.i0 - ii)) =
          sw[ii * kPitchWords + lane];
    return;
  }
  // every band element of the rows is written: 0 where c is no row of B
  const uint32_t keep = (in_rows(x, c) ? 0xffffu : 0u) | (in_rows(x, c + 1) ? 0xffff0000u : 0u);
  for (int ii = 0; ii < 16; ++ii) {
    const int i = x.i0 + ii;
    const bool v0 = in_band(x, i, c), v1 = in_band(x, i, c + 1);
    if (!(v0 || v1)) continue;
    const uint32_t word = sw[ii * kPitchWords + lane] & keep;
    bf16* d = band + (size_t)i * x.J + (c + 1 - i);   // element (i, j + 1)
    if (v0 && v1)
      *reinterpret_cast<uint32_t*>(d - 1) = word;
    else if (v0)
      *reinterpret_cast<uint16_t*>(d - 1) = (uint16_t)(word & 0xffffu);
    else
      *reinterpret_cast<uint16_t*>(d) = (uint16_t)(word >> 16);
  }
}

// gbmm, bf16: in the copy that each of the warp's rows made whole from
// before its first term (load_p_tile), zero what lies outside the terms;
// then acc += P V over the k16 steps the warp's rows reach.
template <int KP>
__device__ __forceinline__ void g_tile_bf16(const Walk& x, float (&acc)[KP / 8][4],
                                            const bf16* tb, bf16* pt, int c0) {
  const int lane = x.lane;
  if (lane < 16) {
    const int r = x.i0 + lane, lo = max(r, x.c_lo), hi = min(r + 2 * x.w, x.c_hi - 1);
    const int f = lo - c0, f0 = f & ~(x.gran - 1);   // the copy holding the first term
    if (r < x.nrows && lo <= hi && f >= 0 && f < kRows && f != f0) {
      uint16_t* row = reinterpret_cast<uint16_t*>(pt) + r * pitch<bf16>();
      for (int e = f0; e < f; ++e) row[e] = 0;
      for (int e = hi - c0 + 1; e < f0 + x.gran; ++e) row[e] = 0;
    }
  }
  __syncwarp();
#pragma unroll
  for (int kk = 0; kk < kRows / 16; ++kk) {
    const int kc = c0 + 16 * kk;
    if (kc > x.hi || kc + 15 < x.lo) continue;
    // matrices: P rows i0 + 8 (i & 1), columns 16 kk + 8 (i >> 1)
    uint32_t pa[4];
    ldsm_x4(pa, smem_addr(pt + (x.i0 + (lane & 15)) * pitch<bf16>() + 16 * kk +
                          8 * (lane >> 4)));
#pragma unroll
    for (int n2 = 0; n2 < KP / 16; ++n2) {
      if (16 * n2 >= x.kp) break;
      // matrices: window rows 16kk + 8 (i & 1) .. + 7 x columns 16 n2 + 8 (i >> 1)
      uint32_t bq[4];
      ldsm_x4_t(bq, smem_addr(tb + (16 * kk + (lane & 15)) * x.ld + 16 * n2 +
                              8 * (lane >> 4)));
      mma16816<kXBf16>(acc[2 * n2], pa, bq[0], bq[1]);
      mma16816<kXBf16>(acc[2 * n2 + 1], pa, bq[2], bq[3]);
    }
  }
}

// g2bmm, f32: a lane's 4 rows (4 rg ..) by 8 window columns (cg + 8y) of
// the tile, FMAs over 16-byte loads of A and of the window rows, into the
// stage, then stored a row a step, a column a lane.
__device__ __forceinline__ void g2_tile_f32(const Walk& x, const float* as,
                                            const float* tb, float* st,
                                            float* band, int c0) {
  constexpr int P = pitch<float>();
  const int lane = x.lane, rg = lane >> 3, cg = lane & 7;
  const float* ar = as + (x.i0 + 4 * rg) * x.ld;
  const float* br = tb + cg * x.ld;
  float s[4][8] = {};
  for (int kq = 0; kq < x.k; kq += 4) {
    float4 a[4], bv[8];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = *reinterpret_cast<const float4*>(ar + r * x.ld + kq);
#pragma unroll
    for (int y = 0; y < 8; ++y)
      bv[y] = *reinterpret_cast<const float4*>(br + 8 * y * x.ld + kq);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int y = 0; y < 8; ++y) {
        float v = fmaf(a[r].x, bv[y].x, s[r][y]);
        v = fmaf(a[r].y, bv[y].y, v);
        v = fmaf(a[r].z, bv[y].z, v);
        s[r][y] = fmaf(a[r].w, bv[y].w, v);
      }
  }
  __syncwarp();   // the last tile's stores have read the stage
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int y = 0; y < 8; ++y) st[(4 * rg + r) * P + cg + 8 * y] = s[r][y];
  __syncwarp();
  const bool full = interior(x, c0);
  for (int ii = 0; ii < 16; ++ii) {
    const int i = x.i0 + ii;
#pragma unroll
    for (int h = 0; h < 2; ++h) {   // 0 where c is no row of B
      const int c = c0 + lane + 32 * h;
      if (full || in_band(x, i, c))
        band[(size_t)i * x.J + (c - i)] = full || in_rows(x, c) ? st[ii * P + c - c0] : 0.f;
    }
  }
}

// gbmm, f32: a lane's 4 rows (4 rg ..) by kp / 8 columns (4 cg + 32 z ..)
// summed over the window columns the warp's rows reach: 4 scalar loads of
// P (each a broadcast to 8 lanes) and kp / 32 16-byte loads of a window
// row per column.
template <int KP>
__device__ __forceinline__ void g_tile_f32(const Walk& x, float (&acc)[KP / 8][4],
                                           const float* tb, const float* pt, int c0) {
  constexpr int P = pitch<float>();
  const int lane = x.lane, rg = lane >> 3, cg = lane & 7;
  const float* pr = pt + (x.i0 + 4 * rg) * P;
  const int hi = min(x.hi, c0 + kRows - 1) - c0;
  for (int cl = max(x.lo, c0) - c0; cl <= hi; ++cl) {
    float p[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) p[r] = pr[r * P + cl];
    const float* vr = tb + cl * x.ld + 4 * cg;
#pragma unroll
    for (int z = 0; z < KP / 32; ++z) {
      if (32 * z >= x.kp) break;
      const float4 v = *reinterpret_cast<const float4*>(vr + 32 * z);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float(&a)[4] = acc[r * (KP / 32) + z];
        a[0] = fmaf(p[r], v.x, a[0]);
        a[1] = fmaf(p[r], v.y, a[1]);
        a[2] = fmaf(p[r], v.z, a[2]);
        a[3] = fmaf(p[r], v.w, a[3]);
      }
    }
  }
}

template <typename T, int OP, int KP>
__device__ __forceinline__ void band_ring(const T* __restrict__ first,
                                          const T* __restrict__ b,
                                          T* __restrict__ out, int m, int k, int w) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int S = kStages, P = pitch<T>();
  constexpr bool F32 = is_f32<T>();
  const Layout L = layout<T, OP>(k);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  T* ring = reinterpret_cast<T*>(smem);
  T* as = reinterpret_cast<T*>(smem + L.a);
  T* sp = reinterpret_cast<T*>(smem + L.sp);   // g2bmm's stages, gbmm's P ring
  const int J = 2 * w + 1, r0 = blockIdx.x * kRows;
  const int nrows = min(kRows, m - r0);
  const size_t row0 = (size_t)blockIdx.y * m + r0;   // the block's first row
  const T* bb = b + (size_t)blockIdx.y * m * k;
  // the block's rows of the band tensor: out (g2bmm) or W (gbmm)
  T* band = (OP == kG2 ? out : const_cast<T*>(first)) + row0 * J;
  const int c_lo = max(0, w - r0), c_hi = min(w - r0 + m, nrows + 2 * w);
  // The walk: g2bmm over every band column of its rows, [0, nrows + 2w),
  // writing 0 outside [c_lo, c_hi) (no tile loaded or multiplied there);
  // gbmm over [c_lo, c_hi). In bf16 it starts at a column of the band
  // tensor's parity (a pair (c, c + 1) of a row is then an aligned word).
  const int c_first = OP == kG2 ? 0 : c_lo, c_end = OP == kG2 ? nrows + 2 * w : c_hi;
  // (gbmm, w a multiple of 4: of its 8-element alignment, so that every
  // row's 8-column chunks of W are 16-byte aligned)
  const int gran = F32 ? 1 : OP == kG && (w & 3) == 0 ? 8 : 2;
  const int cs = c_first - ((c_first + misalign(band)) & (gran - 1));
  const int nt = (c_end - cs + kRows - 1) / kRows;
  const int tile = kRows * L.ld, ptile = kRows * P;
  Walk x;
  x.lane = lane, x.i0 = warp * 16, x.nrows = nrows, x.w = w, x.J = J, x.k = k;
  x.kp = L.kp, x.ld = L.ld, x.c_lo = c_lo, x.c_hi = c_hi;
  x.lo = max(x.i0, c_lo), x.hi = min(x.i0 + 15 + 2 * w, c_hi - 1), x.gran = gran;
  // the window columns whose tiles the warp visits
  const int t_lo = OP == kG2 ? x.i0 : x.lo, t_hi = OP == kG2 ? x.i0 + 15 + 2 * w : x.hi;

  auto load = [&](int t) {   // tile t of the window (and of P), uncommitted
    const int c0 = cs + t * kRows;
    if (has_rows(c0, c_lo, c_hi))
      load_tile(ring + (t % S) * tile, bb, c0, c_lo, c_hi, r0 - w, k, L.kp, L.ld);
    if (OP == kG)
      load_p_tile(sp + (t % S) * ptile, static_cast<const T*>(band), bb, c0, nrows,
                  c_lo, c_hi, w, J, gran);
  };
  if (OP == kG2)
    load_tile(as, first + (size_t)blockIdx.y * m * k, 0, 0, nrows, r0, k, L.kp, L.ld);
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nt) load(s);
    cp_async_commit();
  }

  // the warp's A fragments (g2bmm, bf16) and sums (gbmm), in registers
  uint32_t qa[OP == kG2 && !F32 ? KP / 16 : 1][4] = {};
  float acc[OP == kG ? KP / 8 : 1][4] = {};

  for (int t = 0; t < nt; ++t) {
    cp_async_wait<S - 2>();   // tile t (and A) landed, this thread's
    __syncthreads();          // ... and everyone's; tile t - 1 is read
    if constexpr (OP == kG2 && !F32) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < KP / 16; ++kk)   // rows 8 (i & 1), cols 8 (i >> 1)
          if (16 * kk < L.kp)
            ldsm_x4(qa[kk], smem_addr(as + (x.i0 + (lane & 15)) * L.ld + 16 * kk +
                                      8 * (lane >> 4)));
      }
    }
    if (t + S - 1 < nt) load(t + S - 1);
    cp_async_commit();

    const int c0 = cs + t * kRows;
    if (x.i0 >= nrows || c0 > t_hi || c0 + kRows - 1 < t_lo) continue;
    const T* tb = ring + (t % S) * tile;
    T* pt = sp + (OP == kG2 ? warp * 16 * P : (t % S) * ptile);
    if constexpr (OP == kG2 && !F32) g2_tile_bf16<KP>(x, qa, tb, pt, band, c0);
    if constexpr (OP == kG && !F32) g_tile_bf16<KP>(x, acc, tb, pt, c0);
    if constexpr (OP == kG2 && F32) g2_tile_f32(x, as, tb, pt, band, c0);
    if constexpr (OP == kG && F32) g_tile_f32<KP>(x, acc, tb, pt, c0);
  }

  if constexpr (OP == kG) {
    if (x.i0 >= nrows) return;
    T* ob = out + row0 * k;
    if constexpr (F32) {
      const int rg = lane >> 3, cg = lane & 7;
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = x.i0 + 4 * rg + r;
#pragma unroll
        for (int z = 0; z < KP / 32; ++z) {
          const int col = 4 * cg + 32 * z;
          const float(&a)[4] = acc[r * (KP / 32) + z];
          if (i < nrows && col < k)
            *reinterpret_cast<float4*>(ob + (size_t)i * k + col) =
                make_float4(a[0], a[1], a[2], a[3]);
        }
      }
    } else {
      const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
      for (int n = 0; n < KP / 8; ++n)   // columns 8n .. 8n + 7: all past k or none
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = x.i0 + g + 8 * h;
          if (i < nrows && 8 * n < k)
            *reinterpret_cast<uint32_t*>(ob + (size_t)i * k + 8 * n + 2 * t4) =
                pack_out<kXBf16>(acc[n][2 * h], acc[n][2 * h + 1]);
        }
    }
  }
}

// a: A (g2bmm) or wt: W (gbmm) [bz, m, .]; b [bz, m, k]; out [bz, m, J]
// (g2bmm) or [bz, m, k] (gbmm).
template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
g2bmm_ring_kernel(const T* __restrict__ a, const T* __restrict__ b,
                  T* __restrict__ out, int m, int k, int w) {
  band_ring<T, kG2, KP>(a, b, out, m, k, w);
}

template <typename T, int KP>
__global__ void __launch_bounds__(kThreads)
gbmm_ring_kernel(const T* __restrict__ wt, const T* __restrict__ b,
                 T* __restrict__ out, int m, int k, int w) {
  band_ring<T, kG, KP>(wt, b, out, m, k, w);
}

template <typename T, int OP, int KP>
cudaError_t launch(const void* first, const void* b, void* out, int bz, int m,
                   int k, int w, cudaStream_t s) {
  static SmemGrant granted;
  auto kernel = [] {
    if constexpr (OP == kG2) return g2bmm_ring_kernel<T, KP>;
    else return gbmm_ring_kernel<T, KP>;
  }();
  const Layout L = layout<T, OP>(k);
  cudaError_t e = allow_smem(kernel, L.bytes, &granted);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((m + kRows - 1) / kRows, bz), kThreads, L.bytes, s>>>(
      static_cast<const T*>(first), static_cast<const T*>(b), static_cast<T*>(out),
      m, k, w);
  return cudaGetLastError();
}

// The instantiation at or above kp = k rounded up to 32: KP 64, 128 or
// 256 (the f32 g2bmm keeps no k-wide registers: one instantiation).
template <typename T, int OP>
cudaError_t launch_kp(const void* first, const void* b, void* out, int bz, int m,
                      int k, int w, cudaStream_t s) {
  if constexpr (OP == kG2 && is_f32<T>()) {
    return launch<T, OP, 64>(first, b, out, bz, m, k, w, s);
  } else {
    const int kp = (k + 31) & ~31;
    if (kp <= 64) return launch<T, OP, 64>(first, b, out, bz, m, k, w, s);
    if (kp <= 128) return launch<T, OP, 128>(first, b, out, bz, m, k, w, s);
    return launch<T, OP, 256>(first, b, out, bz, m, k, w, s);
  }
}

template <int OP>
int launch_op(const void* first, const void* b, void* out, int f32, int bz,
              int m, int k, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bz <= 0 || bz > 65535 || m <= 0 || k < 8 || k > 256 || k % 8 || w < 0 ||
      w > kMaxW)
    return (int)cudaErrorInvalidValue;
  // the window's (and A's) 16-byte copies; W and out at any element offset
  if ((reinterpret_cast<uintptr_t>(b) | (OP == kG2 ? reinterpret_cast<uintptr_t>(first)
                                                    : 0)) & 15)
    return (int)cudaErrorMisalignedAddress;
  return f32 ? (int)launch_kp<float, OP>(first, b, out, bz, m, k, w, s)
             : (int)launch_kp<bf16, OP>(first, b, out, bz, m, k, w, s);
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// a [bz, m, k] and b [bz, m, k], both bf16 (f32 = 0) or both f32, each
// 16-byte aligned; k a multiple of 8 from 8 to 256; out [bz, m, 2w + 1]
// in their type.
ITT_EXPORT int g2bmm_ring(const void* a, const void* b, void* out, int f32,
                          int bz, int m, int k, int w, void* stream) {
  return launch_op<kG2>(a, b, out, f32, bz, m, k, w, stream);
}

// wt [bz, m, 2w + 1] and b [bz, m, k] (16-byte aligned), both bf16 or
// both f32; k a multiple of 8 from 8 to 256; out [bz, m, k] in their type.
ITT_EXPORT int gbmm_ring(const void* wt, const void* b, void* out, int f32,
                         int bz, int m, int k, int w, void* stream) {
  return launch_op<kG>(wt, b, out, f32, bz, m, k, w, stream);
}
