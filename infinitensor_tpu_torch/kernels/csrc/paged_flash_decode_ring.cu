// Paged flash decode redesigned for Hopper (sm_90a): a page-chunk split
// over a ring of asynchronous page copies. One query token per slot over a
// pool of fixed-size KV pages reached through a block table. Python
// wrappers: kernels/paged_attention.py paged_flash_decode and
// paged_flash_decode_q8 (the "ring" form of paged_form; ring_chunks gives
// the chunk size).
//
// Replaces the TPU kernels (infinitensor_tpu/kernels/paged_attention.py)
//   paged_flash_decode_ring     <- _paged_kernel     (:146, via paged_flash_decode :288)
//   paged_flash_decode_q8_ring  <- _paged_q8_kernel  (:187, via paged_flash_decode_q8 :234)
// for what the fast kernels take: a bf16, f16 or f32 q over pages of its
// own type or int8 (f32 row scales), D 64 or 128, rep = H / Hkv up to 16,
// any page size P. The block form of paged_flash_decode.cu (the
// flash_decode.cuh body, one block a (slot, kv head)) stays as the
// yardstick a caller forces.
//
// What bounds it on this card: every live row of every slot is read once,
// 2 * Hkv * (pos[b] + 1) * D * 2 bytes a slot for 16-bit pages (* 2 for
// f32), or 2 * Hkv * (pos[b] + 1) * (D + 4) for int8 pages with their
// scales, against ~4 * H * (pos[b] + 1) * D flops: device-memory bandwidth
// (3.35 TB/s, ~25 GB/s an SM). The block form held it at 8-47 % of that:
// its grid is (Hkv, B), so GQA 32/8 at 8 slots is 64 blocks on 132 SMs and
// ragged slots end with the longest one's blocks, and its paged V rows go
// through dependent loads, about 8 KB in flight a block.
//
// Design:
//  * a page-chunk split: the grid is (chunks, Hkv, B); chunk c of slot b
//    takes pages [c C, (c + 1) C), rows [c C P, (c + 1) C P) cut at
//    pos[b] + 1, read on the device. C and the chunk count come from the
//    shapes and the SM count only (ring_chunks), so one captured graph stays
//    right as positions move; ragged slots spread over the card in
//    proportion to their live pages. A chunk past pos[b] writes l = 0 (acc
//    0, m = -inf) and only signals;
//  * eight independent warps a block, each its own ring and its own online
//    softmax: a block stage is kBRows consecutive rows of the chunk (128 of
//    int8 at D 128, 64 of 16-bit, 32 of f32: 16 KB of K), warp w takes its
//    kWRows of them (16, 8, 4: 4 KB of K and V), so no barrier of the
//    block stands between a copy and its use, and one warp's latency hides
//    behind the others' work (16 warps an SM at rep <= 8);
//  * an asynchronous-copy ring a warp (cp.async, the 16-byte copies of
//    mma_tile.cuh, and 4-byte ones for the int8 pages' f32 scales, so any P
//    works: a scale row of 4 P bytes need not be a multiple of 16):
//    kStages = 3 slots of 4 KB (+ the scales), 2 in flight, 128 KB an SM
//    against the ~25 KB that 3.35 TB/s / 132 SMs needs at ~1 us of
//    latency (depths 2-10 and 2-8 KB slots timed within a few per cent of
//    one another, tools/paged_variants.py). A lane copies the words it
//    later scores; the page of each row is stepped from stage to stage
//    without a division, its id read once a block into shared memory. A
//    1-D bulk copy (TMA) would move whole page slabs, but a warp's share
//    of a stage spans pages whenever P is below its rows, and these copies
//    cost about 0.03 issue slots a byte;
//  * the consumer reads shared memory only. Scores: kLanesRow lanes a row
//    (one 16-byte word each: 8 at int8 D 128), two passes of 32 / kLanesRow
//    rows; q (f32, staged once, interleaved so those lanes read it at
//    consecutive addresses) times the word, the row's lanes summed by
//    shuffles. The arithmetic is the TPU kernel's: s = q.k * (ks *
//    1/sqrt(D)) for int8 (else q.k * 1/sqrt(D)), the online softmax in f32,
//    p * vs before the PV product, sums in f32. PV: a lane its 4 columns of
//    each row (two rows an instruction at D 64), p broadcast by a shuffle;
//    the warps' (acc, m, l) meet once, at the end, in warp order;
//  * the merge in the same launch: each block writes its partial (acc, m,
//    l) to part [B, H, chunks, D + 2] f32, and the last block of a (slot,
//    kv head) to arrive (a counter, set back to 0 by that block, so a graph
//    replay needs no memset: the K split's protocol of quant_matmul.cuh)
//    merges the live chunks in the order j = 0 .. nc - 1: out = sum_j
//    acc_j e^(m_j - M) / sum_j l_j e^(m_j - M), M the largest m_j, so two
//    runs give the same bits. One chunk writes out directly.
// Rows past pos[b] (a page's tail, or pages the slot does not own) are
// never copied or read, and may hold anything, NaN included.
#include "flash_decode.cuh"
#include "mma_tile.cuh"

#include <type_traits>

namespace paged_ring {

using flash_decode_detail::lane_cols;
using flash_decode_detail::LaneWord;
using flash_decode_detail::pair_f32;
using mma_tile::cp_async16;
using mma_tile::cp_async4;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 3;        // ring slots a warp: kStages - 1 in flight
constexpr int kPasses = 4;        // score passes (rows a lane) a warp stage
constexpr int kMaxChunks = 64;    // chunks a (slot, kv head); the merge's cap
constexpr int kMaxPages = 256;    // page ids a block keeps in shared memory
constexpr int kSmemMax = 227 * 1024;

// The stage and lane geometry of a cache element T at head dim kD.
template <typename T, int kD>
struct Geo {
  static constexpr bool kQ8 = std::is_same<T, int8_t>::value;
  static constexpr int kRowBytes = kD * (int)sizeof(T);
  static constexpr int kE = 16 / (int)sizeof(T);      // elements a 16-byte word
  static constexpr int kLanesRow = kD / kE;           // score lanes a row: a word each
  static constexpr int kRowsPass = 32 / kLanesRow;    // rows a warp scores at once
  static constexpr int kWRows = kPasses * kRowsPass;  // rows a warp stage
  static constexpr int kBRows = kWarps * kWRows;      // rows a block stage
  static constexpr int kQuads = kD / 4;               // PV lanes a V row
  static constexpr int kVRows = 32 / kQuads;          // PV rows an instruction
  // a warp's slot: K rows, V rows, then (int8) the K and V row scales
  static constexpr int kSlotBytes = 2 * kWRows * kRowBytes + (kQ8 ? 2 * kWRows * 4 : 0);
  static constexpr int kWarpRing = kStages * kSlotBytes;
  static constexpr int kRingBytes = kWarps * kWarpRing;
  static_assert(kLanesRow <= 32 && 32 % kLanesRow == 0 && kSlotBytes % 16 == 0, "lanes");
  static_assert(kRowsPass % kVRows == 0 || kVRows == 1, "PV rows of one pass");
};

// The bytes the warps' rings take, or afterwards their (acc, m, l)
// [kWarps][REP][kD + 2] f32 and the merge's weights, whichever is more.
template <int REP, typename T, int kD>
__host__ __device__ constexpr int ring_bytes() {
  return Geo<T, kD>::kRingBytes > kWarps * REP * (kD + 2) * 4
             ? Geo<T, kD>::kRingBytes
             : kWarps * REP * (kD + 2) * 4;
}

// Dynamic shared memory: the rings, q [REP][kD] f32 (word-interleaved),
// the chunk's page ids (at most kMaxPages).
template <int REP, typename T, int kD>
constexpr size_t smem_bytes() {
  return (size_t)ring_bytes<REP, T, kD>() + REP * kD * 4 + kMaxPages * 4;
}

// The 16 / sizeof(T) elements of a 16-byte word of a cache row as f32 (an
// int8 byte b: 2^23 + (b ^ 0x80) built by one byte permute, less 2^23 +
// 128, exact).
template <typename T>
__device__ __forceinline__ void word_f32(uint4 u, float (&e)[16 / sizeof(T)]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if constexpr (std::is_same<T, int8_t>::value) {
      const uint32_t x = w[t] ^ 0x80808080u;
#pragma unroll
      for (int k = 0; k < 4; ++k)
        e[4 * t + k] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | k)) - 8388736.f;
    } else if constexpr (sizeof(T) == 4) {
      e[t] = __uint_as_float(w[t]);
    } else {
      const float2 p = pair_f32<T>(w[t]);
      e[2 * t] = p.x;
      e[2 * t + 1] = p.y;
    }
  }
}

// Columns 4 lane .. 4 lane + 3 of a staged V row as f32 (int8: as
// word_f32 does).
template <typename T>
__device__ __forceinline__ void lane_f32(LaneWord<T> u, float (&v)[4]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    const uint32_t x = u ^ 0x80808080u;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440 | k)) - 8388736.f;
  } else {
    lane_cols<T>(u, v);
  }
}

// q / out of q_kind (kXBf16, kXF16, kXF32) [B, H, 1, kD]; kc / vc page
// pools [N, Hkv, P, kD] of T (q's type, or int8 with ks / vs f32 [N, Hkv,
// P]); table int32 [B, MP]; pos int32 [B]; C pages a chunk, gridDim.x =
// ceil(MP / C) chunks; part f32 [B, H, chunks, kD + 2] and counters int32
// [B * Hkv] (zero) where chunks > 1.
template <int REP, typename T, int kD>
__global__ void __launch_bounds__(kThreads, REP >= 16 ? 1 : 2)
paged_ring_kernel(const void* __restrict__ q, int q_kind, const T* __restrict__ kc,
                  const T* __restrict__ vc, const float* __restrict__ ks,
                  const float* __restrict__ vs, const int* __restrict__ table,
                  const int* __restrict__ pos, void* __restrict__ out,
                  float* __restrict__ part, int* __restrict__ counters, int P, int MP,
                  int C, int rep, int Hkv, float scale) {
  using G = Geo<T, kD>;
  constexpr bool Q8 = G::kQ8;
  constexpr int RB = G::kRowBytes, kE = G::kE, kLR = G::kLanesRow;
  constexpr int kRP = G::kRowsPass, kWR = G::kWRows, kBR = G::kBRows;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + ring_bytes<REP, T, kD>());
  int* pid_s = reinterpret_cast<int*>(qs + REP * kD);
  __shared__ bool last_s;

  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int chunks = gridDim.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head = (size_t)b * Hkv + h;
  unsigned char* wring = smem + warp * G::kWarpRing;
  const int rsub = lane / kLR, word = lane % kLR;

  // before any copy, in one round: q, the chunk's page ids (kept in shared
  // memory where at most kMaxPages, else read from the table) and pos. q
  // row r element e = word c, quad k, t lands at ((r kE/4 + k) kLR + c) 4
  // + t, so the lanes of a row read their words' q at consecutive addresses
  for (int i = tid; i < REP * kD; i += kThreads) {
    const int r = i / kD, e = i % kD;
    qs[((r * (kE / 4) + (e % kE) / 4) * kLR + e / kE) * 4 + e % 4] =
        r < rep ? load_kind(q, q_kind, (head * rep + r) * kD + e) : 0.f;
  }
  const int pg0 = c * C;                                // the chunk's first page
  const int* tb = table + (size_t)b * MP + pg0;
  const int* pids = C <= kMaxPages ? pid_s : tb;
  if (C <= kMaxPages)
    for (int i = tid; i < min(C, MP - pg0); i += kThreads) pid_s[i] = __ldg(tb + i);
  const int n = min(max(pos[b], 0), MP * P - 1) + 1;   // live rows
  const long long span = (long long)C * P;              // rows a chunk
  const int begin = (int)min((long long)c * span, (long long)n);
  const int end = (int)min((long long)(c + 1) * span, (long long)n);
  const int n_st = (end - begin + kBR - 1) / kBR;
  const int nc = (int)((n + span - 1) / span);          // chunks with live rows
  if (begin >= end) {   // past pos: l = 0, and no part in the merge
    if (tid < rep) {
      float* pr = part + ((head * rep + tid) * chunks + c) * (kD + 2);
      pr[kD] = neg_inf();
      pr[kD + 1] = 0.f;
    }
    return;
  }
  __syncthreads();

  // the lane's rows (one a pass) of the next stage to copy: absolute row,
  // its page (from pg0) and offset, stepped by kBR rows a stage
  int srow[kPasses], pg[kPasses], off[kPasses];
  const int step_pg = kBR / P, step_off = kBR - step_pg * P;
#pragma unroll
  for (int p = 0; p < kPasses; ++p) {
    srow[p] = begin + warp * kWR + p * kRP + rsub;
    pg[p] = srow[p] / P - pg0;
    off[p] = srow[p] - (pg[p] + pg0) * P;
  }
  // copy stage st (the next in order) into its slot: each lane its words
  // of K and of V (one a pass), lane L (+ 32) the K (L < kWR) or V scale of
  // row L % kWR; then step the rows
  auto issue = [&](int st) {
    unsigned char* slot = wring + (st % kStages) * G::kSlotBytes;
    unsigned long long prow[kPasses];
    int ok[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      ok[p] = srow[p] < end;
      prow[p] = ok[p] ? ((unsigned long long)pids[pg[p]] * Hkv + h) * P + off[p] : 0;
      if (ok[p]) {
        const size_t o = (size_t)prow[p] * RB + word * 16;
        const int j = p * kRP + rsub;
        cp_async16(slot + j * RB + word * 16, reinterpret_cast<const unsigned char*>(kc) + o, 16);
        cp_async16(slot + (kWR + j) * RB + word * 16,
                   reinterpret_cast<const unsigned char*>(vc) + o, 16);
      }
    }
    if constexpr (Q8) {
#pragma unroll
      for (int L0 = 0; L0 < 2 * kWR; L0 += 32) {
        const int L = L0 + lane, j = L % kWR, src = (j % kRP) * kLR;
        unsigned long long row = 0;
        int live = 0;
#pragma unroll
        for (int p = 0; p < kPasses; ++p) {
          const unsigned long long rp = __shfl_sync(0xffffffffu, prow[p], src);
          const int okp = __shfl_sync(0xffffffffu, ok[p], src);
          if (j / kRP == p) row = rp, live = okp;
        }
        if (L < 2 * kWR && live)
          cp_async4(slot + 2 * kWR * RB + L * 4, (L < kWR ? ks : vs) + row, 4);
      }
    }
    cp_async_commit();
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      srow[p] += kBR;
      pg[p] += step_pg;
      off[p] += step_off;
      if (off[p] >= P) {
        off[p] -= P;
        ++pg[p];
      }
    }
  };

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_st)
      issue(st);
    else
      cp_async_commit();
  }
  float m[REP], l[REP], acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    m[r] = neg_inf();
    l[r] = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;
  }
  const int quad = lane % G::kQuads, vsub = lane / G::kQuads;

  for (int st = 0; st < n_st; ++st) {
    cp_async_wait<kStages - 2>();
    __syncwarp();    // the warp's stage st landed; its slot st - 1 is free
    if (st + kStages - 1 < n_st)
      issue(st + kStages - 1);
    else
      cp_async_commit();
    const int rows = min(kWR, end - (begin + st * kBR + warp * kWR));
    if (rows <= 0) continue;
    const unsigned char* slot = wring + (st % kStages) * G::kSlotBytes;
    const float* kss = reinterpret_cast<const float*>(slot + 2 * kWR * RB);
    // scores of the lane's rows (pass p: row p kRP + rsub)
    float sc[kPasses][REP];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const int j = p * kRP + rsub;
      float e[kE];
      word_f32<T>(*reinterpret_cast<const uint4*>(slot + j * RB + word * 16), e);
      float d[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) d[r] = 0.f;
#pragma unroll
      for (int k = 0; k < kE / 4; ++k)
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(qs + ((r * (kE / 4) + k) * kLR + word) * 4);
          d[r] += qv.x * e[4 * k] + qv.y * e[4 * k + 1] + qv.z * e[4 * k + 2] +
                  qv.w * e[4 * k + 3];
        }
#pragma unroll
      for (int o = kLR / 2; o > 0; o >>= 1)
#pragma unroll
        for (int r = 0; r < REP; ++r) d[r] += __shfl_xor_sync(0xffffffffu, d[r], o);
      const bool live = j < rows;
      const float f = Q8 ? (live ? kss[j] : 0.f) * scale : scale;
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[p][r] = live ? d[r] * f : neg_inf();
    }
    // online softmax over the warp's rows of this stage
    float pv[kPasses][REP];
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      float mx = sc[0][r];
#pragma unroll
      for (int p = 1; p < kPasses; ++p) mx = fmaxf(mx, sc[p][r]);
#pragma unroll
      for (int o = kLR; o < 32; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[r], mx);
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        pv[p][r] = expf(sc[p][r] - m_new);
        ps += pv[p][r];
      }
#pragma unroll
      for (int o = kLR; o < 32; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[r] = l[r] * alpha + ps;
      m[r] = m_new;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] *= alpha;
    }
    if constexpr (Q8) {
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const int j = p * kRP + rsub;
        const float v = j < rows ? kss[kWR + j] : 0.f;
#pragma unroll
        for (int r = 0; r < REP; ++r) pv[p][r] *= v;
      }
    }
    // PV: the lane's 4 columns of row i + vsub, its p from the lane that
    // scored it
#pragma unroll
    for (int i = 0; i < kWR; i += G::kVRows) {
      const int j = i + vsub, src = (j % kRP) * kLR;
      float pj[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r)
        pj[r] = __shfl_sync(0xffffffffu, pv[i / kRP][r], src);
      if (j < rows) {
        float vv[4];
        lane_f32<T>(*reinterpret_cast<const LaneWord<T>*>(slot + (kWR + j) * RB +
                                                           quad * 4 * sizeof(T)),
                    vv);
#pragma unroll
        for (int r = 0; r < REP; ++r)
#pragma unroll
          for (int k = 0; k < 4; ++k) acc[r][k] = fmaf(pj[r], vv[k], acc[r][k]);
      }
    }
  }
  cp_async_wait<0>();
  // D 64: lanes l and l + 16 hold two row parities of the same columns
  if constexpr (G::kVRows == 2) {
#pragma unroll
    for (int r = 0; r < REP; ++r)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[r][k] += __shfl_xor_sync(0xffffffffu, acc[r][k], 16);
  }
  __syncthreads();   // every ring is free: the warps' (acc, m, l) meet there
  float* wpart = reinterpret_cast<float*>(smem);   // [kWarps][REP][kD + 2]
  float* wt_s = qs;   // [REP][kWarps + 1]: the warps' weights, then l
  static_assert(REP * (kMaxChunks + 1) * 8 <= ring_bytes<REP, T, kD>(), "merge fits");
  static_assert(REP * (kWarps + 1) <= REP * kD, "weights fit q's place");
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    float* wp = wpart + (warp * REP + r) * (kD + 2);
    if (lane < G::kQuads)
#pragma unroll
      for (int k = 0; k < 4; ++k) wp[quad * 4 + k] = acc[r][k];
    if (lane == 0) {
      wp[kD] = m[r];
      wp[kD + 1] = l[r];
    }
  }
  __syncthreads();
  // the block's (acc, m, l): the warps combined in warp order, their
  // weights e^(m_w - M) (0 for a warp with no row) taken once a query row
  if (tid < rep) {
    float mx = neg_inf();
    for (int w = 0; w < kWarps; ++w) {
      const float* wp = wpart + (w * REP + tid) * (kD + 2);
      if (wp[kD + 1] > 0.f) mx = fmaxf(mx, wp[kD]);
    }
    float lsum = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float* wp = wpart + (w * REP + tid) * (kD + 2);
      const float f = wp[kD + 1] > 0.f ? expf(wp[kD] - mx) : 0.f;
      wt_s[tid * (kWarps + 1) + w] = f;
      lsum += wp[kD + 1] * f;
    }
    wt_s[tid * (kWarps + 1) + kWarps] = lsum;
    if (chunks > 1) {
      float* pr = part + ((head * rep + tid) * chunks + c) * (kD + 2);
      pr[kD] = mx;
      pr[kD + 1] = lsum;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < rep * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    const float* wt = wt_s + r * (kWarps + 1);
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += wpart[(w * REP + r) * (kD + 2) + d] * wt[w];
    if (chunks == 1)
      store_kind(out, q_kind, (head * rep + r) * kD + d, a / wt[kWarps]);
    else
      part[((head * rep + r) * chunks + c) * (kD + 2) + d] = a;
  }
  if (chunks == 1) return;
  // the last of the nc live chunk blocks of this (slot, kv head) to
  // arrive merges (after the barrier that orders the block's stores of
  // part, and a fence)
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    const bool last = atomicAdd(counters + head, 1) == nc - 1;
    if (last) counters[head] = 0;
    last_s = last;
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  float* w_s = reinterpret_cast<float*>(smem);    // [REP][kMaxChunks]: m, then weights
  float* l_s = w_s + REP * kMaxChunks;            // [REP][kMaxChunks]
  float* lsum_s = l_s + REP * kMaxChunks;         // [REP]
  for (int i = tid; i < rep * nc; i += kThreads) {
    const int r = i / nc, j = i % nc;
    const float* pj = part + ((head * rep + r) * chunks + j) * (kD + 2);
    w_s[r * kMaxChunks + j] = __ldcg(pj + kD);
    l_s[r * kMaxChunks + j] = __ldcg(pj + kD + 1);
  }
  __syncthreads();
  if (tid < rep) {
    float mx = neg_inf();
    for (int j = 0; j < nc; ++j) mx = fmaxf(mx, w_s[tid * kMaxChunks + j]);
    float lsum = 0.f;
    for (int j = 0; j < nc; ++j) {
      const float w = expf(w_s[tid * kMaxChunks + j] - mx);
      w_s[tid * kMaxChunks + j] = w;
      lsum += l_s[tid * kMaxChunks + j] * w;
    }
    lsum_s[tid] = lsum;
  }
  __syncthreads();
  for (int idx = tid; idx < rep * kD; idx += kThreads) {
    const int r = idx / kD, d = idx % kD;
    const float* pr = part + (head * rep + r) * chunks * (kD + 2) + d;
    float a = 0.f;
    for (int j0 = 0; j0 < nc; j0 += 8) {   // 8 independent loads, then the sums in order
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = j0 + u < nc ? __ldcg(pr + (j0 + u) * (kD + 2)) : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < nc) a += v[u] * w_s[r * kMaxChunks + j0 + u];
    }
    store_kind(out, q_kind, (head * rep + r) * kD + d, a / lsum_s[r]);
  }
}

template <int REP, typename T, int kD>
cudaError_t launch(const void* q, int q_kind, const void* k, const void* v, const void* ks,
                   const void* vs, const void* table, const void* pos, void* out, void* part,
                   void* counters, int B, int rep, int Hkv, int P, int MP, int C, float scale,
                   cudaStream_t stream) {
  static SmemGrant granted;
  auto kernel = paged_ring_kernel<REP, T, kD>;
  constexpr size_t smem = smem_bytes<REP, T, kD>();
  static_assert(smem <= (size_t)kSmemMax, "shared memory");
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((MP + C - 1) / C, Hkv, B), kThreads, smem, stream>>>(
      q, q_kind, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(table), static_cast<const int*>(pos), out,
      static_cast<float*>(part), static_cast<int*>(counters), P, MP, C, rep, Hkv, scale);
  return cudaGetLastError();
}

template <typename T, int kD>
int dispatch(const void* q, int q_kind, const void* k, const void* v, const void* ks,
             const void* vs, const void* table, const void* pos, void* out, void* part,
             void* counters, int B, int H, int Hkv, int P, int MP, int C, float scale,
             void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hkv > 65535 || H % Hkv || P <= 0 || MP <= 0 ||
      C <= 0 || (long long)MP * P >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const int chunks = (MP + C - 1) / C;
  if (chunks > kMaxChunks || (chunks > 1 && (!part || !counters)))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(k) % 16 || reinterpret_cast<uintptr_t>(v) % 16)
    return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define ITT_RING_CASE(R)                                                              \
  if (rep <= R)                                                                       \
    return (int)launch<R, T, kD>(q, q_kind, k, v, ks, vs, table, pos, out, part,      \
                                 counters, B, rep, Hkv, P, MP, C, scale, s);
  ITT_RING_CASE(1) ITT_RING_CASE(2) ITT_RING_CASE(4) ITT_RING_CASE(8) ITT_RING_CASE(16)
#undef ITT_RING_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace paged_ring

ITT_DEFINE_ERROR_STRING()

// q [B, H, 1, D] of kind (kXBf16, kXF16, kXF32); k/v pages int8 [N, Hkv,
// P, D], 16-byte aligned; ks/vs pages f32 [N, Hkv, P]; table int32 [B, MP]
// (page ids); pos int32 [B] (inclusive); out [B, H, 1, D] of kind. D 64 or
// 128, rep = H / Hkv at most 16. chunk_pages C: ceil(MP / C) chunks, at
// most 64; above one, part f32 [B, H, chunks, D + 2] scratch and counters
// int32 [B * Hkv], zero, and zero again after the launch.
ITT_EXPORT int paged_flash_decode_q8_ring(const void* q, int kind, const void* k,
                                          const void* v, const void* ks, const void* vs,
                                          const void* table, const void* pos, void* out,
                                          void* part, void* counters, int B, int H,
                                          int Hkv, int P, int MP, int D, int chunk_pages,
                                          float scale, void* stream) {
  if (kind != kXBf16 && kind != kXF16 && kind != kXF32) return (int)cudaErrorInvalidValue;
  if (D == 64)
    return paged_ring::dispatch<int8_t, 64>(q, kind, k, v, ks, vs, table, pos, out, part,
                                            counters, B, H, Hkv, P, MP, chunk_pages, scale,
                                            stream);
  if (D == 128)
    return paged_ring::dispatch<int8_t, 128>(q, kind, k, v, ks, vs, table, pos, out, part,
                                             counters, B, H, Hkv, P, MP, chunk_pages, scale,
                                             stream);
  return (int)cudaErrorInvalidValue;
}

// As paged_flash_decode_q8_ring over pages of q's kind, with no scales.
ITT_EXPORT int paged_flash_decode_ring(const void* q, int kind, const void* k, const void* v,
                                       const void* table, const void* pos, void* out,
                                       void* part, void* counters, int B, int H, int Hkv,
                                       int P, int MP, int D, int chunk_pages, float scale,
                                       void* stream) {
  if (D != 64 && D != 128) return (int)cudaErrorInvalidValue;
#define ITT_RING_KIND(KIND, TYPE)                                                      \
  if (kind == KIND)                                                                    \
    return D == 64 ? paged_ring::dispatch<TYPE, 64>(q, kind, k, v, nullptr, nullptr,   \
                                                    table, pos, out, part, counters, B, \
                                                    H, Hkv, P, MP, chunk_pages, scale,  \
                                                    stream)                            \
                   : paged_ring::dispatch<TYPE, 128>(q, kind, k, v, nullptr, nullptr,  \
                                                     table, pos, out, part, counters,  \
                                                     B, H, Hkv, P, MP, chunk_pages,    \
                                                     scale, stream);
  ITT_RING_KIND(kXBf16, __nv_bfloat16)
  ITT_RING_KIND(kXF16, __half)
  ITT_RING_KIND(kXF32, float)
#undef ITT_RING_KIND
  return (int)cudaErrorInvalidValue;
}
