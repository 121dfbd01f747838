// Blockwise (flash) attention for prefill, hand-written for Hopper
// (sm_90a). Python wrapper: kernels/flash_attention.py flash_attention.
//
// Replaces the TPU kernel _flash_kernel
// (infinitensor_tpu/kernels/flash_attention.py:37, reached through
// flash_attention :84).
//
// What it computes: for each (batch, head) and query row i, softmax over
// the key rows j (j <= i when causal) of q_i . k_j / sqrt(D), times V,
// with an online softmax over key tiles, never holding the [S, S] scores.
// The TPU kernel's guards are kept: a row whose running max is still -inf
// takes m = 0 for its exponentials and alpha = 0, masked scores give
// p = 0, and the output is acc / max(l, 1e-30). Every S takes the kernel:
// rows past S are zero-filled in shared memory, masked as keys, and never
// stored as queries. The head dim D is a template parameter, 128
// (Llama-2-7B) or 64 (GPT-2, and the dim-512 Llama of entry()).
//
// What bounds it on this card: at the Llama-2-7B prompt (S = 1024,
// 32 heads, D = 128) the causal work is about 8.6 GFLOP over 33.6 MB of
// q, k, v and o, 256 operations per byte, so both bounds are near: about
// 0.010 ms for the bytes and 0.009 ms for the bf16 tensor-core peak.
//
// Design (FlashAttention-2's on mma.sync m16n8k16, bf16 in, f32 sums): a
// block of kWarps = 4 warps owns 64 query rows of one (batch, head), 16
// rows a warp, its q fragments in registers; it walks the key tiles of 64
// rows, stopping at the diagonal when causal. What the kernel's first form
// (synchronous tiles, two bf16 terms of P) lost time on, and what this one
// does instead:
//  1. Its K and V tiles were loaded through registers between two
//     barriers, so no copy overlapped a product. Here they go through a
//     ring of kStages stages in shared memory filled by cp.async (tiles
//     past S zero-filled through the copy's src-size): tile j + 1 is in
//     flight while tile j's products run, one wait_group and one barrier
//     a tile. Shared memory above 48 KB is dynamic (cudaFuncSetAttribute).
//  2. Its K and V fragments were 32-bit and 16-bit shared loads and packs.
//     Here ldmatrix.x4 reads the K fragments (a key row is a B column) and
//     ldmatrix.x4.trans the V fragments, and the q fragments once. The row
//     stride of D + 8 elements puts the 8 rows of one 8 x 8 matrix 16
//     bytes apart in the banks, so no ldmatrix has a bank conflict.
//  3. P V ran twice, with P as two bf16 terms (hi, lo). Here one bf16 P
//     (FlashAttention-2's choice; l is summed from the f32 p), within the
//     port's 1e-2 of max|plain| at every tested shape (PERF.md §6 holds
//     both forms' errors, read in one call).
//  4. The mask and the isfinite guards ran on every tile. Here a warp
//     masks only the tile that crosses its rows' diagonal (or the ragged
//     last tile when not causal) and skips a tile wholly above it; p =
//     2^(s * scale * log2(e) - m'), one FFMA and one ex2.approx, 2^-inf =
//     0 standing in for the per-score guard.
// The softmax state of a row lives in the 4 lanes that hold its scores
// (quad shuffles for the row max; each lane's share of l is summed at the
// end). Query tiles run last-first (grid y reversed, heads on x), so the
// longest causal rows of every head start first.
//
// Block shape (measured, PERF.md §6 row 6): 4 warps and 64 query rows, 2
// blocks an SM (about 200 registers a thread; shared memory 87,040 bytes
// at D 128, 46,080 at D 64). 8 warps and 128 rows was no faster; a third
// stage in the ring (121 KB, one block an SM) was slower, and so was 2
// query tiles a warp (FlashAttention-2's shape: 255 registers and
// spills). nvcc -Xptxas -v prints the registers and spills in the build
// log (chip_smoke.py phase 2).
//
// flash_attention_any is the any-type form (attention_any.cuh): q, k and v
// all bf16, f16 or f32, any head dim from 8 to 256 that is a multiple of
// 8, the output in their type. The wrapper takes it for whatever the bf16
// kernel above does not take.
#include "attention_any.cuh"
#include "mma_tile.cuh"

namespace {

using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;
using mma_tile::ldsm_x4;
using mma_tile::ldsm_x4_t;
using mma_tile::smem_addr;

constexpr int kBk = 64;             // key rows per tile
constexpr int kStages = 2;          // K/V tiles in the cp.async ring
constexpr int kWarps = 4;           // warps a block, 16 query rows each
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;    // query rows per block
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 as a bf16 pair, the first in the low half (the lower k index).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x with the SFU's ex2.approx (flushing subnormal results to 0; -inf
// gives 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// Copy rows r0 .. r0 + kRows of a [S, kD] head to shared memory (row
// stride kD + 8), zero-filling rows past S. One commit group is the
// caller's.
template <int kD, int kRows>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int r0,
                                          int S, int tid) {
  constexpr int kChunks = kD / 8;   // 16-byte chunks a row
#pragma unroll
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r0 + r < S;
    cp_async16(dst + r * (kD + 8) + c, src + (size_t)(in ? r0 + r : 0) * kD + c,
               in ? 16 : 0);
  }
}

// One warp's 16 query rows against one staged key tile (keys k0 ..
// k0 + 63): scores, the online softmax update, acc += P V. MASK: the tile
// crosses the warp's diagonal (causal) or S (not causal).
template <bool MASK, bool CAUSAL, int kD>
__device__ __forceinline__ void attend_tile(
    const uint32_t (&qa)[kD / 16][4], uint32_t ks, uint32_t vs, int k0,
    const int (&row)[2], int S, float sl2, float (&m)[2], float (&l)[2],
    float (&acc)[kD / 8][4], int lane) {
  constexpr int kLd = kD + 8;
  const int t = lane & 3;
  // scores: s[j][e] is row row[e >> 1], key k0 + 8j + 2t + (e & 1)
  float s[kBk / 8][4];
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int k2 = 0; k2 < kD / 32; ++k2) {
      // matrices: keys 8j..8j+7 x columns 32 k2 + 8i (i = lane / 8)
      uint32_t b[4];
      ldsm_x4(b, ks + 2 * ((8 * j + (lane & 7)) * kLd + 32 * k2 + 8 * (lane >> 3)));
      mma_bf16(s[j], qa[2 * k2], b[0], b[1]);
      mma_bf16(s[j], qa[2 * k2 + 1], b[2], b[3]);
    }
  }
  float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (MASK) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        if (CAUSAL ? col > row[e >> 1] : col >= S) s[j][e] = neg_inf();
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
    }
  float ms[2], alpha[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float m_cur = fmaxf(m[h], quad_max(mx[h]));
    // a row with no valid key yet keeps m = -inf: exponentials take m = 0
    ms[h] = m_cur == neg_inf() ? 0.f : m_cur * sl2;
    alpha[h] = exp2_approx(m[h] * sl2 - ms[h]);     // m = -inf: 0
    m[h] = m_cur;
    l[h] *= alpha[h];
  }
#pragma unroll
  for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float p = exp2_approx(fmaf(s[j][e], sl2, -ms[e >> 1]));   // -inf: 0
      s[j][e] = p;
      l[e >> 1] += p;
    }
#pragma unroll
  for (int n = 0; n < kD / 8; ++n) {
    acc[n][0] *= alpha[0];
    acc[n][1] *= alpha[0];
    acc[n][2] *= alpha[1];
    acc[n][3] *= alpha[1];
  }
  // acc += P V over 4 steps of 16 keys; the score tiles 2kk and 2kk + 1
  // are the A fragment of step kk
#pragma unroll
  for (int kk = 0; kk < kBk / 16; ++kk) {
    const float(&s0)[4] = s[2 * kk];
    const float(&s1)[4] = s[2 * kk + 1];
    const uint32_t pa[4] = {pack_bf16(s0[0], s0[1]), pack_bf16(s0[2], s0[3]),
                            pack_bf16(s1[0], s1[1]), pack_bf16(s1[2], s1[3])};
#pragma unroll
    for (int n2 = 0; n2 < kD / 16; ++n2) {
      // matrices: keys 16kk + 8 (i & 1) .. + 7 x columns 16 n2 + 8 (i >> 1)
      uint32_t b[4];
      ldsm_x4_t(b, vs + 2 * ((16 * kk + (lane & 15)) * kLd + 16 * n2 + 8 * (lane >> 4)));
      mma_bf16(acc[2 * n2], pa, b[0], b[1]);
      mma_bf16(acc[2 * n2 + 1], pa, b[2], b[3]);
    }
  }
}

template <int kD>
constexpr int smem_bytes() {
  return (kBq + 2 * kStages * kBk) * (kD + 8) * 2;
}

template <bool CAUSAL, int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int S, float sl2) {
  constexpr int kLd = kD + 8;       // shared row stride (bf16)
  constexpr int kTile = kBk * kLd;  // one staged K or V tile
  extern __shared__ __align__(16) unsigned char smem[];
  auto* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  auto* ks = qs + kBq * kLd;        // [kStages][kBk][kLd]
  auto* vs = ks + kStages * kTile;  // [kStages][kBk][kLd]
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBq;
  const size_t base = (size_t)blockIdx.x * S * kD;
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w0 = q0 + warp * 16;    // this warp's first query row
  // this thread's two query rows (mma fragment rows g and g + 8)
  const int row[2] = {w0 + (lane >> 2), w0 + (lane >> 2) + 8};

  const int n_k = (S + kBk - 1) / kBk;
  const int last = CAUSAL ? min(n_k - 1, (q0 + kBq - 1) / kBk) : n_k - 1;
  load_rows<kD, kBq>(qs, q + base, q0, S, tid);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st <= last) {
      load_rows<kD, kBk>(ks + st * kTile, kh, st * kBk, S, tid);
      load_rows<kD, kBk>(vs + st * kTile, vh, st * kBk, S, tid);
    }
    cp_async_commit();
  }

  uint32_t qa[kD / 16][4];
  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait<kStages - 2>();   // tile kt (and q) landed, this thread's
    __syncthreads();                // ... and everyone's; tile kt - 1 is read
    if (kt == 0) {
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)   // matrices: rows 8 (i & 1), cols 8 (i >> 1)
        ldsm_x4(qa[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * kLd + 16 * kk +
                                  8 * (lane >> 4)));
    }
    const int nxt = kt + kStages - 1;
    if (nxt <= last) {
      const int st = nxt % kStages;
      load_rows<kD, kBk>(ks + st * kTile, kh, nxt * kBk, S, tid);
      load_rows<kD, kBk>(vs + st * kTile, vh, nxt * kBk, S, tid);
    }
    cp_async_commit();

    const int k0 = kt * kBk;
    if (CAUSAL && k0 > w0 + 15) continue;      // the tile is above every row
    const uint32_t ka = smem_addr(ks + (kt % kStages) * kTile);
    const uint32_t va = smem_addr(vs + (kt % kStages) * kTile);
    const bool mask = CAUSAL ? k0 + kBk - 1 > w0 : k0 + kBk > S;
    if (mask)
      attend_tile<true, CAUSAL, kD>(qa, ka, va, k0, row, S, sl2, m, l, acc, lane);
    else
      attend_tile<false, CAUSAL, kD>(qa, ka, va, k0, row, S, sl2, m, l, acc, lane);
  }

  const int t = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float lh = fmaxf(quad_sum(l[h]), 1e-30f);
    if (row[h] >= S) continue;
    __nv_bfloat16* orow = o + base + (size_t)row[h] * kD + 2 * t;
#pragma unroll
    for (int n = 0; n < kD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
          __floats2bfloat162_rn(acc[n][2 * h] / lh, acc[n][2 * h + 1] / lh);
  }
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

template <bool CAUSAL, int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, float sl2, cudaStream_t s) {
  auto* kernel = flash_attention_kernel<CAUSAL, kD>;
  constexpr int bytes = smem_bytes<kD>();
  // set on every launch: the attribute is per device, and costs little
  const cudaError_t set = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (set != cudaSuccess) return set;
  const int q_tiles = (S + kBq - 1) / kBq;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(BH, q_tiles), kThreads, bytes, s>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), S, sl2);
  return cudaGetLastError();
}

template <int kD>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int BH, int S, bool causal, float sl2, cudaStream_t s) {
  return causal ? launch<true, kD>(q, k, v, o, BH, S, sl2, s)
                : launch<false, kD>(q, k, v, o, BH, S, sl2, s);
}

// q/k/v/o bf16 [BH, S, D] contiguous (BH = batch * heads); D is 64 or 128.
ITT_EXPORT int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int BH, int S, int D, int causal,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0) return (int)cudaErrorInvalidValue;
  const float sl2 = scale * kLog2e;
  if (D == 128) return (int)launch_d<128>(q, k, v, o, BH, S, causal, sl2, s);
  if (D == 64) return (int)launch_d<64>(q, k, v, o, BH, S, causal, sl2, s);
  return (int)cudaErrorInvalidValue;
}

// q/k/v/o [BH, S, D] contiguous, all of `kind` (kXBf16, kXF16, kXF32); D
// a multiple of 8 from 8 to 256.
ITT_EXPORT int flash_attention_any(const void* q, const void* k, const void* v,
                                   void* o, int kind, int BH, int S, int D,
                                   int causal, float scale, void* stream) {
  using attention_any::launch_prefill;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || S <= 0 || D < 8 || D > attention_any::kMaxD || D % 8)
    return (int)cudaErrorInvalidValue;
#define ITT_FA_ANY(KIND, TYPE)                                                      \
  if (kind == KIND)                                                                 \
    return (int)(causal ? launch_prefill<TYPE, true>(q, k, v, o, BH, S, D, scale, s) \
                        : launch_prefill<TYPE, false>(q, k, v, o, BH, S, D, scale, s));
  ITT_FA_ANY(kXBf16, __nv_bfloat16) ITT_FA_ANY(kXF16, __half) ITT_FA_ANY(kXF32, float)
#undef ITT_FA_ANY
  return (int)cudaErrorInvalidValue;
}
