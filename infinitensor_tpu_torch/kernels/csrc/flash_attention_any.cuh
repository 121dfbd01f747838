// flash_attention_any: the any-type prefill attention (sm_90a), on the
// CUDA cores. flash_attention.cu launches it for what its tensor-core
// kernel does not take: f32 q, k and v (the tensor cores would take f32
// only as TF32, not the f32 math of the TPU kernel), and bf16 or f16 at
// head dims 136 to 256.
//
// Replaces the TPU kernel _flash_kernel (infinitensor_tpu/kernels/
// flash_attention.py:37-86) for those types: o = softmax(q k^T / sqrt(D),
// masked to key <= query when causal) v, f32 inside with p kept in f32,
// the output acc / max(l, 1e-30) in q's type. q, k, v and o are [BH, S,
// D] of one type T (bf16, f16 or f32), D a multiple of 8 from 8 to 256.
//
// What bounds it on this card: the f32 FMAs. Causal 1 x 32 x 256 x 128 is
// 0.54 GFLOP (4 D operations a (query, key <= query) pair) against 4.2 MB
// of q, k, v and o: 0.0080 ms at the 67 TFLOP/s f32 peak, 0.0013 ms of
// bytes.
//
// Design: two register-tiled products per key tile, SGEMM style.
//  * A block of 256 threads owns BM = 64 query rows of one (batch, head)
//    and walks the key tiles of BN rows (64, or 32 for f32 at D > 128 so
//    that the tiles fit shared memory), stopping at the last query row
//    when causal; each K and V row is staged S / 64 times.
//    Query tiles run last-first (grid y reversed, heads on x), so the
//    longest causal rows of every head start first.
//  * The threads form 16 x 16: thread (ty, tx) holds query rows 4 ty ..
//    4 ty + 3 and keys tx + 16 b (b < BN / 16), a 4 x 4 (4 x 2) tile of
//    S = q k^T, read from shared memory 8 columns at a time: q rows as f32
//    (scaled by log2(e) / sqrt(D) when staged), K rows in T. K's row
//    stride of kD + 16 bytes puts the 8 lanes of a 16-byte phase in 8
//    distinct bank quads; the 16 lanes that share a query row sit in one
//    half warp.
//  * Online softmax in base 2: the row max is 4 xor-shuffles across the
//    half warp once a tile (not a key); l is summed per thread and across
//    the half warp once at the end. Only a tile that crosses the diagonal
//    (or S) is masked; tiles wholly above it are never loaded.
//  * P goes to shared memory in f32, unrounded, transposed ([key][query],
//    row stride BM + 4: one 16-byte store per key, no bank conflict);
//    O += P V is the second register tile: thread (ty, tx) owns rows
//    4 ty .. 4 ty + 3 and the columns 4 tx + 64 c of each, D / 16 floats
//    a row (one broadcast 16-byte P read and D / 64 V reads a key).
//  * K and V tiles are double-buffered by 16-byte cp.async (flash_
//    attention.cu's ring): rows past S and columns past D zero-filled
//    through the copy's src-size, f32 as it is and 16-bit types raw,
//    converted on the read from shared memory. Tile j + 1 is in flight
//    while tile j's products run; one block barrier a tile (P between
//    the products needs only the warp's).
//  * Instantiations at kD = 64, 128 and 256 (the head dim rounded up;
//    the extra columns are zero and never stored), each a constant row
//    stride and accumulator width, the S loop unrolled over kD.
//  * Other tiles tried at causal 1 x 32 x 256 x 128 on the H100 were
//    slower there: 32 key rows (two blocks an SM), 32 query rows, 8 rows
//    a thread (128 threads), 128 query rows; so were skipping a warp's
//    masked keys on the diagonal tile and splitting a query tile's keys
//    across 2-4 blocks merged by the last (at one block an SM the extra
//    blocks run as a second wave). At 256 tokens the 128 blocks of 32
//    heads fill the card once, and the last query tile's block (4 key
//    tiles against 2.5 on average) sets the time.
#pragma once

#include "attention_any.cuh"
#include "mma_tile.cuh"

namespace prefill_any {

using mma_tile::cp_async16;
using mma_tile::cp_async_commit;
using mma_tile::cp_async_wait;

constexpr int kThreads = 256;       // 16 x 16
constexpr int BM = 64;              // query rows a block
constexpr int RT = 4;               // ... a thread
constexpr int kQLd = 4;             // q row padding (floats)
constexpr int kPLd = BM + 4;        // P^T row stride (floats)
constexpr float kLog2e = 1.4426950408889634f;

// BN key rows a tile (64, or 32 for f32 at kD 256: shared memory), NB
// score columns and NC accumulator float4s a row of a thread.
template <typename T, int kD>
struct Tile {
  static constexpr int BN = kD > 128 && sizeof(T) == 4 ? 32 : 64;
  static constexpr int NB = BN / 16, NC = kD / 64;
};

// Row stride (elements) of a staged K or V tile: 16 bytes of padding.
template <typename T, int kD>
__host__ __device__ constexpr int kv_ld() {
  return kD + 16 / (int)sizeof(T);
}

template <typename T, int kD>
constexpr size_t smem_bytes() {
  constexpr size_t BN = Tile<T, kD>::BN;
  return sizeof(float) * ((size_t)BM * (kD + kQLd) + BN * kPLd) +
         sizeof(T) * 4 * BN * kv_ld<T, kD>();
}

// 8 (4) consecutive staged elements at p as f32 (16-byte / 8-byte aligned
// shared memory reads).
__device__ __forceinline__ void lds8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}
__device__ __forceinline__ void cvt2(uint32_t w, const __nv_bfloat16*, float* v) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void cvt2(uint32_t w, const __half*, float* v) {
  const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w));
  v[0] = f.x;
  v[1] = f.y;
}
template <typename T>
__device__ __forceinline__ void lds8(const T* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  cvt2(u.x, p, v);
  cvt2(u.y, p, v + 2);
  cvt2(u.z, p, v + 4);
  cvt2(u.w, p, v + 6);
}
__device__ __forceinline__ void lds4(const float* p, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
template <typename T>
__device__ __forceinline__ void lds4(const T* p, float (&v)[4]) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  cvt2(u.x, p, v);
  cvt2(u.y, p, v + 2);
}

// Store 4 f32 values as 4 consecutive elements of T at p (16-byte /
// 8-byte aligned).
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, const __nv_bfloat16*) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t pack2(float a, float b, const __half*) {
  const __half2 h = __floats2half2_rn(a, b);
  return *reinterpret_cast<const uint32_t*>(&h);
}
template <typename T>
__device__ __forceinline__ void st4(T* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1], p), pack2(v[2], v[3], p));
}

// Copy rows r0 .. r0 + kRows of a [S, D] head to shared memory (row
// stride kv_ld), zero-filling rows past S and columns D .. kD (a 16-byte
// chunk holds 4 or 8 elements, and D % 8 == 0, so a chunk is wholly in
// or out). A copy that reads nothing points at the head's first element.
template <typename T, int kD, int kRows>
__device__ __forceinline__ void stage_rows(T* dst, const T* src, int r0, int S,
                                           int D, int tid) {
  constexpr int E = 16 / (int)sizeof(T);
  constexpr int kChunks = kD / E;
  constexpr int kLd = kv_ld<T, kD>();
#pragma unroll 4
  for (int i = tid; i < kRows * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * E;
    const bool in = r0 + r < S && c < D;
    cp_async16(dst + r * kLd + c, src + (in ? (size_t)(r0 + r) * D + c : 0),
               in ? 16 : 0);
  }
}

template <typename T, bool CAUSAL, int kD>
__global__ void __launch_bounds__(kThreads, 1)
prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
               const T* __restrict__ v, T* __restrict__ o, int S, int D,
               float sl2) {
  constexpr int BN = Tile<T, kD>::BN, NB = Tile<T, kD>::NB,
                NC = Tile<T, kD>::NC;
  constexpr int kQ = kD + kQLd;              // q row stride (floats)
  constexpr int kLd = kv_ld<T, kD>();
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);          // [BM][kQ]
  float* ps = qs + BM * kQ;                            // [BN][kPLd]
  T* ks = reinterpret_cast<T*>(ps + BN * kPLd);        // [2][BN][kLd]
  T* vs = ks + 2 * BN * kLd;                           // [2][BN][kLd]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;
  const size_t base = (size_t)blockIdx.x * S * D;
  const T* kh = k + base;
  const T* vh = v + base;
  const int n_k = (S + BN - 1) / BN;
  const int last = CAUSAL ? min(n_k - 1, (min(q0 + BM, S) - 1) / BN) : n_k - 1;

  stage_rows<T, kD, BN>(ks, kh, 0, S, D, tid);
  stage_rows<T, kD, BN>(vs, vh, 0, S, D, tid);
  cp_async_commit();
  // the block's q rows as f32 times log2(e) / sqrt(D); zero past S and D
  for (int i = tid; i < BM * (kD / 8); i += kThreads) {
    const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
    float x[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (q0 + r < S && c < D) attention_any::load8(q + base + (size_t)(q0 + r) * D + c, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) x[e] *= sl2;
    *reinterpret_cast<float4*>(qs + r * kQ + c) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(qs + r * kQ + c + 4) = make_float4(x[4], x[5], x[6], x[7]);
  }

  float acc[RT][NC][4];
  float m[RT], l[RT];
#pragma unroll
  for (int a = 0; a < RT; ++a) {
    m[a] = neg_inf();
    l[a] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[a][c][e] = 0.f;
  }
  const float* qrow = qs + ty * RT * kQ;

  for (int kt = 0; kt <= last; ++kt) {
    cp_async_wait<0>();   // tile kt landed (this thread's copies) ...
    __syncthreads();      // ... and everyone's; tile kt - 1 and P are read
    const int st = kt & 1;
    if (kt < last) {
      stage_rows<T, kD, BN>(ks + (st ^ 1) * BN * kLd, kh, (kt + 1) * BN, S, D, tid);
      stage_rows<T, kD, BN>(vs + (st ^ 1) * BN * kLd, vh, (kt + 1) * BN, S, D, tid);
    }
    cp_async_commit();
    const int k0 = kt * BN;
    const T* kst = ks + st * BN * kLd;
    const T* vst = vs + st * BN * kLd;

    // S = q k^T (base-2 logits): rows RT ty + a, keys k0 + tx + 16 b
    float s[RT][NB];
#pragma unroll
    for (int a = 0; a < RT; ++a)
#pragma unroll
      for (int b = 0; b < NB; ++b) s[a][b] = 0.f;
#pragma unroll
    for (int d = 0; d < kD; d += 8) {      // columns past D are zero
      float kf[NB][8];
#pragma unroll
      for (int b = 0; b < NB; ++b) lds8(kst + (tx + 16 * b) * kLd + d, kf[b]);
#pragma unroll
      for (int a = 0; a < RT; ++a) {
        float qf[8];
        lds8(qrow + a * kQ + d, qf);
#pragma unroll
        for (int b = 0; b < NB; ++b)
#pragma unroll
          for (int e = 0; e < 8; ++e) s[a][b] = fmaf(qf[e], kf[b][e], s[a][b]);
      }
    }
    if ((CAUSAL && k0 + BN - 1 > q0) || k0 + BN > S) {   // block-uniform
#pragma unroll
      for (int a = 0; a < RT; ++a)
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int key = k0 + tx + 16 * b;
          if (key >= S || (CAUSAL && key > q0 + ty * RT + a)) s[a][b] = neg_inf();
        }
    }
    // online softmax: the row max across the half warp, p = 2^(s - m)
#pragma unroll
    for (int a = 0; a < RT; ++a) {
      float mx = s[a][0];
#pragma unroll
      for (int b = 1; b < NB; ++b) mx = fmaxf(mx, s[a][b]);
#pragma unroll
      for (int w = 1; w < 16; w <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_new = fmaxf(m[a], mx);
      // a row with no valid key yet keeps m = -inf: exponentials take m = 0
      const float ms = m_new == neg_inf() ? 0.f : m_new;
      const float alpha = exp2f(m[a] - ms);        // m = -inf: 0
      m[a] = m_new;
      l[a] *= alpha;
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        s[a][b] = exp2f(s[a][b] - ms);             // -inf: 0
        l[a] += s[a][b];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][c][e] *= alpha;
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
      *reinterpret_cast<float4*>(ps + (tx + 16 * b) * kPLd + ty * RT) =
          make_float4(s[0][b], s[1][b], s[2][b], s[3][b]);
    // the P rows a thread reads below are its own half warp's: a warp's
    // barrier is enough, so warps drift apart between the two products
    __syncwarp();
    // O += P V: rows RT ty + a, columns 4 tx + 64 c
#pragma unroll 4
    for (int j = 0; j < BN; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(ps + j * kPLd + ty * RT);
      const float pa[RT] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        float vv[4];
        lds4(vst + j * kLd + tx * 4 + 64 * c, vv);
#pragma unroll
        for (int a = 0; a < RT; ++a)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][c][e] = fmaf(pa[a], vv[e], acc[a][c][e]);
      }
    }
  }

#pragma unroll
  for (int a = 0; a < RT; ++a) {
    float lt = l[a];
#pragma unroll
    for (int w = 1; w < 16; w <<= 1) lt += __shfl_xor_sync(0xffffffffu, lt, w);
    const float lm = fmaxf(lt, 1e-30f);
    const int row = q0 + ty * RT + a;
    if (row >= S) continue;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = tx * 4 + 64 * c;
      if (col >= D) continue;
      const float out[4] = {acc[a][c][0] / lm, acc[a][c][1] / lm,
                            acc[a][c][2] / lm, acc[a][c][3] / lm};
      st4(o + base + (size_t)row * D + col, out);
    }
  }
}

template <typename T, bool CAUSAL, int kD>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     int BH, int S, int D, float sl2, cudaStream_t stream) {
  static SmemGrant granted;
  auto kernel = prefill_kernel<T, CAUSAL, kD>;
  constexpr size_t smem = smem_bytes<T, kD>();
  const cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  const int q_tiles = (S + BM - 1) / BM;
  if (q_tiles > 65535) return cudaErrorInvalidValue;
  kernel<<<dim3(BH, q_tiles), kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), S, D, sl2);
  return cudaGetLastError();
}

// The instantiation at or above D (a multiple of 8 from 8 to 256): kD 64,
// 128 or 256.
template <typename T, bool CAUSAL>
cudaError_t launch_prefill(const void* q, const void* k, const void* v, void* o,
                           int BH, int S, int D, float scale, cudaStream_t stream) {
  const float sl2 = scale * kLog2e;
  if (D <= 64) return launch_d<T, CAUSAL, 64>(q, k, v, o, BH, S, D, sl2, stream);
  if (D <= 128) return launch_d<T, CAUSAL, 128>(q, k, v, o, BH, S, D, sl2, stream);
  return launch_d<T, CAUSAL, 256>(q, k, v, o, BH, S, D, sl2, stream);
}

}  // namespace prefill_any
