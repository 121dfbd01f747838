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
// p = 0, and the output is acc / max(l, 1e-30).
//
// The head dim D is a template parameter, 128 (Llama-2-7B) or 64 (GPT-2,
// and the dim-512 Llama of entry()); the shared row stride, the q
// fragments and the output accumulators scale with it.
//
// What bounds it on this card: at the Llama-2-7B prompt (S = 1024,
// 32 heads, D = 128) the causal work is about 8.6 GFLOP over 33.6 MB of
// q, k, v and o, 256 operations per byte, so both bounds are near: about
// 0.010 ms for the bytes and 0.009 ms for the bf16 tensor-core peak.
//
// Design, kept simple (no wgmma, TMA or pipelining yet): a block of 4
// warps owns 64 query rows of one (batch, head), 16 rows per warp, its q
// fragments held in registers; it walks the key tiles of 64 rows (stopping
// at the diagonal when causal, so tiles above it are never read), each
// loaded once into shared memory (rows past S read as zero and are masked,
// so any S takes the kernel). Both products run on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulate):
//  * Q K^T: bf16 q and k are exact in the f32 products, so the scores are
//    the TPU kernel's f32 dot up to summation order;
//  * P V: the TPU kernel keeps P in f32. Here P is split into two bf16
//    terms, hi = bf16(p) and lo = bf16(p - hi), and both are multiplied
//    by V (two mma per tile), so about 16 bits of each p reach the
//    product (relative error near 2^-17, against 2^-9 for one bf16 P).
// The softmax state of a row lives in the 4 lanes that hold its scores
// (quad shuffles for the row max; each lane's share of l is summed at the
// end). Query tiles run last-first, so the longest causal rows start
// first.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBq = 16 * kWarps;    // query rows per block
constexpr int kBk = 64;             // key rows per tile

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two bf16 values, the first in the low half (the lower k or column index).
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// p0, p1 (f32) -> bf16 pair hi and the pair of what hi left out.
__device__ __forceinline__ void split2(float p0, float p1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(p0), h1 = __float2bfloat16_rn(p1);
  hi = pack2(h0, h1);
  lo = pack2(__float2bfloat16_rn(p0 - __bfloat162float(h0)),
             __float2bfloat16_rn(p1 - __bfloat162float(h1)));
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

template <bool CAUSAL, int kD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, int S, float scale) {
  constexpr int kLd = kD + 8;       // shared row stride (bf16): no bank conflicts
  __shared__ __align__(16) __nv_bfloat16 ks[kBk * kLd];
  __shared__ __align__(16) __nv_bfloat16 vs[kBk * kLd];
  const int qt = gridDim.x - 1 - blockIdx.x;
  const size_t base = (size_t)blockIdx.y * S * kD;
  const __nv_bfloat16* qh = q + base;
  const __nv_bfloat16* kh = k + base;
  const __nv_bfloat16* vh = v + base;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  // this thread's two query rows (mma fragment rows g and g + 8)
  const int row[2] = {qt * kBq + warp * 16 + g, qt * kBq + warp * 16 + g + 8};

  // q as mma A fragments, 8 steps of 16 over D
  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk) {
    const int c = 16 * kk + 2 * t;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const bool in = row[h] < S;
      const __nv_bfloat16* qr = qh + (size_t)row[h] * kD + c;
      qa[kk][h] = in ? ld32(qr) : 0u;
      qa[kk][2 + h] = in ? ld32(qr + 8) : 0u;
    }
  }

  float acc[kD / 8][4];
#pragma unroll
  for (int n = 0; n < kD / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {neg_inf(), neg_inf()}, l[2] = {0.f, 0.f};

  const int n_k = (S + kBk - 1) / kBk;
  const int last = CAUSAL ? min(n_k - 1, (qt * kBq + kBq - 1) / kBk) : n_k - 1;
  for (int kt = 0; kt <= last; ++kt) {
    const int k0 = kt * kBk;
    __syncthreads();                  // the previous tile is no longer read
    for (int i = tid; i < kBk * (kD / 8); i += kThreads) {
      const int r = i / (kD / 8), c = (i % (kD / 8)) * 8;
      uint4 kv = make_uint4(0u, 0u, 0u, 0u), vv = kv;
      if (k0 + r < S) {
        kv = __ldg(reinterpret_cast<const uint4*>(kh + (size_t)(k0 + r) * kD + c));
        vv = __ldg(reinterpret_cast<const uint4*>(vh + (size_t)(k0 + r) * kD + c));
      }
      *reinterpret_cast<uint4*>(ks + r * kLd + c) = kv;
      *reinterpret_cast<uint4*>(vs + r * kLd + c) = vv;
    }
    __syncthreads();

    // scores: 8 tiles of 8 key rows; s[j][e] is row row[e >> 1], key
    // k0 + 8j + 2t + (e & 1)
    float s[kBk / 8][4];
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
      const __nv_bfloat16* kr = ks + (8 * j + g) * kLd + 2 * t;
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + 16 * kk + 8);
        mma_bf16(s[j], qa[kk], b0, b1);
      }
    }
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + 8 * j + 2 * t + (e & 1);
        float x = s[j][e] * scale;
        if (col >= S || (CAUSAL && col > row[e >> 1])) x = neg_inf();
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float m_safe[2], alpha[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float m_cur = fmaxf(m[h], quad_max(mx[h]));
      // rows with no valid key yet keep m = -inf; protect exp
      m_safe[h] = isfinite(m_cur) ? m_cur : 0.f;
      alpha[h] = isfinite(m[h]) ? expf(m[h] - m_safe[h]) : 0.f;
      m[h] = m_cur;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int j = 0; j < kBk / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = isfinite(s[j][e]) ? expf(s[j][e] - m_safe[e >> 1]) : 0.f;
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

    // acc += P V over 4 steps of 16 key rows; the score tiles 2kk and
    // 2kk + 1 are the A fragment of step kk
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
      uint32_t ph[4], pl[4];
      split2(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split2(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split2(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split2(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
      const __nv_bfloat16* vr = vs + (16 * kk + 2 * t) * kLd + g;
#pragma unroll
      for (int n = 0; n < kD / 8; ++n) {
        const __nv_bfloat16* vc = vr + 8 * n;
        const uint32_t b0 = pack2(vc[0], vc[kLd]);
        const uint32_t b1 = pack2(vc[8 * kLd], vc[9 * kLd]);
        mma_bf16(acc[n], ph, b0, b1);
        mma_bf16(acc[n], pl, b0, b1);
      }
    }
  }

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

template <int kD>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int BH, int S, bool causal, float scale, cudaStream_t s) {
  const dim3 grid((S + kBq - 1) / kBq, BH);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(o);
  if (causal)
    flash_attention_kernel<true, kD><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, S, scale);
  else
    flash_attention_kernel<false, kD><<<grid, kThreads, 0, s>>>(qp, kp, vp, op, S, scale);
  return cudaGetLastError();
}

// q/k/v/o bf16 [BH, S, D] contiguous (BH = batch * heads); D is 64 or 128.
ITT_EXPORT int flash_attention(const void* q, const void* k, const void* v,
                               void* o, int BH, int S, int D, int causal,
                               float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (BH <= 0 || BH > 65535 || S <= 0) return (int)cudaErrorInvalidValue;
  if (D == 128) return (int)launch<128>(q, k, v, o, BH, S, causal, scale, s);
  if (D == 64) return (int)launch<64>(q, k, v, o, BH, S, causal, scale, s);
  return (int)cudaErrorInvalidValue;
}
