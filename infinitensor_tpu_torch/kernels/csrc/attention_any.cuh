// The any-type decode attention body (sm_90a): the form the decode
// wrappers launch for what the fast 16-bit kernels do not take
// (flash_decode.cuh includes it for the dense and paged kernels,
// flash_decode.cu, paged_flash_decode.cu): an f32 q or cache, a q type
// other than a 16-bit cache's, and a head dim other than 64 or 128. The
// any-type prefill is flash_attention_any.cuh.
//
// What it takes, as the TPU kernels do (infinitensor_tpu/kernels/
// attention.py:294-345, paged_attention.py:115-164): q in bf16, f16 or
// f32 (a run-time kind, read once into shared memory as f32); a float
// cache (or page pool) in bf16, f16 or f32, or int8 with f32 row scales
// (the template type T); any head dim D from 8 to 256 that is a multiple
// of 8, at run time. The math is f32 and the result is written in q's
// type.
//
// Design, kept simple (CUDA cores, no tensor cores): a block of kThreads =
// 128 threads (4 warps) stages a tile of kTile = 32 key rows of K and V in
// shared memory as f32, each thread converting 8 elements at a time with
// one 16-byte load (8 for int8, two for f32; a row of D a multiple of 8
// keeps every such load aligned). Then lane j of a warp scores key j of
// the tile against each of the warp's query rows (K's row stride D + 1
// puts the 32 lanes' reads of one column in 32 banks), the warp updates
// the rows' online softmax (m, l) with shuffles, and lane c owns columns
// c, c + 32, ... of the accumulator (at most 8), adding p_j * V[j, c] over
// the tile with p_j broadcast by shuffle. Query rows: warp w holds rows
// w, w + 4, ... (RPW a warp, rep <= 4 * RPW).
//
// Decode (one query token per (batch, kv head) block over the live rows
// [0, pos]; pos read on the device): dense, split (flash-decoding: the
// same (acc, m, l) partials as the fast split form, combined by
// flash_decode_merge_any in split order) and paged (row s of slot b in
// page table[b, s / P] at offset s % P; a page past pos is never read).
// The INT8 scales fold in as the TPU kernel folds them: score = q . k *
// (ks * 1/sqrt(D)), p * vs before the PV product, l summed from p.
//
// What bounds it: the bytes of the live K and V rows, as the fast forms;
// this form spends more instructions per byte (f32 staging, a shuffle per
// key per query row) and is timed against them in chip_smoke.py phase 3.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace attention_any {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;        // key rows a tile (a lane each)
constexpr int kMaxD = 256;
constexpr int kCols = kMaxD / 32;   // accumulator columns a lane, at most

// The kind (common.cuh) of a float element type.
template <typename T>
__host__ __device__ constexpr int kind_of() {
  return std::is_same<T, float>::value ? kXF32 : std::is_same<T, __half>::value ? kXF16 : kXBf16;
}

// 8 consecutive elements at p (8-element aligned) as f32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ void load8(const __half* p, float (&v)[8]) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __half2* h = reinterpret_cast<const __half2*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __half22float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[8]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const int8_t* p, float (&v)[8]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[i] = i8_val(u.x, 8 * i);
    v[4 + i] = i8_val(u.y, 8 * i);
  }
}

// Stage n <= kTile key rows of K (stride D + 1) and V (stride D) as f32;
// row_of(i) is the element offset of tile row i in kc / vc. With scales
// (int8), sk[i] = ks[row] * scale and sv[i] = vs[row]; else sk[i] = scale.
template <typename T, typename RowOf>
__device__ __forceinline__ void stage_tile(const T* kc, const T* vc,
                                           const float* ks, const float* vs,
                                           int n, int D, float scale,
                                           RowOf row_of, float* kt, float* vt,
                                           float* sk, float* sv) {
  const int per_row = D / 8;
  for (int c = threadIdx.x; c < n * per_row; c += kThreads) {
    const int i = c / per_row, d = (c - i * per_row) * 8;
    const size_t row = row_of(i);
    float kv[8], vv[8];
    load8(kc + row * D + d, kv);
    load8(vc + row * D + d, vv);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      kt[i * (D + 1) + d + j] = kv[j];
      vt[i * D + d + j] = vv[j];
    }
    if (d == 0) {
      if constexpr (std::is_same<T, int8_t>::value) {
        sk[i] = __ldg(ks + row) * scale;
        sv[i] = __ldg(vs + row);
      } else {
        sk[i] = scale;
      }
    }
  }
}

// One tile's online-softmax update of a warp's RPW query rows (row j of
// the warp is qs row qrow[j]; live[j] false skips it): lane i < n scores
// key i (valid(i, j) false masks it), then acc = acc * alpha + p . V.
template <int RPW, bool Q8, typename Valid>
__device__ __forceinline__ void attend(const float* qs, const float* kt,
                                       const float* vt, const float* sk,
                                       const float* sv, int n, int D,
                                       const int (&qrow)[RPW],
                                       const bool (&live)[RPW], Valid valid,
                                       float (&m)[RPW], float (&l)[RPW],
                                       float (&acc)[RPW][kCols]) {
  const int lane = threadIdx.x & 31;
  float dot[RPW];
#pragma unroll
  for (int j = 0; j < RPW; ++j) dot[j] = 0.f;
  if (lane < n) {
    const float* kr = kt + lane * (D + 1);
    for (int d = 0; d < D; ++d) {
      const float kv = kr[d];
#pragma unroll
      for (int j = 0; j < RPW; ++j) dot[j] = fmaf(qs[qrow[j] * D + d], kv, dot[j]);
    }
  }
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    if (!live[j]) continue;               // warp-uniform
    const bool ok = lane < n && valid(lane, j);
    const float s = ok ? dot[j] * sk[lane] : neg_inf();
    const float m_new = fmaxf(m[j], warp_max(s));
    if (m_new == neg_inf()) continue;     // no live key yet (warp-uniform)
    const float p = ok ? expf(s - m_new) : 0.f;
    const float alpha = expf(m[j] - m_new);
    l[j] = l[j] * alpha + warp_sum(p);
    m[j] = m_new;
    const float pv = Q8 ? p * sv[lane] : p;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] *= alpha;
    for (int i = 0; i < n; ++i) {
      const float pi = __shfl_sync(0xffffffffu, pv, i);
      const float* vr = vt + i * D + lane;
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (lane + 32 * c < D) acc[j][c] = fmaf(pi, vr[32 * c], acc[j][c]);
    }
  }
}

// Shared memory of a decode block: q rows [4 RPW][D], K [kTile][D + 1],
// V [kTile][D], the tile's K and V scales.
__host__ __device__ constexpr size_t decode_smem_floats(int rpw, int D) {
  return (size_t)kWarps * rpw * D + (size_t)kTile * (2 * D + 1) + 2 * kTile;
}

// T: the cache element (bf16, f16, f32, or int8 with f32 row scales ks /
// vs). PAGED: kc / vc / ks / vs are page pools reached through table
// [B, S / P]; else dense [B, Hkv, S, D]. SPLIT: blockIdx.x is the split
// and part gets the unnormalized (acc, m, l); else out gets acc / l in
// q_kind. Grid (splits or 1, Hkv, B) as in the fast form.
template <int RPW, typename T, bool PAGED, bool SPLIT>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const void* __restrict__ q, int q_kind, const T* __restrict__ kc,
              const T* __restrict__ vc, const float* __restrict__ ks,
              const float* __restrict__ vs, const int* __restrict__ pos,
              void* __restrict__ out, float* __restrict__ part,
              const int* __restrict__ table, int P, int rep, int Hkv, int S,
              int D, float scale) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  extern __shared__ float smem[];
  float* qs = smem;                                  // [kWarps * RPW][D]
  float* kt = qs + kWarps * RPW * D;                 // [kTile][D + 1]
  float* vt = kt + kTile * (D + 1);                  // [kTile][D]
  float* sk = vt + kTile * D;                        // [kTile]
  float* sv = sk + kTile;                            // [kTile]
  const int ns = SPLIT ? gridDim.x : 1, split = SPLIT ? blockIdx.x : 0;
  const int h = SPLIT ? blockIdx.y : blockIdx.x;
  const int b = SPLIT ? blockIdx.z : blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t head = (size_t)b * Hkv + h;
  const int n_live = min(max(pos[b], 0), S - 1) + 1;
  const int begin = (int)((long long)split * n_live / ns);
  const int end = (int)((long long)(split + 1) * n_live / ns);
  const int* tb = PAGED ? table + (size_t)b * (S / P) : nullptr;

  for (int i = tid; i < kWarps * RPW * D; i += kThreads) {
    const int r = i / D;
    qs[i] = r < rep ? load_kind(q, q_kind, (head * rep + r) * D + i % D) : 0.f;
  }
  int qrow[RPW];
  bool live[RPW];
  float m[RPW], l[RPW], acc[RPW][kCols];
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    qrow[j] = warp + kWarps * j;
    live[j] = qrow[j] < rep;
    m[j] = neg_inf();
    l[j] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[j][c] = 0.f;
  }
  for (int t0 = begin; t0 < end; t0 += kTile) {
    const int n = min(kTile, end - t0);
    __syncthreads();            // q staged; the last tile consumed
    stage_tile<T>(kc, vc, ks, vs, n, D, scale,
                  [&](int i) -> size_t {
                    const int s = t0 + i;
                    if constexpr (PAGED) {
                      const int pg = s / P;
                      return ((size_t)__ldg(tb + pg) * Hkv + h) * P + (s - pg * P);
                    } else {
                      return head * S + s;
                    }
                  },
                  kt, vt, sk, sv);
    __syncthreads();
    attend<RPW, Q8>(qs, kt, vt, sk, sv, n, D, qrow, live,
                    [](int, int) { return true; }, m, l, acc);
  }
#pragma unroll
  for (int j = 0; j < RPW; ++j) {
    if (!live[j]) continue;
    const size_t qr = head * rep + qrow[j];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = lane + 32 * c;
      if (col >= D) continue;
      if constexpr (SPLIT)
        part[(qr * ns + split) * (D + 2) + col] = acc[j][c];
      else
        store_kind(out, q_kind, qr * D + col, acc[j][c] / l[j]);
    }
    if (SPLIT && lane == 0) {
      part[(qr * ns + split) * (D + 2) + D] = m[j];
      part[(qr * ns + split) * (D + 2) + D + 1] = l[j];
    }
  }
}

// Row r (one warp) of out [rows, D] in out_kind = the merge of its ns
// partials part[r, j] = (acc, m, l), j in order, skipping l = 0: sum_j
// acc_j e^(m_j - M) / sum_j l_j e^(m_j - M), M the largest live m_j.
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part, void* __restrict__ out,
             int out_kind, int rows, int ns, int D) {
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;
  const float* pr = part + (size_t)r * ns * (D + 2);
  float mx = neg_inf();
  for (int j = lane; j < ns; j += 32)
    if (pr[j * (D + 2) + D + 1] > 0.f) mx = fmaxf(mx, pr[j * (D + 2) + D]);
  mx = warp_max(mx);
  float l = 0.f, acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int j = 0; j < ns; ++j) {
    const float* pj = pr + j * (D + 2);
    const float lj = pj[D + 1];
    if (!(lj > 0.f)) continue;
    const float w = expf(pj[D] - mx);
    l += lj * w;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      if (lane + 32 * c < D) acc[c] = fmaf(pj[lane + 32 * c], w, acc[c]);
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c)
    if (lane + 32 * c < D) store_kind(out, out_kind, (size_t)r * D + lane + 32 * c, acc[c] / l);
}

template <int RPW, typename T, bool PAGED, bool SPLIT>
cudaError_t launch_decode(const void* q, int q_kind, const void* k, const void* v,
                          const void* ks, const void* vs, const void* pos, void* out,
                          void* part, int splits, const void* table, int P, int B,
                          int rep, int Hkv, int S, int D, float scale,
                          cudaStream_t stream) {
  static SmemGrant granted;
  auto kernel = decode_kernel<RPW, T, PAGED, SPLIT>;
  const size_t smem = sizeof(float) * decode_smem_floats(RPW, D);
  const cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  const dim3 grid = SPLIT ? dim3(splits, Hkv, B) : dim3(Hkv, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      q, q_kind, static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const float*>(ks), static_cast<const float*>(vs),
      static_cast<const int*>(pos), out, static_cast<float*>(part),
      static_cast<const int*>(table), P, rep, Hkv, S, D, scale);
  return cudaGetLastError();
}

template <typename T, bool PAGED>
int dispatch_decode(const void* q, int q_kind, const void* k, const void* v,
                    const void* ks, const void* vs, const void* pos, void* out,
                    void* part, int splits, const void* table, int P, int B, int H,
                    int Hkv, int S, int D, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv || S <= 0 || splits <= 0 || splits > 65535 ||
      D < 8 || D > kMaxD || D % 8 || q_kind < kXBf16 || q_kind > kXF32)
    return (int)cudaErrorInvalidValue;
  if (PAGED && (P <= 0 || S % P || splits != 1)) return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
#define ITT_ANY_CASE(RPW)                                                      \
  if (rep <= kWarps * RPW) {                                                   \
    if constexpr (!PAGED)                                                      \
      if (splits > 1)                                                          \
        return (int)launch_decode<RPW, T, false, true>(                        \
            q, q_kind, k, v, ks, vs, pos, out, part, splits, table, P, B, rep, \
            Hkv, S, D, scale, s);                                              \
    return (int)launch_decode<RPW, T, PAGED, false>(                           \
        q, q_kind, k, v, ks, vs, pos, out, part, 1, table, P, B, rep, Hkv, S,  \
        D, scale, s);                                                          \
  }
  ITT_ANY_CASE(1) ITT_ANY_CASE(2) ITT_ANY_CASE(4)
#undef ITT_ANY_CASE
  return (int)cudaErrorInvalidValue;
}

// cache_kind: kXBf16, kXF16, kXF32, or kCacheI8 (int8 with f32 scales).
constexpr int kCacheI8 = 3;

template <bool PAGED>
int dispatch_decode_kind(const void* q, int q_kind, const void* k, const void* v,
                         const void* ks, const void* vs, int cache_kind,
                         const void* pos, void* out, void* part, int splits,
                         const void* table, int P, int B, int H, int Hkv, int S,
                         int D, float scale, void* stream) {
#define ITT_ANY_KIND(KIND, TYPE)                                               \
  if (cache_kind == KIND)                                                      \
    return dispatch_decode<TYPE, PAGED>(q, q_kind, k, v, ks, vs, pos, out,     \
                                        part, splits, table, P, B, H, Hkv, S,  \
                                        D, scale, stream);
  ITT_ANY_KIND(kXBf16, __nv_bfloat16) ITT_ANY_KIND(kXF16, __half)
  ITT_ANY_KIND(kXF32, float) ITT_ANY_KIND(kCacheI8, int8_t)
#undef ITT_ANY_KIND
  return (int)cudaErrorInvalidValue;
}

}  // namespace attention_any
