// The body shared by the port's decode-attention kernels (sm_90a): one
// query token per (batch, kv head) block over the live rows of a KV cache.
// flash_decode.cu instantiates it over a dense cache [B, Hkv, S, D],
// paged_flash_decode.cu over a page pool [N, Hkv, P, D] reached through a
// block table. q is bf16 or f16 (a run-time kind, staged once as f32) and
// the output is written in its type; the cache element (the template T)
// is q's 16-bit type, or int8 with f32 row scales.
//
// Design: one block per (batch, kv head), 256 threads, holding the
// rep = H / Hkv query rows of that head. The block reads pos[b] from device
// memory (no host sync, so the launch can sit in a CUDA graph) and walks
// the cache in tiles of 256 rows up to pos inclusive, never reading a row
// past it. Per tile: each thread scores one row, its K bytes read as
// independent 16-byte loads (eight for an int8 row, sixteen for a 16-bit
// one; many bytes in flight, no shuffles): s = q.k / sqrt(D), with the int8 row's
// scale folded in as the TPU kernel does (s = q.k * (ks * 1/sqrt(D)));
// one warp per query row updates the online softmax (m, l) in shared
// memory and, for int8, turns p into p * vs, as the TPU kernel does before
// its PV product; then the 8 warps split the tile's V rows, each lane
// owning 4 columns (a warp reads whole rows), and meet in shared memory
// once at the end. Output is acc / l in q's type. A tile's independent loads
// (a thread's K row, or a 16-bit row's first half, its K and V scales, and
// in the dense form a lane's first 16 V rows, 8 at rep > 4) are issued
// before its first barrier, so their latencies overlap one another and,
// in the first tile, the staging of q; the V scale waits in shared memory
// for the softmax.
//
// The head dim is a template parameter, 128 (Llama) or 64 (GPT-2). A row
// of 64 columns is half the loads per score, and in the PV loop its 16
// column quads leave a warp room for two V rows per pass: lanes 0-15 take
// one row, lanes 16-31 the next, and the two halves meet in the final
// reduction with the warps' partials. At 128 this folds to the code it was.
//
// Split (flash-decoding; dense only): a grid of (splits, Hkv, B) blocks,
// split j of a head taking rows [j n / ns, (j + 1) n / ns) of its n =
// pos[b] + 1 live rows, bounds computed on the device from pos (so one
// captured graph stays right as pos moves). A split writes its partial
// (acc, m, l) in f32, unnormalized, to part[B, H, ns, D + 2]; an empty
// split writes l = 0. flash_decode_merge then combines the ns partials of
// a query row in the order j = 0 .. ns - 1 (skipping l = 0): out =
// sum_j acc_j e^(m_j - M) / sum_j l_j e^(m_j - M), M the largest m_j, so
// two runs give the same bits. The split count is the caller's, from
// shapes only.
//
// Paged: row s of slot b lives in page table[b, s / P] at offset s % P.
// The thread that scores a row computes the row's index in the pool once
// and leaves it in shared memory for the PV loop (the V row), beside the
// row's V scale; the tile walk is otherwise the dense one, so a tile of
// 256 rows spans 256 / P pages and a page whose first row is past pos is
// never looked up or read.
//
// Everything else (an f32 q or cache, a q type other than a 16-bit
// cache's, a head dim other than 64 or 128) takes the any-type body of
// attention_any.cuh, included here so that the dense and paged kernels
// share it too.
#pragma once

#include "attention_any.cuh"
#include "common.cuh"

#include <type_traits>

namespace flash_decode_detail {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;         // cache rows per tile

// The 16-byte words of a cache row that a scoring thread loads before its
// first barrier: all of an int8 row, the first 64 elements of a 16-bit one.
template <typename T, int kD>
__host__ __device__ constexpr int head_words() {
  return std::is_same<T, int8_t>::value ? kD / 16 : 8;
}

template <typename T, int kD>
__device__ __forceinline__ void load_words(const T* kr, uint4 (&w)[head_words<T, kD>()]) {
#pragma unroll
  for (int j = 0; j < head_words<T, kD>(); ++j)
    w[j] = __ldg(reinterpret_cast<const uint4*>(kr) + j);
}

// d[r] += q_r . (an int8 cache row held in w).
template <int REP, int kD>
__device__ __forceinline__ void row_dots(const uint4 (&w)[kD / 16], const int8_t*,
                                         const float (*qs)[kD], float (&d)[REP]) {
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) {
    const uint32_t u[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const float k0 = i8_val(u[t], 0), k1 = i8_val(u[t], 8),
                  k2 = i8_val(u[t], 16), k3 = i8_val(u[t], 24);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float4 qv = reinterpret_cast<const float4*>(qs[r])[j * 4 + t];
        d[r] += qv.x * k0 + qv.y * k1 + qv.z * k2 + qv.w * k3;
      }
    }
  }
}

// Two 16-bit cache elements of a word (T bf16 or f16) as f32, the lower
// one first.
template <typename T>
__device__ __forceinline__ float2 pair_f32(uint32_t u) {
  if constexpr (std::is_same<T, __half>::value) {
    return __half22float2(*reinterpret_cast<const __half2*>(&u));
  } else {
    return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
  }
}

// d[r] += q_r . (a 16-bit cache row kr), its first 64 elements held in w:
// halves of 64 elements (two at kD = 128), eight 16-byte loads each.
template <int REP, int kD, typename T,
          typename std::enable_if<sizeof(T) == 2, int>::type = 0>
__device__ __forceinline__ void row_dots(const uint4 (&w0)[8], const T* kr,
                                         const float (*qs)[kD], float (&d)[REP]) {
#pragma unroll
  for (int half = 0; half < kD / 64; ++half) {
    uint4 w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = half == 0 ? w0[j] : __ldg(reinterpret_cast<const uint4*>(kr + half * 64) + j);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t u[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float2 kv = pair_f32<T>(u[t]);
        const int c = half * 64 + j * 8 + t * 2;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float2 qv = *reinterpret_cast<const float2*>(&qs[r][c]);
          d[r] += qv.x * kv.x + qv.y * kv.y;
        }
      }
    }
  }
}

// Columns 4 * lane .. 4 * lane + 3 of one cache row (lane < kD / 4): the
// raw word(s), loaded ahead of use, then as f32.
template <typename T>
using LaneWord = typename std::conditional<std::is_same<T, int8_t>::value, uint32_t,
                                           uint2>::type;

template <typename T>
__device__ __forceinline__ LaneWord<T> lane_word(const T* vr, int lane) {
  return __ldg(reinterpret_cast<const LaneWord<T>*>(vr) + lane);
}

template <typename T>
__device__ __forceinline__ void lane_cols(LaneWord<T> u, float (&v)[4]) {
  if constexpr (std::is_same<T, int8_t>::value) {
    v[0] = i8_val(u, 0);
    v[1] = i8_val(u, 8);
    v[2] = i8_val(u, 16);
    v[3] = i8_val(u, 24);
  } else {
    const float2 a = pair_f32<T>(u.x), b = pair_f32<T>(u.y);
    v[0] = a.x;
    v[1] = a.y;
    v[2] = b.x;
    v[3] = b.y;
  }
}

// q / out of q_kind (kXBf16, kXF16). T = int8_t: ks / vs are the rows'
// f32 scales; T = __nv_bfloat16 or __half (q's type): unused.
// PAGED: kc / vc / ks / vs are page pools, table is int32 [B, MP] and S is
// MP * P; else table is unused and P is ignored. SPLIT: blockIdx.x is the
// split, the partials go to part and out is unused; else part is unused.
template <int REP, typename T, bool PAGED, bool SPLIT, int kD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const void* __restrict__ q, int q_kind,
                    const T* __restrict__ kc, const T* __restrict__ vc,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ pos, void* __restrict__ out,
                    float* __restrict__ part, const int* __restrict__ table,
                    int P, int rep, int Hkv, int S, float scale) {
  static_assert(!(PAGED && SPLIT), "the paged kernel is not split");
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  __shared__ __align__(16) float qs[REP][kD];
  __shared__ float sc[REP][kTile];      // scores, then p (times vs for int8)
  __shared__ float vs_s[Q8 ? kTile : 1];  // int8: the V scale of a tile row
  __shared__ float m_s[REP], l_s[REP], alpha_s[REP];
  constexpr int kQuads = kD / 4;          // lanes that cover one V row
  constexpr int kRowsPass = 32 / kQuads;  // V rows a warp takes per pass
  constexpr int kStride = kWarps * kRowsPass;   // V rows of all warps a pass
  // V rows a lane loads ahead (dense; fewer where REP x 4 accumulators
  // already hold many registers)
  constexpr int kPre = PAGED ? 0 : REP <= 4 ? 16 : 8;
  __shared__ float red[kStride][kD];
  __shared__ int row_s[PAGED ? kTile : 1];   // pool row index of a tile row
  const int ns = SPLIT ? gridDim.x : 1, split = SPLIT ? blockIdx.x : 0;
  const int h = SPLIT ? blockIdx.y : blockIdx.x;
  const int b = SPLIT ? blockIdx.z : blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane % kQuads, sub = lane / kQuads;
  const int i0 = warp * kRowsPass + sub;  // this lane's first V row of a tile
  const size_t head = (size_t)b * Hkv + h;
  // dense: this head's rows; paged: the pool (rows are found per tile)
  const T* kh = PAGED ? kc : kc + head * S * kD;
  const T* vh = PAGED ? vc : vc + head * S * kD;
  const float* ksh = !Q8 ? nullptr : PAGED ? ks : ks + head * S;
  const float* vsh = !Q8 ? nullptr : PAGED ? vs : vs + head * S;
  const int* tb = PAGED ? table + (size_t)b * (S / P) : nullptr;
  const int n_live = min(max(pos[b], 0), S - 1) + 1;
  // this block's rows [begin, end)
  const int begin = (int)((long long)split * n_live / ns);
  const int end = (int)((long long)(split + 1) * n_live / ns);

  for (int i = tid; i < REP * kD; i += kThreads) {
    const int r = i / kD;
    qs[r][i % kD] = r < rep ? load_kind(q, q_kind, (head * rep + r) * kD + i % kD) : 0.f;
  }
  if (tid < REP) {
    m_s[tid] = neg_inf();
    l_s[tid] = 0.f;
  }
  float acc[REP][4];
#pragma unroll
  for (int r = 0; r < REP; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[r][j] = 0.f;

  for (int t0 = begin; t0 < end; t0 += kTile) {
    // scores: thread tid takes row t0 + tid. Its K row (or the row's first
    // half), its scales and (dense) this lane's first kPre V rows are
    // loaded first, all independent, so their latencies overlap each
    // other and, in the first tile, the staging of q.
    const int s = t0 + tid;
    const bool live = s < end;
    const int n = min(kTile, end - t0);
    const T* vt = PAGED ? vh : vh + (size_t)t0 * kD;
    int row = s;
    if constexpr (PAGED) {
      if (live) {
        const int pg = s / P;
        row = (__ldg(tb + pg) * Hkv + h) * P + (s - pg * P);
        row_s[tid] = row;
      }
    }
    const T* kr = kh + (size_t)row * kD;
    uint4 w[head_words<T, kD>()];
    float fk = scale, fv = 1.f;
    if (live) {
      load_words<T, kD>(kr, w);
      if constexpr (Q8) {
        fk = __ldg(ksh + row) * scale;
        fv = __ldg(vsh + row);
      }
    }
    LaneWord<T> vp[kPre > 0 ? kPre : 1];
#pragma unroll
    for (int k = 0; k < kPre; ++k)
      if (i0 + k * kStride < n) vp[k] = lane_word(vt + (size_t)(i0 + k * kStride) * kD, quad);
    if (t0 == begin) __syncthreads();   // q, m_s and l_s are staged
    if (live) {
      float d[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) d[r] = 0.f;
      row_dots<REP, kD>(w, kr, qs, d);
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r][tid] = d[r] * fk;
      if constexpr (Q8) vs_s[tid] = fv;
    } else {
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r][tid] = neg_inf();
    }
    __syncthreads();
    // online softmax: warp w updates query rows r = w, w + kWarps, ...
    for (int r = warp; r < REP; r += kWarps) {
      float v[kTile / 32];
      float mx = neg_inf();
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        v[i] = sc[r][lane + 32 * i];
        mx = fmaxf(mx, v[i]);
      }
      const float m_prev = m_s[r];
      const float m_cur = fmaxf(m_prev, warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < kTile / 32; ++i) {
        const int idx = lane + 32 * i;
        const float p = expf(v[i] - m_cur);
        psum += p;
        sc[r][idx] = idx >= n ? 0.f : Q8 ? p * vs_s[idx] : p;
      }
      psum = warp_sum(psum);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_cur);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + psum;
        m_s[r] = m_cur;
      }
    }
    __syncthreads();
    // acc (columns quad*4..+3) = acc * alpha + sum over this lane's rows
    // (every kStride-th from i0) of p[s] * V[s, :], in row order
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float a = alpha_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] *= a;
    }
#pragma unroll
    for (int k = 0; k < kPre; ++k) {
      const int i = i0 + k * kStride;
      if (i < n) {
        float vv[4];
        lane_cols<T>(vp[k], vv);
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float p = sc[r][i];
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
        }
      }
    }
#pragma unroll 4
    for (int i = i0 + kPre * kStride; i < n; i += kStride) {
      float vv[4];
      lane_cols<T>(lane_word(vt + (size_t)(PAGED ? row_s[i] : i) * kD, quad), vv);
#pragma unroll
      for (int r = 0; r < REP; ++r) {
        const float p = sc[r][i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[r][j] = fmaf(p, vv[j], acc[r][j]);
      }
    }
    __syncthreads();
  }
  // the warps' partial accumulators meet in a fixed order
#pragma unroll
  for (int r = 0; r < REP; ++r) {
    if (r >= rep) break;
#pragma unroll
    for (int j = 0; j < 4; ++j) red[i0][quad * 4 + j] = acc[r][j];
    __syncthreads();
    if (tid < kD) {
      float sum = 0.f;
      for (int w = 0; w < kStride; ++w) sum += red[w][tid];
      if constexpr (SPLIT) {
        float* pr = part + ((head * rep + r) * ns + split) * (kD + 2);
        pr[tid] = sum;
        if (tid == 0) {
          pr[kD] = m_s[r];
          pr[kD + 1] = l_s[r];
        }
      } else {
        store_kind(out, q_kind, (head * rep + r) * kD + tid, sum / l_s[r]);
      }
    }
    __syncthreads();
  }
}

// Row b * H + hq of out (of out_kind: kXBf16, kXF16) = the merge of that
// query row's ns <= kD partials: thread j reads split j's (m, l), the
// block finds M and the weights e^(m_j - M) (0 where l_j = 0) in shared
// memory, then thread d sums acc_j[d] * w_j over j in order; all loads of
// a phase are independent.
template <int kD>
__global__ void __launch_bounds__(kD)
flash_decode_merge(const float* __restrict__ part, void* __restrict__ out,
                   int out_kind, int ns) {
  __shared__ float w_s[kD], red[kD / 32];
  const float* pr = part + (size_t)blockIdx.x * ns * (kD + 2);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float mj = neg_inf(), lj = 0.f;
  if (tid < ns) {
    mj = pr[tid * (kD + 2) + kD];
    lj = pr[tid * (kD + 2) + kD + 1];
    if (!(lj > 0.f)) mj = neg_inf();
  }
  float mx = warp_max(mj);
  if (lane == 0) red[warp] = mx;
  __syncthreads();
  mx = red[0];
#pragma unroll
  for (int i = 1; i < kD / 32; ++i) mx = fmaxf(mx, red[i]);
  w_s[tid] = lj > 0.f ? expf(mj - mx) : 0.f;
  __syncthreads();
  float l = 0.f, acc = 0.f;
#pragma unroll 8
  for (int j = 0; j < ns; ++j) {
    const float* pj = pr + j * (kD + 2);
    l += pj[kD + 1] * w_s[j];
    acc += pj[tid] * w_s[j];
  }
  store_kind(out, out_kind, (size_t)blockIdx.x * kD + tid, acc / l);
}

template <int REP, typename T, bool PAGED, int kD>
cudaError_t launch(const void* q, int q_kind, const void* k, const void* v,
                   const void* ks, const void* vs, const void* pos, void* out,
                   void* part, int splits, const void* table, int P, int B,
                   int rep, int Hkv, int S, float scale, cudaStream_t stream) {
  const auto* kp = static_cast<const T*>(k);
  const auto* vp = static_cast<const T*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* pp = static_cast<const int*>(pos);
  const auto* tp = static_cast<const int*>(table);
  if constexpr (!PAGED) {
    if (splits > 1) {
      flash_decode_kernel<REP, T, false, true, kD>
          <<<dim3(splits, Hkv, B), kThreads, 0, stream>>>(
              q, q_kind, kp, vp, ksp, vsp, pp, out, static_cast<float*>(part), tp,
              P, rep, Hkv, S, scale);
      return cudaGetLastError();
    }
  }
  flash_decode_kernel<REP, T, PAGED, false, kD><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      q, q_kind, kp, vp, ksp, vsp, pp, out, nullptr, tp, P, rep, Hkv, S, scale);
  return cudaGetLastError();
}

// The instantiation for head dim kD and rep = H / Hkv query rows per kv
// head (at most 16). splits > 1 (dense only): the split form, writing
// part [B, H, splits, kD + 2] f32 for flash_decode_merge; else out.
template <typename T, bool PAGED, int kD>
int dispatch(const void* q, int q_kind, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, void* part,
             int splits, const void* table, int P, int B, int H, int Hkv,
             int S, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv || S <= 0 || splits <= 0 || splits > 65535)
    return (int)cudaErrorInvalidValue;
  if (PAGED && (P <= 0 || S % P || splits != 1)) return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
#define ITT_FD_CASE(R)                                                        \
  if (rep <= R)                                                               \
    return (int)launch<R, T, PAGED, kD>(q, q_kind, k, v, ks, vs, pos, out,    \
                                        part, splits, table, P, B, rep, Hkv,  \
                                        S, scale, s);
  ITT_FD_CASE(1) ITT_FD_CASE(2) ITT_FD_CASE(4) ITT_FD_CASE(8) ITT_FD_CASE(16)
#undef ITT_FD_CASE
  return (int)cudaErrorInvalidValue;
}

// The entries' dispatch on q's kind (kXBf16, kXF16) and D (64 or 128):
// Q8, an int8 cache with f32 scales; else a cache of q's 16-bit type.
template <bool Q8, bool PAGED>
int dispatch_kind(const void* q, int kind, const void* k, const void* v,
                  const void* ks, const void* vs, const void* pos, void* out,
                  void* part, int splits, const void* table, int P, int B,
                  int H, int Hkv, int S, int D, float scale, void* stream) {
  if ((kind != kXBf16 && kind != kXF16) || (D != 64 && D != 128))
    return (int)cudaErrorInvalidValue;
#define ITT_FD_KIND(TYPE, DIM)                                                \
  return dispatch<TYPE, PAGED, DIM>(q, kind, k, v, ks, vs, pos, out, part,    \
                                    splits, table, P, B, H, Hkv, S, scale,    \
                                    stream);
  if constexpr (Q8) {
    if (D == 64) ITT_FD_KIND(int8_t, 64)
    ITT_FD_KIND(int8_t, 128)
  } else {
    if (kind == kXF16) {
      if (D == 64) ITT_FD_KIND(__half, 64)
      ITT_FD_KIND(__half, 128)
    }
    if (D == 64) ITT_FD_KIND(__nv_bfloat16, 64)
    ITT_FD_KIND(__nv_bfloat16, 128)
  }
#undef ITT_FD_KIND
}

}  // namespace flash_decode_detail

