// The body shared by the port's decode-attention kernels (sm_90a): one
// query token per (batch, kv head) block over the live rows of a KV cache.
// flash_decode.cu instantiates it over a dense cache [B, Hkv, S, D],
// paged_flash_decode.cu over a page pool [N, Hkv, P, D] reached through a
// block table; the cache element is bf16, or int8 with f32 row scales.
//
// Design: one block per (batch, kv head), 256 threads, holding the
// rep = H / Hkv query rows of that head. The block reads pos[b] from device
// memory (no host sync, so the launch can sit in a CUDA graph) and walks
// the cache in tiles of 256 rows up to pos inclusive, never reading a row
// past it. Per tile: each thread scores one row, its K bytes read as
// independent 16-byte loads (eight for an int8 row, sixteen for bf16; many
// bytes in flight, no shuffles): s = q.k / sqrt(D), with the int8 row's
// scale folded in as the TPU kernel does (s = q.k * (ks * 1/sqrt(D)));
// one warp per query row updates the online softmax (m, l) in shared
// memory and, for int8, turns p into p * vs, as the TPU kernel does before
// its PV product; then the 8 warps split the tile's V rows, each lane
// owning 4 columns (a warp reads whole rows), and meet in shared memory
// once at the end. Output is acc / l in bf16.
//
// The head dim is a template parameter, 128 (Llama) or 64 (GPT-2). A row
// of 64 columns is half the loads per score, and in the PV loop its 16
// column quads leave a warp room for two V rows per pass: lanes 0-15 take
// one row, lanes 16-31 the next, and the two halves meet in the final
// reduction with the warps' partials. At 128 this folds to the code it was.
//
// Paged: row s of slot b lives in page table[b, s / P] at offset s % P.
// The thread that scores a row computes the row's index in the pool once
// and leaves it in shared memory for the softmax (the V scale) and the PV
// loop (the V row); the tile walk is otherwise the dense one, so a tile of
// 256 rows spans 256 / P pages and a page whose first row is past pos is
// never looked up or read.
#pragma once

#include "common.cuh"

#include <type_traits>

namespace flash_decode_detail {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = kThreads;         // cache rows per tile

// d[r] += q_r . (cache row), over the kD elements of one row.
template <int REP, int kD>
__device__ __forceinline__ void row_dots(const int8_t* kr, const float (*qs)[kD],
                                         float (&d)[REP]) {
  uint4 w[kD / 16];
#pragma unroll
  for (int j = 0; j < kD / 16; ++j) w[j] = __ldg(reinterpret_cast<const uint4*>(kr) + j);
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

template <int REP, int kD>
__device__ __forceinline__ void row_dots(const __nv_bfloat16* kr, const float (*qs)[kD],
                                         float (&d)[REP]) {
  // halves of 64 elements (two at kD = 128), eight 16-byte loads each
#pragma unroll
  for (int half = 0; half < kD / 64; ++half) {
    uint4 w[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      w[j] = __ldg(reinterpret_cast<const uint4*>(kr + half * 64) + j);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint32_t u[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const float k0 = __uint_as_float(u[t] << 16), k1 = __uint_as_float(u[t] & 0xffff0000u);
        const int c = half * 64 + j * 8 + t * 2;
#pragma unroll
        for (int r = 0; r < REP; ++r) {
          const float2 qv = *reinterpret_cast<const float2*>(&qs[r][c]);
          d[r] += qv.x * k0 + qv.y * k1;
        }
      }
    }
  }
}

// The 4 cache values of columns 4 * lane .. 4 * lane + 3 of one row
// (lane < kD / 4).
__device__ __forceinline__ void lane_cols(const int8_t* vr, int lane, float (&v)[4]) {
  const uint32_t u = __ldg(reinterpret_cast<const uint32_t*>(vr) + lane);
  v[0] = i8_val(u, 0);
  v[1] = i8_val(u, 8);
  v[2] = i8_val(u, 16);
  v[3] = i8_val(u, 24);
}

__device__ __forceinline__ void lane_cols(const __nv_bfloat16* vr, int lane, float (&v)[4]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(vr) + lane);
  v[0] = __uint_as_float(u.x << 16);
  v[1] = __uint_as_float(u.x & 0xffff0000u);
  v[2] = __uint_as_float(u.y << 16);
  v[3] = __uint_as_float(u.y & 0xffff0000u);
}

// T = int8_t: ks / vs are the rows' f32 scales; T = __nv_bfloat16: unused.
// PAGED: kc / vc / ks / vs are page pools, table is int32 [B, MP] and S is
// MP * P; else table is unused and P is ignored.
template <int REP, typename T, bool PAGED, int kD>
__global__ void __launch_bounds__(kThreads)
flash_decode_kernel(const __nv_bfloat16* __restrict__ q,
                    const T* __restrict__ kc, const T* __restrict__ vc,
                    const float* __restrict__ ks, const float* __restrict__ vs,
                    const int* __restrict__ pos, __nv_bfloat16* __restrict__ out,
                    const int* __restrict__ table, int P,
                    int rep, int Hkv, int S, float scale) {
  constexpr bool Q8 = std::is_same<T, int8_t>::value;
  __shared__ __align__(16) float qs[REP][kD];
  __shared__ float sc[REP][kTile];      // scores, then p (times vs for int8)
  __shared__ float m_s[REP], l_s[REP], alpha_s[REP];
  constexpr int kQuads = kD / 4;          // lanes that cover one V row
  constexpr int kRowsPass = 32 / kQuads;  // V rows a warp takes per pass
  __shared__ float red[kWarps * kRowsPass][kD];
  __shared__ int row_s[PAGED ? kTile : 1];   // pool row index of a tile row
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int quad = lane % kQuads, sub = lane / kQuads;
  const size_t head = (size_t)b * Hkv + h;
  // dense: this head's rows; paged: the pool (rows are found per tile)
  const T* kh = PAGED ? kc : kc + head * S * kD;
  const T* vh = PAGED ? vc : vc + head * S * kD;
  const float* ksh = !Q8 ? nullptr : PAGED ? ks : ks + head * S;
  const float* vsh = !Q8 ? nullptr : PAGED ? vs : vs + head * S;
  const int* tb = PAGED ? table + (size_t)b * (S / P) : nullptr;
  const int n_live = min(max(pos[b], 0), S - 1) + 1;

  for (int i = tid; i < REP * kD; i += kThreads) {
    const int r = i / kD;
    qs[r][i % kD] = r < rep ? bf16_to_f32(q[(head * rep + r) * kD + i % kD]) : 0.f;
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
  __syncthreads();

  for (int t0 = 0; t0 < n_live; t0 += kTile) {
    // scores: thread tid takes row t0 + tid
    const int s = t0 + tid;
    if (s < n_live) {
      float d[REP];
#pragma unroll
      for (int r = 0; r < REP; ++r) d[r] = 0.f;
      int row = s;
      if constexpr (PAGED) {
        const int pg = s / P;
        row = (__ldg(tb + pg) * Hkv + h) * P + (s - pg * P);
        row_s[tid] = row;
      }
      row_dots<REP, kD>(kh + (size_t)row * kD, qs, d);
      const float f = Q8 ? __ldg(ksh + row) * scale : scale;
#pragma unroll
      for (int r = 0; r < REP; ++r) sc[r][tid] = d[r] * f;
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
        sc[r][idx] = t0 + idx >= n_live ? 0.f
                     : Q8 ? p * __ldg(vsh + (PAGED ? row_s[idx] : t0 + idx)) : p;
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
    // (every kRowsPass-th of the warp's) of p[s] * V[s, :]
#pragma unroll
    for (int r = 0; r < REP; ++r) {
      const float a = alpha_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[r][j] *= a;
    }
    const int n = min(kTile, n_live - t0);
    const T* vt = PAGED ? vh : vh + (size_t)t0 * kD;
#pragma unroll 4
    for (int i = warp * kRowsPass + sub; i < n; i += kWarps * kRowsPass) {
      float vv[4];
      lane_cols(vt + (size_t)(PAGED ? row_s[i] : i) * kD, quad, vv);
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
    for (int j = 0; j < 4; ++j) red[warp * kRowsPass + sub][quad * 4 + j] = acc[r][j];
    __syncthreads();
    if (tid < kD) {
      float sum = 0.f;
      for (int w = 0; w < kWarps * kRowsPass; ++w) sum += red[w][tid];
      out[(head * rep + r) * kD + tid] = __float2bfloat16_rn(sum / l_s[r]);
    }
    __syncthreads();
  }
}

template <int REP, typename T, bool PAGED, int kD>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* ks, const void* vs, const void* pos, void* out,
                   const void* table, int P, int B, int rep, int Hkv, int S,
                   float scale, cudaStream_t stream) {
  flash_decode_kernel<REP, T, PAGED, kD><<<dim3(Hkv, B), kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const float*>(ks),
      static_cast<const float*>(vs), static_cast<const int*>(pos),
      static_cast<__nv_bfloat16*>(out), static_cast<const int*>(table), P,
      rep, Hkv, S, scale);
  return cudaGetLastError();
}

// The instantiation for head dim kD and rep = H / Hkv query rows per kv
// head (at most 16).
template <typename T, bool PAGED, int kD>
int dispatch(const void* q, const void* k, const void* v, const void* ks,
             const void* vs, const void* pos, void* out, const void* table,
             int P, int B, int H, int Hkv, int S, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Hkv <= 0 || H % Hkv || S <= 0) return (int)cudaErrorInvalidValue;
  if (PAGED && (P <= 0 || S % P)) return (int)cudaErrorInvalidValue;
  const int rep = H / Hkv;
#define ITT_FD_CASE(R)                                                        \
  if (rep <= R)                                                               \
    return (int)launch<R, T, PAGED, kD>(q, k, v, ks, vs, pos, out, table, P,  \
                                        B, rep, Hkv, S, scale, s);
  ITT_FD_CASE(1) ITT_FD_CASE(2) ITT_FD_CASE(4) ITT_FD_CASE(8) ITT_FD_CASE(16)
#undef ITT_FD_CASE
  return (int)cudaErrorInvalidValue;
}

}  // namespace flash_decode_detail

