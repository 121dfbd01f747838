// Band matmuls of Longformer local attention, hand-written for Hopper
// (sm_90a): the first form. Python wrappers: kernels/band.py g2bmm_band,
// gbmm_band with form "simt" (band_form's route for a mixed bf16 / f32
// pair and for k not a multiple of 8 from 8 to 256; forced elsewhere only
// as the yardstick of band_ring.cu, the ring form).
//
// Replaces the TPU kernels of infinitensor_tpu/kernels/band.py:
//   g2bmm <- _g2bmm_kernel (:44, via g2bmm_band :109-130)
//   gbmm  <- _gbmm_kernel  (:68, via gbmm_band  :133-154)
//
// What they compute (dilation 1; J = 2w + 1 band columns):
//   g2bmm: out[b, i, j] = sum_k A[b, i, k] * B[b, i + j - w, k], 0 where
//          i + j - w falls outside [0, m); f32 sums rounded to A's type;
//   gbmm:  out[b, i, k] = sum_j W[b, i, j] * B[b, i + j - w, k], the terms
//          whose i + j - w falls outside [0, m) left out; f32 sums rounded
//          to B's type.
// Inputs are bf16 or f32, each read as f32.
//
// What bounds them on this card: each output element takes k (g2bmm) or
// J (gbmm) multiply-adds over operands that a block shares, so the
// arithmetic per device byte is ~J / 2 (k / 2): at the Longformer shapes
// (k 64-128, w 64-256) under the ~295 operations per byte of the bf16
// tensor cores, so device-memory bytes (A or W, B, out once each) are the
// floor. These kernels run f32 FMAs from shared memory, not the tensor
// cores, and are bound by shared-memory loads well above that floor.
//
// Design, kept simple: a block owns R consecutive rows of one batch. It
// stages the rows of B its band can reach, [r0 - w, r0 + R + w) (rows
// outside [0, m) as zeros), in shared memory once, with its R rows of A
// (or W), so B is read about (R + 2w) / R times in all instead of J
// times. The TPU kernel held three blocks of R >= w rows in VMEM and
// walked the diagonals in a static unroll; here R is 64, halved until the
// window fits the 227 KB of shared memory a block may use, and the loop
// over the diagonals is dynamic. g2bmm: each warp takes a row, its lanes
// 32 consecutive band columns, so the lanes read 32 consecutive window
// rows; their stride is padded (an odd count of 32-bit words) so those
// reads hit distinct banks, while the row of A is a broadcast. gbmm: each
// warp takes a row, its lanes consecutive columns k of the window rows
// (unpadded: consecutive addresses), the band weight a broadcast.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSmemMax = 232448;

template <typename T>
__device__ __forceinline__ float to_f32(T v);
template <>
__device__ __forceinline__ float to_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ float to_f32<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Row stride (elements) of a shared tile of k columns whose consecutive
// rows must fall in distinct banks: an odd number of 32-bit words, or
// for 2-byte types a stride of 2 (mod 4) elements.
template <typename T>
__host__ __device__ inline int padded(int k) {
  if (sizeof(T) == 4) return k | 1;
  int s = k + (k & 1);
  return (s % 4 == 2) ? s : s + 2;
}

// Copy rows [r0 - w, r0 + R + w) of src [m, k] into win (row stride ld),
// zeros outside [0, m).
template <typename T>
__device__ void stage_window(const T* src, T* win, int ld, int r0, int R,
                             int w, int m, int k) {
  const int n = (R + 2 * w) * k;
  for (int e = threadIdx.x; e < n; e += kThreads) {
    const int r = e / k, c = e % k, g = r0 - w + r;
    win[r * ld + c] = (g >= 0 && g < m) ? src[(size_t)g * k + c] : from_f32<T>(0.f);
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(kThreads)
g2bmm_kernel(const TA* __restrict__ a, const TB* __restrict__ b,
             TA* __restrict__ out, int m, int k, int w, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lda = padded<TA>(k), ldb = padded<TB>(k), J = 2 * w + 1;
  TA* as = reinterpret_cast<TA*>(smem);
  TB* win = reinterpret_cast<TB*>(
      smem + (((size_t)R * lda * sizeof(TA) + 15) & ~(size_t)15));
  const int r0 = blockIdx.x * R, bz = blockIdx.y;
  const int nrows = min(R, m - r0);
  const TA* ab = a + (size_t)bz * m * k;
  for (int e = threadIdx.x; e < nrows * k; e += kThreads)
    as[(e / k) * lda + e % k] = ab[(size_t)(r0 + e / k) * k + e % k];
  stage_window(b + (size_t)bz * m * k, win, ldb, r0, R, w, m, k);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TA* ob = out + (size_t)bz * m * J;
  for (int i = warp; i < nrows; i += kWarps) {
    const TA* ar = as + i * lda;
    for (int j = lane; j < J; j += 32) {
      const int tgt = r0 + i + j - w;
      float acc = 0.f;
      if (tgt >= 0 && tgt < m) {
        const TB* br = win + (i + j) * ldb;   // window row of B[tgt]
        for (int c = 0; c < k; ++c) acc = fmaf(to_f32(ar[c]), to_f32(br[c]), acc);
      }
      ob[(size_t)(r0 + i) * J + j] = from_f32<TA>(acc);
    }
  }
}

template <typename TW, typename TB>
__global__ void __launch_bounds__(kThreads)
gbmm_kernel(const TW* __restrict__ wt, const TB* __restrict__ b,
            TB* __restrict__ out, int m, int k, int w, int R) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int J = 2 * w + 1;
  TW* ws = reinterpret_cast<TW*>(smem);
  TB* win = reinterpret_cast<TB*>(
      smem + (((size_t)R * J * sizeof(TW) + 15) & ~(size_t)15));
  const int r0 = blockIdx.x * R, bz = blockIdx.y;
  const int nrows = min(R, m - r0);
  const TW* wb = wt + (size_t)bz * m * J;
  for (int e = threadIdx.x; e < nrows * J; e += kThreads)
    ws[e] = wb[(size_t)r0 * J + e];
  stage_window(b + (size_t)bz * m * k, win, k, r0, R, w, m, k);
  __syncthreads();

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  TB* ob = out + (size_t)bz * m * k;
  for (int i = warp; i < nrows; i += kWarps) {
    // the band columns whose source row lies inside [0, m)
    const int j0 = max(0, w - (r0 + i)), j1 = min(J, m + w - (r0 + i));
    const TW* wr = ws + i * J;
    for (int c = lane; c < k; c += 32) {
      float acc = 0.f;
      for (int j = j0; j < j1; ++j)
        acc = fmaf(to_f32(wr[j]), to_f32(win[(i + j) * k + c]), acc);
      ob[(size_t)(r0 + i) * k + c] = from_f32<TB>(acc);
    }
  }
}

// Rows per block: 64, halved until the staged tiles fit.
inline int pick_rows(int m, int w, size_t bytes_row, size_t bytes_win_row) {
  int R = 64;
  while (R > 1 && (size_t)R * bytes_row + 16 +
                      (size_t)(R + 2 * w) * bytes_win_row > (size_t)kSmemMax)
    R /= 2;
  if (R > m) R = m;
  return ((size_t)R * bytes_row + 16 + (size_t)(R + 2 * w) * bytes_win_row >
          (size_t)kSmemMax) ? 0 : R;
}

template <typename TA, typename TB>
cudaError_t launch_g2bmm(const void* a, const void* b, void* out, int bz,
                         int m, int k, int w, cudaStream_t s) {
  const size_t row_a = padded<TA>(k) * sizeof(TA), row_b = padded<TB>(k) * sizeof(TB);
  const int R = pick_rows(m, w, row_a, row_b);
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = (((size_t)R * row_a + 15) & ~(size_t)15) + (R + 2 * w) * row_b;
  static SmemGrant granted;
  auto kernel = g2bmm_kernel<TA, TB>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((m + R - 1) / R, bz), kThreads, smem, s>>>(
      static_cast<const TA*>(a), static_cast<const TB*>(b),
      static_cast<TA*>(out), m, k, w, R);
  return cudaGetLastError();
}

template <typename TW, typename TB>
cudaError_t launch_gbmm(const void* wt, const void* b, void* out, int bz,
                        int m, int k, int w, cudaStream_t s) {
  const size_t row_w = (size_t)(2 * w + 1) * sizeof(TW), row_b = (size_t)k * sizeof(TB);
  const int R = pick_rows(m, w, row_w, row_b);
  if (R == 0) return cudaErrorInvalidValue;
  const size_t smem = (((size_t)R * row_w + 15) & ~(size_t)15) + (R + 2 * w) * row_b;
  static SmemGrant granted;
  auto kernel = gbmm_kernel<TW, TB>;
  cudaError_t e = allow_smem(kernel, smem, &granted);
  if (e != cudaSuccess) return e;
  kernel<<<dim3((m + R - 1) / R, bz), kThreads, smem, s>>>(
      static_cast<const TW*>(wt), static_cast<const TB*>(b),
      static_cast<TB*>(out), m, k, w, R);
  return cudaGetLastError();
}

}  // namespace

ITT_DEFINE_ERROR_STRING()

// a [bz, m, k] and b [bz, m, k], each bf16 (*_f32 = 0) or f32; out
// [bz, m, 2w + 1] in a's type.
ITT_EXPORT int g2bmm(const void* a, int a_f32, const void* b, int b_f32,
                     void* out, int bz, int m, int k, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bz <= 0 || bz > 65535 || m <= 0 || k <= 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  if (a_f32)
    return b_f32 ? (int)launch_g2bmm<float, float>(a, b, out, bz, m, k, w, s)
                 : (int)launch_g2bmm<float, __nv_bfloat16>(a, b, out, bz, m, k, w, s);
  return b_f32 ? (int)launch_g2bmm<__nv_bfloat16, float>(a, b, out, bz, m, k, w, s)
               : (int)launch_g2bmm<__nv_bfloat16, __nv_bfloat16>(a, b, out, bz, m,
                                                                  k, w, s);
}

// wt [bz, m, 2w + 1] and b [bz, m, k], each bf16 (*_f32 = 0) or f32; out
// [bz, m, k] in b's type.
ITT_EXPORT int gbmm(const void* wt, int w_f32, const void* b, int b_f32,
                    void* out, int bz, int m, int k, int w, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bz <= 0 || bz > 65535 || m <= 0 || k <= 0 || w < 0)
    return (int)cudaErrorInvalidValue;
  if (w_f32)
    return b_f32 ? (int)launch_gbmm<float, float>(wt, b, out, bz, m, k, w, s)
                 : (int)launch_gbmm<float, __nv_bfloat16>(wt, b, out, bz, m, k, w, s);
  return b_f32 ? (int)launch_gbmm<__nv_bfloat16, float>(wt, b, out, bz, m, k, w, s)
               : (int)launch_gbmm<__nv_bfloat16, __nv_bfloat16>(wt, b, out, bz, m,
                                                                 k, w, s);
}
