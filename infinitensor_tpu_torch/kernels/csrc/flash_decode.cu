// Grouped-query flash decode over a dense bf16 or INT8 KV cache,
// hand-written for Hopper (sm_90a); the kernel body is flash_decode.cuh.
// Python wrappers: kernels/attention.py flash_decode and flash_decode_q8.
//
// Replaces the TPU kernels (infinitensor_tpu/kernels/attention.py)
//   flash_decode     <- _flash_decode_hb_kernel     (:294, via flash_decode :219)
//   flash_decode_q8  <- _flash_decode_q8_hb_kernel  (:345, via flash_decode_q8 :395)
//
// What bounds it on this card: one query token reads every live cache row
// once. At batch 1 the K and V rows are 2 * Hkv * (pos + 1) * D * 2 bytes
// for bf16 (16.8 MB per layer for Llama-2-7B at pos 1024), or
// 2 * Hkv * (pos + 1) * (D + 4) bytes for int8 rows with their f32 scales
// (8.66 MB), against ~4 * H * (pos + 1) * D flops, so device-memory
// bandwidth is the floor. At batch 1 a 7B layer is 32 blocks on 132 SMs:
// a sequence split across blocks is a later change. GPT-2 345M serving
// (64 slots, 16 heads of 64 columns, at most 384 rows) is 1024 blocks of
// one or two tiles each.
#include "flash_decode.cuh"

using flash_decode_detail::dispatch;

ITT_DEFINE_ERROR_STRING()

// q bf16 [B, H, 1, D]; k/v int8 [B, Hkv, S, D]; ks/vs f32 [B, Hkv, S];
// pos int32 [B] (inclusive: the row just appended); out bf16 [B, H, 1, D].
// D must be 64 or 128 and rep = H / Hkv at most 16.
ITT_EXPORT int flash_decode_q8(const void* q, const void* k, const void* v,
                               const void* ks, const void* vs,
                               const void* pos, void* out, int B, int H,
                               int Hkv, int S, int D, float scale,
                               void* stream) {
  if (D == 64)
    return dispatch<int8_t, false, 64>(q, k, v, ks, vs, pos, out, nullptr, 0, B, H,
                                       Hkv, S, scale, stream);
  if (D != 128) return (int)cudaErrorInvalidValue;
  return dispatch<int8_t, false, 128>(q, k, v, ks, vs, pos, out, nullptr, 0, B, H,
                                      Hkv, S, scale, stream);
}

// As flash_decode_q8 over bf16 k/v [B, Hkv, S, D], with no scales.
ITT_EXPORT int flash_decode(const void* q, const void* k, const void* v,
                            const void* pos, void* out, int B, int H, int Hkv,
                            int S, int D, float scale, void* stream) {
  if (D == 64)
    return dispatch<__nv_bfloat16, false, 64>(q, k, v, nullptr, nullptr, pos, out,
                                              nullptr, 0, B, H, Hkv, S, scale, stream);
  if (D != 128) return (int)cudaErrorInvalidValue;
  return dispatch<__nv_bfloat16, false, 128>(q, k, v, nullptr, nullptr, pos, out,
                                             nullptr, 0, B, H, Hkv, S, scale, stream);
}
