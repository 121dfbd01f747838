// Grouped-query flash decode over a dense 16-bit or INT8 KV cache,
// hand-written for Hopper (sm_90a); the kernel body is flash_decode.cuh.
// Python wrappers: kernels/attention.py flash_decode, flash_decode_q8 and
// flash_decode_merge.
//
// Replaces the TPU kernels (infinitensor_tpu/kernels/attention.py)
//   flash_decode     <- _flash_decode_hb_kernel     (:294, via flash_decode :219)
//   flash_decode_q8  <- _flash_decode_q8_hb_kernel  (:345, via flash_decode_q8 :395)
//
// What bounds it on this card: one query token reads every live cache row
// once. At batch 1 the K and V rows are 2 * Hkv * (pos + 1) * D * 2 bytes
// for a 16-bit cache (16.8 MB per layer for Llama-2-7B at pos 1024; twice
// that for f32), or
// 2 * Hkv * (pos + 1) * (D + 4) bytes for int8 rows with their f32 scales
// (8.66 MB), against ~4 * H * (pos + 1) * D flops, so device-memory
// bandwidth is the floor. Unsplit, a 7B layer at batch 1 was 32 blocks on
// 132 SMs (8 for GQA 32/8), each walking its 1025 rows in 4 tiles of
// dependent loads: the kernel was held by one block's latency, 8-15x
// its byte bound. So at few (batch, kv head) blocks the rows of a head are
// split across blocks (flash_decode.cuh, "Split"): the wrapper's
// decode_splits picks the split count from (B, Hkv, S) and the SM count
// only, never from pos; a second small kernel, flash_decode_merge, combines
// the partials. What bounds the 1-slot kernel then is the latency of one
// split's single short tile plus the merge's launch (PERF.md §6 rows 4-5).
// From about as many heads as SMs (B * Hkv; SPLIT_BLOCKS_PER_SM in
// kernels/attention.py) the unsplit form already fills the card and runs
// as before: GPT-2 345M serving (64 slots, 16 heads of 64 columns, at most
// 384 rows) is 1024 blocks of one or two tiles each. The crossover
// between the forms is measured in chip_smoke.py phase 3 (PERF.md §6).
//
// The fast kernels take a bf16, f16 or f32 q (kind kXBf16, kXF16, kXF32)
// over a cache of q's type or int8, at D 64 or 128, and write q's type.
// flash_decode_any and flash_decode_merge_any are the any-type form
// (attention_any.cuh): a bf16, f16 or f32 q, a bf16, f16, f32 or int8
// cache, any head dim from 8 to 256 that is a multiple of 8, the output in
// q's type. The wrappers take it for what the fast kernels do not take:
// a q type other than the cache's (or int8), a head dim other than 64 or
// 128.
#include "flash_decode.cuh"

using flash_decode_detail::dispatch_kind;

ITT_DEFINE_ERROR_STRING()

// q [B, H, 1, D] of kind (kXBf16, kXF16, kXF32); k/v int8 [B, Hkv, S, D]; ks/vs
// f32 [B, Hkv, S]; pos int32 [B] (inclusive: the row just appended); out
// [B, H, 1, D] of kind. D must be 64 or 128 and rep = H / Hkv at most 16.
// splits > 1: the split form, writing part f32 [B, H, splits, D + 2] (not
// out) for flash_decode_merge.
ITT_EXPORT int flash_decode_q8(const void* q, int kind, const void* k,
                               const void* v, const void* ks, const void* vs,
                               const void* pos, void* out, void* part, int B,
                               int H, int Hkv, int S, int D, int splits,
                               float scale, void* stream) {
  return dispatch_kind<true, false>(q, kind, k, v, ks, vs, pos, out, part,
                                    splits, nullptr, 0, B, H, Hkv, S, D, scale,
                                    stream);
}

// As flash_decode_q8 over k/v [B, Hkv, S, D] of q's kind, with no scales.
ITT_EXPORT int flash_decode(const void* q, int kind, const void* k,
                            const void* v, const void* pos, void* out,
                            void* part, int B, int H, int Hkv, int S, int D,
                            int splits, float scale, void* stream) {
  return dispatch_kind<false, false>(q, kind, k, v, nullptr, nullptr, pos, out,
                                     part, splits, nullptr, 0, B, H, Hkv, S, D,
                                     scale, stream);
}

// part f32 [rows, splits, D + 2] (a split's acc, m, l) -> out [rows, D] of
// kind (kXBf16, kXF16, kXF32); D is 64 or 128, splits at most D.
ITT_EXPORT int flash_decode_merge(const void* part, void* out, int kind,
                                  int rows, int splits, int D, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || splits <= 0 || splits > D ||
      (kind != kXBf16 && kind != kXF16 && kind != kXF32))
    return (int)cudaErrorInvalidValue;
  const auto* pp = static_cast<const float*>(part);
  if (D == 128)
    flash_decode_detail::flash_decode_merge<128><<<rows, 128, 0, s>>>(pp, out, kind, splits);
  else if (D == 64)
    flash_decode_detail::flash_decode_merge<64><<<rows, 64, 0, s>>>(pp, out, kind, splits);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// q [B, H, 1, D] of q_kind (kXBf16, kXF16, kXF32); k/v [B, Hkv, S, D] of
// cache_kind (those three, or 3: int8 with ks/vs f32 [B, Hkv, S]); pos
// int32 [B]; out [B, H, 1, D] of q_kind, or (splits > 1) part f32
// [B, H, splits, D + 2] for flash_decode_merge_any. D a multiple of 8 from
// 8 to 256, rep = H / Hkv at most 16.
ITT_EXPORT int flash_decode_any(const void* q, int q_kind, const void* k,
                                const void* v, const void* ks, const void* vs,
                                int cache_kind, const void* pos, void* out,
                                void* part, int B, int H, int Hkv, int S, int D,
                                int splits, float scale, void* stream) {
  return attention_any::dispatch_decode_kind<false>(
      q, q_kind, k, v, ks, vs, cache_kind, pos, out, part, splits, nullptr, 0,
      B, H, Hkv, S, D, scale, stream);
}

// part f32 [rows, splits, D + 2] -> out [rows, D] of out_kind; any D from
// 8 to 256, any number of splits.
ITT_EXPORT int flash_decode_merge_any(const void* part, void* out, int out_kind,
                                      int rows, int splits, int D,
                                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rows <= 0 || splits <= 0 || D < 8 || D > attention_any::kMaxD || D % 8 ||
      out_kind < kXBf16 || out_kind > kXF32)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + attention_any::kWarps - 1) / attention_any::kWarps;
  attention_any::merge_kernel<<<blocks, attention_any::kThreads, 0, s>>>(
      static_cast<const float*>(part), out, out_kind, rows, splits, D);
  return (int)cudaGetLastError();
}
