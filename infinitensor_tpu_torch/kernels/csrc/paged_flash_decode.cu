// Paged flash decode, the block form: one query token per slot over a
// pool of fixed-size KV pages reached through a block table, hand-written
// for Hopper (sm_90a); the kernel body is flash_decode.cuh with PAGED set,
// one block a (slot, kv head). Python wrappers: kernels/paged_attention.py
// paged_flash_decode and paged_flash_decode_q8, which take the ring form of
// paged_flash_decode_ring.cu for the same inputs (page chunks over a ring
// of asynchronous page copies); this form runs only where a caller forces
// it (_form="block"), as the yardstick beside the ring form
// (chip_smoke.py phase 3's crossover, phase 6's paged step in turns).
//
// Replaces the TPU kernels (infinitensor_tpu/kernels/paged_attention.py)
//   paged_flash_decode     <- _paged_kernel     (:146, via paged_flash_decode :288)
//   paged_flash_decode_q8  <- _paged_q8_kernel  (:187, via paged_flash_decode_q8 :234)
//
// What bounds it on this card: every live row of every slot is read once,
// 2 * Hkv * (pos[b] + 1) * D * 2 bytes per slot for 16-bit pages (* 4 for
// f32), or
// 2 * Hkv * (pos[b] + 1) * (D + 4) for int8 pages with their f32 scales,
// against ~4 * H * (pos[b] + 1) * D flops: device-memory bandwidth. The
// TPU kernel's grid covers every page of the table and still copies the
// pages past pos; here the block's loop ends at pos[b], so those pages cost
// nothing and may hold anything. The block table and pos are read on the
// device, so the launch sits in a CUDA graph; the page size is a runtime
// argument. With 8 slots a 7B layer is 256 blocks on 132 SMs (GQA 32/8:
// 64), and ragged slots end with the longest one's blocks: what the ring
// form's page chunks answer.
//
// The fast kernels take a bf16, f16 or f32 q (kind kXBf16, kXF16, kXF32)
// over pages of q's type or int8, at D 64 or 128, and write q's type;
// paged_flash_decode_any is the any-type form of attention_any.cuh (a
// bf16, f16 or f32 q, bf16, f16, f32 or int8 pages, D a multiple of 8
// from 8 to 256, out in q's type) for what they do not take.
#include "flash_decode.cuh"

using flash_decode_detail::dispatch_kind;

ITT_DEFINE_ERROR_STRING()

// q [B, H, 1, D] of kind (kXBf16, kXF16, kXF32); k/v pages int8 [N, Hkv, P, D];
// ks/vs pages f32 [N, Hkv, P]; table int32 [B, MP] (page ids); pos int32
// [B] (inclusive); out [B, H, 1, D] of kind. D must be 64 or 128 and
// rep = H / Hkv at most 16.
ITT_EXPORT int paged_flash_decode_q8(const void* q, int kind, const void* k,
                                     const void* v, const void* ks,
                                     const void* vs, const void* table,
                                     const void* pos, void* out, int B, int H,
                                     int Hkv, int P, int MP, int D,
                                     float scale, void* stream) {
  return dispatch_kind<true, true>(q, kind, k, v, ks, vs, pos, out, nullptr, 1,
                                   table, P, B, H, Hkv, MP * P, D, scale, stream);
}

// As paged_flash_decode_q8 over pages of q's kind, with no scales.
ITT_EXPORT int paged_flash_decode(const void* q, int kind, const void* k,
                                  const void* v, const void* table,
                                  const void* pos, void* out, int B, int H,
                                  int Hkv, int P, int MP, int D, float scale,
                                  void* stream) {
  return dispatch_kind<false, true>(q, kind, k, v, nullptr, nullptr, pos, out,
                                    nullptr, 1, table, P, B, H, Hkv, MP * P, D,
                                    scale, stream);
}

// q [B, H, 1, D] of q_kind; pages [N, Hkv, P, D] of cache_kind (kXBf16,
// kXF16, kXF32, or 3: int8 with ks/vs pages f32 [N, Hkv, P]); table int32
// [B, MP]; pos int32 [B]; out [B, H, 1, D] of q_kind. D a multiple of 8
// from 8 to 256, rep at most 16.
ITT_EXPORT int paged_flash_decode_any(const void* q, int q_kind, const void* k,
                                      const void* v, const void* ks,
                                      const void* vs, int cache_kind,
                                      const void* table, const void* pos,
                                      void* out, int B, int H, int Hkv, int P,
                                      int MP, int D, float scale, void* stream) {
  return attention_any::dispatch_decode_kind<true>(
      q, q_kind, k, v, ks, vs, cache_kind, pos, out, nullptr, 1, table, P, B, H,
      Hkv, MP * P, D, scale, stream);
}
