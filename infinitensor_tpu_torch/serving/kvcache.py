"""KV-cache slot management (counterpart of
infinitensor_tpu/serving/kvcache.py).

A slot cache: per layer, one static buffer [B_slots, Hkv, S_max, D] whose
batch dimension is a pool of sequence slots. Every function here writes the
serving cache IN PLACE (copy_ into a slice; the JAX package donates the
buffers instead) and returns the same dict, so tensors keep their addresses
and a captured CUDA graph stays valid. Generic over the leaves' rank: the
INT8 cache's scale planes [B, Hkv, S_max] ride along.

Cache layout: {"k": [L tensors], "v": [L tensors]} plus "k_scale" /
"v_scale" for INT8 (models/llama.py init_kv_cache).
"""

from __future__ import annotations


def _each(cache: dict):
    for bufs in cache.values():
        yield from bufs


def clone_kv_slot(cache: dict, src: int, dst: int) -> dict:
    """Copy sequence state between slots (used to fork a sequence, e.g.
    for beam or speculative branches)."""
    for buf in _each(cache):
        buf[dst].copy_(buf[src])
    return cache


def clear_kv_slot(cache: dict, slot: int) -> dict:
    """Zero a slot (numerically inert since positions gate attention, but
    keeps state hygienic)."""
    for buf in _each(cache):
        buf[slot].zero_()
    return cache


def merge_prefill_into_slot(cache: dict, prefill_cache: dict, slot) -> dict:
    """Write a single-sequence prefill cache (per-layer [1, H, S, D]) into
    rows [0, S) of `slot` of the serving cache (per-layer [B, H, S_max,
    D])."""
    slot = int(slot)
    for key in cache:
        for buf, seg in zip(cache[key], prefill_cache[key]):
            buf[slot, :, :seg.shape[2]].copy_(seg[0])
    return cache


def write_prefill_into_slot(cache: dict, prefill_cache: dict, slot: int
                            ) -> dict:
    """merge_prefill_into_slot under the JAX package's other name (there a
    jitted wrapper with a static slot)."""
    return merge_prefill_into_slot(cache, prefill_cache, slot)
