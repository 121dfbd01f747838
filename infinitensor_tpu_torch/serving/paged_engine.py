"""Paged continuous-batching serving engine (counterpart of
infinitensor_tpu/serving/paged_engine.py).

Drives the page-pool KV machinery (serving/paged_cache.py,
kernels/paged_attention.py) from the continuous batcher, the place paging
pays: heterogeneous sequence lengths share one pool, so total live tokens
can exceed any slot-contiguous layout's capacity (max_slots * max_seq is
never reserved). Pages are allocated on admission and reclaimed on
retirement.

Design:
* page 0 is a TRASH page, never allocated; block-table padding points at
  it, so an append past a slot's reservation (chunked decode overrun) or a
  prefill-bucket tail lands in a page nobody reads (positions gate
  attention) instead of corrupting a neighbour's page;
* admission control: a request is admitted only when the pool has pages
  for prompt + max_new_tokens + decode_chunk slack; otherwise it (and
  everything behind it: FIFO) waits for a retirement to reclaim pages;
* prefill writes a dense [n, Hkv, bucket, D] cache, then its page-aligned
  row blocks are scattered through the block-table rows (bucket is rounded
  up to a page multiple);
* the pools and the block table are updated IN PLACE (index_copy_), so the
  captured decode graph reads the new rows at its next replay.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from infinitensor_tpu_torch.models.llama import (
    init_kv_cache, init_paged_kv_cache,
)
from infinitensor_tpu_torch.serving.engine import ServingEngine, _greedy
from infinitensor_tpu_torch.serving.paged_cache import PageAllocator

_PAGE_KEYS = {"k": "k_pages", "v": "v_pages",
              "k_scale": "ks_pages", "v_scale": "vs_pages"}


def scatter_prefill_into_pages(cache: dict, pcache: dict, row,
                               page_size: int) -> dict:
    """Scatter a dense single-sequence prefill cache into the page pool,
    in place.

    pcache: per-layer dense [1, Hkv, S, D] (and [1, Hkv, S] scale planes
    for INT8), S a multiple of page_size; row [max_pages] integer page ids
    on the pool's device, of which the first S / page_size are written (one
    index_copy_ per pool). Returns `cache`."""
    for dense_key, page_key in _PAGE_KEYS.items():
        if dense_key not in pcache or page_key not in cache:
            continue
        for pool, seg in zip(cache[page_key], pcache[dense_key]):
            seg = seg[0].to(pool.dtype)              # [Hkv, S(, D)]
            Hkv, S = seg.shape[0], seg.shape[1]
            nb = S // page_size
            blocks = seg[:, :nb * page_size].reshape(
                (Hkv, nb, page_size) + seg.shape[2:])
            pool.index_copy_(0, row[:nb].long(), blocks.transpose(0, 1))
    return cache


class PagedServingEngine(ServingEngine):
    """Continuous batcher over a paged KV pool (Llama family by default;
    any model whose decode_fn dispatches on 'k_pages' works)."""

    def __init__(self, params, cfg, max_slots: int = 8,
                 n_pages: int = 64, page_size: int = 64,
                 prefill_buckets: tuple = (32, 128, 512),
                 prefill_fn=None, decode_fn=None, decode_chunk: int = 1,
                 kv_quant: bool = False, mesh=None, param_specs=None,
                 cache_specs=None, checkpoint_interval: int = 0,
                 pipeline_depth: int = 1, lookahead: bool = False, *,
                 device=None):
        self.page_size = int(page_size)
        self.kv_quant = bool(kv_quant)
        # prefill buckets must be page-aligned for the scatter
        buckets = tuple(sorted({
            ((b + page_size - 1) // page_size) * page_size
            for b in prefill_buckets}))

        def make_cache(cfg_, batch, max_seq=None, dtype=None, device=None):
            return init_paged_kv_cache(cfg_, n_pages, page_size, batch,
                                       max_seq, dtype, kv_quant=kv_quant,
                                       device=device)

        super().__init__(params, cfg, max_slots, buckets, prefill_fn,
                         decode_fn, make_cache, decode_chunk,
                         kv_quant=False, mesh=mesh, param_specs=param_specs,
                         cache_specs=cache_specs,
                         checkpoint_interval=checkpoint_interval,
                         pipeline_depth=pipeline_depth,
                         lookahead=lookahead, device=device)
        mp = int(self.cache["block_table"].shape[1])
        # page 0 reserved as the trash page: allocator hands out 1..N-1
        self.allocator = PageAllocator(n_pages, max_slots, mp)
        self.allocator.free = [p for p in self.allocator.free if p != 0]
        self._usable_pages = len(self.allocator.free)

    def _bucket(self, n: int) -> int:
        # page-align EVERY bucket, including the cfg.max_seq fallback the
        # base class returns for prompts above the largest configured
        # bucket: an unaligned bucket would floor-divide in the page
        # scatter and silently drop the prompt's tail KV rows
        b = super()._bucket(n)
        return ((b + self.page_size - 1) // self.page_size) * self.page_size

    def submit(self, prompt, max_new_tokens: int = 32, eos_id=None,
               uid=None):
        ps = self.page_size
        toks = len(prompt) + max_new_tokens + self.decode_chunk + 1
        need = max(min((toks + ps - 1) // ps, self.allocator.max_pages),
                   self._bucket(len(prompt)) // ps)
        if need > self._usable_pages:
            # can never be admitted, even with the pool fully drained:
            # reject now instead of blocking the FIFO forever
            raise ValueError(
                f"request needs {need} pages but the pool only has "
                f"{self._usable_pages} usable (page 0 is reserved); "
                f"grow n_pages or shrink the request")
        return super().submit(prompt, max_new_tokens, eos_id, uid)

    # -- admission ------------------------------------------------------
    def _pages_for(self, req) -> int:
        toks = (len(req.prompt) + req.max_new_tokens
                + self.decode_chunk + 1)
        return min((toks + self.page_size - 1) // self.page_size,
                   self.allocator.max_pages)

    def _admit(self) -> None:
        """Batched admission over the page pool: page-allocate a wave of
        pending requests host-side (FIFO, stopping at pool exhaustion),
        write their block-table rows in ONE device update, and prefill +
        scatter the whole wave per (bucket, lane count) (base-class
        batched-admission discipline; see ServingEngine._prefill_batch_fn).
        """
        while self.pending:
            free = [s for s in range(self.B) if self.slots[s] is None]
            if not free:
                return
            taken = []              # (req, slot, row)
            while self.pending and len(taken) < len(free):
                req = self.pending[0]
                need = max(self._pages_for(req),
                           self._bucket(len(req.prompt)) // self.page_size)
                if not self.allocator.can_alloc(need):
                    break           # pool exhausted: FIFO waits
                self.pending.popleft()
                slot = free[len(taken)]
                self.allocator.alloc(slot, need)
                row = np.asarray(self.allocator.table_row(slot), np.int32)
                taken.append((req, slot, row))
            if not taken:
                return
            slots_arr = np.asarray([s for _, s, _ in taken], np.int64)
            rows_arr = np.stack([r for _, _, r in taken])
            self.cache["block_table"].index_copy_(
                0, self._dev(slots_arr), self._dev(rows_arr))
            by_bucket: dict[int, list] = {}
            for rec in taken:
                by_bucket.setdefault(
                    self._bucket(len(rec[0].prompt)), []).append(rec)
            for bucket, recs in by_bucket.items():
                n = len(recs)
                npad = self._lanes(n)
                toks = np.zeros((npad, bucket), np.int32)
                rows = np.zeros((npad,) + rows_arr.shape[1:], np.int32)
                plens = np.ones((npad,), np.int32)
                for i, (req, _, row) in enumerate(recs):
                    S = len(req.prompt)
                    toks[i, :S] = req.prompt
                    rows[i] = row
                    plens[i] = S
                for i in range(n, npad):    # duplicate lane 0 (idempotent)
                    toks[i] = toks[0]
                    rows[i] = rows[0]
                    plens[i] = plens[0]
                t0 = time.perf_counter()
                first, self.cache = self._prefill_batch_pages_fn(
                    bucket, npad)(self.params, self._dev(toks), self.cache,
                                  self._dev(rows), self._dev(plens))
                first = self._host(first)
                self.stats["prefill_s"] += time.perf_counter() - t0
                self.stats["prefill_launches"] += 1
                self.stats["prefill_tokens"] += float(
                    sum(len(r.prompt) for r, _, _ in recs))
                self.stats["prefill_lane_tokens"] += float(npad * bucket)
                for i, (req, slot, _) in enumerate(recs):
                    tok = int(first[i])
                    req.generated.append(tok)
                    self.slots[slot] = req
                    self.pos[slot] = len(req.prompt)
                    self.last_token[slot] = tok
                    self.tokens_out += 1

    def _retire(self, slot: int) -> None:
        super()._retire(slot)
        self.allocator.release(slot)      # page reclaim
        # The idle slot goes on decoding (at pos 0 and on): point its row
        # at the trash page 0, or its appends would land in the pages just
        # released, which the allocator hands to the next admitted request
        # (a fault the JAX engine keeps; ROADMAP.md Queue 3 item 4).
        self.cache["block_table"][slot].zero_()

    @property
    def free_pages(self) -> int:
        return len(self.allocator.free)

    # -- checkpoint hooks (page ownership is host state) ----------------
    def _extra_snapshot(self) -> dict:
        return {"allocator": {"free": list(self.allocator.free),
                              "owned": [list(o)
                                        for o in self.allocator.owned]}}

    def _extra_restore(self, snap: dict) -> None:
        self.allocator.free = list(snap["allocator"]["free"])
        self.allocator.owned = [list(o) for o in snap["allocator"]["owned"]]

    # -- prefill --------------------------------------------------------
    def _prefill_batch_pages_fn(self, bucket: int, n: int):
        """Batched (n-request dense prefill -> n page scatters -> n first
        tokens) function per (bucket, lane count)."""
        key = (bucket, n)
        fn = self._prefill_batch.get(key)
        if fn is not None:
            return fn
        cfg, prefill_fn = self.cfg, self._prefill_fn
        page_size, kv_quant, device = self.page_size, self.kv_quant, \
            self.device

        def f(params, toks, cache, rows, plens):
            dtype = None if kv_quant else cache["k_pages"][0].dtype
            pcache = init_kv_cache(cfg, n, max_seq=bucket, dtype=dtype,
                                   kv_quant=kv_quant, device=device)
            logits, pcache = prefill_fn(params, cfg, toks, pcache)
            for i in range(n):
                seg = {k2: [buf[i:i + 1] for buf in pcache[k2]]
                       for k2 in pcache}
                cache = scatter_prefill_into_pages(cache, seg, rows[i],
                                                   page_size)
            lanes = torch.arange(n, device=logits.device)
            first = _greedy(logits[lanes, plens.long() - 1])
            return first, cache

        self._prefill_batch[key] = f
        return f
