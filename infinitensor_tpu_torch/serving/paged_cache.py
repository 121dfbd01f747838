"""Paged KV-cache manager: host-side page allocator + device page pool
(counterpart of infinitensor_tpu/serving/paged_cache.py).

Sequences own pages of one shared pool through a block table and free them
on retirement, so max_slots * max_seq memory is never reserved up front and
long and short sequences share the pool.

Device state per layer: k_pages/v_pages [N, Hkv, P, D]. Shared across
layers: block_table [slots, max_pages] int32 on the device, and the HOST
free list in this manager (allocation decisions are control flow, not
compute: they stay off the device).
"""

from __future__ import annotations

import dataclasses

import torch

from infinitensor_tpu_torch.utils.platform import resolve_device


@dataclasses.dataclass
class PagedKVCache:
    """Paged cache for an L-layer model."""

    k_pages: list          # L x [N, Hkv, P, D]
    v_pages: list
    block_table: torch.Tensor   # [slots, max_pages] int32 page ids
    page_size: int

    @property
    def n_pages(self) -> int:
        return self.k_pages[0].shape[0]

    @property
    def max_pages_per_seq(self) -> int:
        return int(self.block_table.shape[1])


def init_paged_cache(n_layers: int, n_pages: int, n_kv_heads: int,
                     page_size: int, head_dim: int, max_slots: int,
                     max_seq: int, dtype=torch.bfloat16, *,
                     device=None) -> PagedKVCache:
    device = resolve_device(device)
    mp = (max_seq + page_size - 1) // page_size
    shape = (n_pages, n_kv_heads, page_size, head_dim)
    return PagedKVCache(
        k_pages=[torch.zeros(shape, dtype=dtype, device=device)
                 for _ in range(n_layers)],
        v_pages=[torch.zeros(shape, dtype=dtype, device=device)
                 for _ in range(n_layers)],
        block_table=torch.zeros((max_slots, mp), dtype=torch.int32,
                                device=device),
        page_size=page_size,
    )


class PageAllocator:
    """Host-side free-list over page ids (one id space shared by all
    layers: page i of every layer is allocated/freed together)."""

    def __init__(self, n_pages: int, max_slots: int, max_pages: int):
        self.free = list(range(n_pages - 1, -1, -1))
        self.owned: list = [[] for _ in range(max_slots)]
        self.max_pages = max_pages

    def pages_needed(self, length: int, page_size: int) -> int:
        return (length + page_size - 1) // page_size

    def can_alloc(self, n: int) -> bool:
        return len(self.free) >= n

    def alloc(self, slot: int, n: int = 1) -> list:
        if len(self.free) < n:
            raise MemoryError(f"paged KV pool exhausted ({n} requested, "
                              f"{len(self.free)} free)")
        got = [self.free.pop() for _ in range(n)]
        self.owned[slot].extend(got)
        if len(self.owned[slot]) > self.max_pages:
            raise MemoryError(f"slot {slot} exceeds max_pages_per_seq")
        return got

    def release(self, slot: int) -> None:
        self.free.extend(reversed(self.owned[slot]))
        self.owned[slot] = []

    def table_row(self, slot: int) -> list:
        row = list(self.owned[slot])
        row += [0] * (self.max_pages - len(row))
        return row
