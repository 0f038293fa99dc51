"""KV-cache block allocator (the port's copy of repro.serve.kv_alloc,
without the prefix-sharing refcount paths).

A paged serving cache (models/transformer.paged_cache_schema) keeps every
global layer's KV in one shared pool of blocks; a request holds exactly
ceil((prompt + max_new_tokens) / page_size) of them, so ServeEngine admits
by free blocks instead of worst-case slot envelopes.  All blocks are
interchangeable (one page of every layer's pool), so a free list is enough
and there is no external fragmentation.  The list is LIFO, which keeps the
working set of hot blocks dense.  Sharing (refcounted blocks for prefix
sharing) joins with the prefix-sharing slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List


@dataclasses.dataclass
class AllocStats:
    """Lifetime counters (across run() calls)."""
    allocs: int = 0            # satisfied allocation requests
    frees: int = 0             # released allocations
    blocks_served: int = 0     # total blocks handed out
    denied: int = 0            # can_allocate=False probes (backpressure)
    peak_in_use: int = 0


class BlockAllocator:
    """Free-list allocator over `num_blocks` interchangeable cache blocks."""

    def __init__(self, num_blocks: int):
        if num_blocks < 1:
            raise ValueError(f"num_blocks must be >= 1, got {num_blocks}")
        self.num_blocks = num_blocks
        self._free: List[int] = list(range(num_blocks - 1, -1, -1))
        self._in_use = [False] * num_blocks
        self.stats = AllocStats()

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.num_blocks - len(self._free)

    def utilization(self) -> float:
        return self.in_use / self.num_blocks

    def can_allocate(self, n: int) -> bool:
        """Admission probe; a False result is counted as backpressure."""
        ok = n <= len(self._free)
        if not ok:
            self.stats.denied += 1
        return ok

    def alloc(self, n: int) -> List[int]:
        """Pop `n` block ids, or raise -- callers gate on can_allocate."""
        if n < 0:
            raise ValueError(f"cannot allocate {n} blocks")
        if n > len(self._free):
            raise RuntimeError(
                f"out of KV blocks: want {n}, have {len(self._free)} free "
                f"of {self.num_blocks} (admission must gate on "
                "can_allocate)")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._in_use[b] = True
        self.stats.allocs += 1
        self.stats.blocks_served += n
        self.stats.peak_in_use = max(self.stats.peak_in_use, self.in_use)
        return out

    def free(self, blocks: List[int]) -> None:
        """Return blocks to the pool (freeing a free block is a bug)."""
        for b in blocks:
            if not 0 <= b < self.num_blocks:
                raise ValueError(f"block id {b} out of range "
                                 f"[0, {self.num_blocks})")
            if not self._in_use[b]:
                raise ValueError(f"double free of block {b}")
        for b in blocks:
            self._in_use[b] = False
        self._free.extend(blocks)
        if blocks:
            self.stats.frees += 1

    def describe(self) -> Dict[str, object]:
        return {
            "num_blocks": self.num_blocks,
            "free_blocks": self.free_blocks,
            "in_use": self.in_use,
            "utilization": self.utilization(),
            "peak_in_use": self.stats.peak_in_use,
            "allocs": self.stats.allocs,
            "frees": self.stats.frees,
            "denied": self.stats.denied,
        }
