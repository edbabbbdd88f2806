"""Baseline allocators the paper compares against (Figs. 11/12), copied
from the JAX package.

- :class:`CachingAllocator` — PyTorch / NVlabs-cub style caching device
  allocator: frees go to a size-binned cache and are reassigned to later
  mallocs; device memory is only really released under pressure, so the
  footprint ratchets up to the historical peak.
- :class:`GSOCAllocator` — Greedy-by-Size-for-Offset-Calculation [24] in a
  single arena: near-optimal footprint for the *current* graph, but the
  arena must be reallocated whenever a larger plan arrives (more real
  alloc/free traffic than the chunked planner — paper Fig. 12).

Both consume the same ``TensorUsageRecord`` streams as Algorithm 1 so the
benchmarks are apples-to-apples.
"""
from __future__ import annotations

import bisect
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.allocator import TensorUsageRecord


class CachingAllocator:
    """Simulates torch.cuda's caching allocator over one usage-record
    stream per inference: alloc at first_op, free at last_op."""

    def __init__(self, round_to: int = 512) -> None:
        self.round_to = round_to
        self._free_blocks: List[int] = []      # sorted sizes
        self.reserved = 0                      # total device memory held
        self.allocated_bytes = 0               # cudaMalloc traffic
        self.freed_bytes = 0
        self.alloc_events = 0
        self.free_events = 0

    def _round(self, size: int) -> int:
        r = self.round_to
        return max(((size + r - 1) // r) * r, r)

    def run_inference(self, records: Sequence[TensorUsageRecord]) -> int:
        """Returns peak reserved bytes during this inference."""
        events: Dict[int, List[Tuple[str, TensorUsageRecord]]] = {}
        for rec in records:
            events.setdefault(rec.first_op, []).append(("alloc", rec))
            events.setdefault(rec.last_op, []).append(("free", rec))
        live: Dict[str, int] = {}
        peak = self.reserved
        for op in sorted(events):
            # allocations of this op first, frees after the op completes
            for kind, rec in events[op]:
                if kind != "alloc":
                    continue
                size = self._round(rec.size)
                i = bisect.bisect_left(self._free_blocks, size)
                if i < len(self._free_blocks):
                    size = self._free_blocks.pop(i)   # reuse cached block
                else:
                    self.reserved += size             # real cudaMalloc
                    self.allocated_bytes += size
                    self.alloc_events += 1
                live[rec.tensor_id] = size
            peak = max(peak, self.reserved)
            for kind, rec in events[op]:
                if kind != "free":
                    continue
                size = live.pop(rec.tensor_id)
                bisect.insort(self._free_blocks, size)  # cache, not release
        return peak

    @property
    def footprint(self) -> int:
        return self.reserved


class GSOCAllocator:
    """Greedy-by-Size Offset Calculation [24] in one contiguous arena.

    As published, GSOC is a *static per-graph planner*: the arena is sized
    for one inference and materialized per inference (alloc+free traffic —
    the behaviour the paper's Fig. 12 contrasts against). Setting
    ``cache_arena=True`` keeps a grow-only arena instead (monotone
    footprint, less traffic)."""

    def __init__(self, cache_arena: bool = False) -> None:
        self.cache_arena = cache_arena
        self.arena = 0
        self.allocated_bytes = 0
        self.freed_bytes = 0
        self.alloc_events = 0
        self.free_events = 0

    @staticmethod
    def plan_offsets(records: Sequence[TensorUsageRecord]
                     ) -> Tuple[Dict[str, int], int]:
        """Offsets + required arena size for one inference."""
        offsets: Dict[str, int] = {}
        placed: List[Tuple[int, TensorUsageRecord]] = []  # (offset, rec)
        total = 0
        for t in sorted(records, key=lambda r: r.size, reverse=True):
            prev_offset = 0
            best: Optional[int] = None
            best_gap = float("inf")
            for off, x in sorted(placed, key=lambda p: p[0]):
                if t.overlaps(x):
                    gap = off - prev_offset
                    if t.size <= gap < best_gap:
                        best_gap = gap
                        best = prev_offset
                    prev_offset = max(prev_offset, off + x.size)
            if best is None:
                best = prev_offset
            offsets[t.tensor_id] = best
            placed.append((best, t))
            total = max(total, best + t.size)
        return offsets, total

    def run_inference(self, records: Sequence[TensorUsageRecord]) -> int:
        _, required = self.plan_offsets(records)
        if self.cache_arena:
            if required > self.arena:
                if self.arena:
                    self.freed_bytes += self.arena   # realloc: free+malloc
                    self.free_events += 1
                self.allocated_bytes += required
                self.alloc_events += 1
                self.arena = required
        else:
            if self.arena:
                self.freed_bytes += self.arena
                self.free_events += 1
            self.allocated_bytes += required
            self.alloc_events += 1
            self.arena = required
        return self.arena

    @property
    def footprint(self) -> int:
        return self.arena
