"""KV-cache managers: the serving-time role of the paper's allocator.

Copied from the JAX package.  Requests of wildly different lengths hold
per-token KV state for their whole lifetime; two managers account for it:

- :class:`KVSlabManager` — contiguous per-request regions placed with the
  same chunked machinery as the paper's allocator (2 MB slabs, best-gap
  placement, chunk release when idle);
- :class:`BlockTableManager` — paged layout: fixed-size token blocks
  carved from ONE preallocated pool, per-request block lists, free-list
  recycling.  Footprint is bounded by *live* blocks (paper Figs. 11/12 in
  KV form, at block granularity), and a sequence can grow past any initial
  length estimate by appending blocks — no cache re-materialization.

The port serves the paged layout without a shared prefix
cache, so the refcounts here only ever count one holder per block; they
stay because the sanitizer's shadow counts check them.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from repro_torch.configs.base import ModelConfig
from repro_torch.core.cost_model import blocks_for_tokens

DEFAULT_KV_CHUNK = 2 * 1024 * 1024
K_SCALE = 1.2


def kv_bytes_per_token(cfg: ModelConfig, dtype_bytes: int = 2) -> int:
    """Per-token cache bytes for one request (all layers)."""
    return 2 * cfg.num_layers * cfg.num_kv_heads * cfg.head_dim * dtype_bytes


@dataclass
class Region:
    req_id: int
    chunk_id: int
    offset: int
    size: int
    tokens: int = 0                   # KV tokens this region backs


@dataclass
class _Slab:
    chunk_id: int
    size: int
    live: List[Region] = field(default_factory=list)   # sorted by offset

    def best_gap(self, size: int) -> Optional[int]:
        """Smallest gap among live regions that fits (FindGapFromChunk's
        search, over live allocations instead of lifetime overlaps)."""
        prev = 0
        best: Optional[int] = None
        best_gap = float("inf")
        for r in sorted(self.live, key=lambda r: r.offset):
            gap = r.offset - prev
            if size <= gap < best_gap:
                best_gap = gap
                best = prev
            prev = max(prev, r.offset + r.size)
        if best is None and self.size - prev >= size:
            best = prev
        return best


class KVSlabManager:
    """Chunked slab allocator for per-request KV/SSM regions."""

    def __init__(self, chunk_size: int = DEFAULT_KV_CHUNK,
                 k_scale: float = K_SCALE,
                 max_idle: int = 1) -> None:
        self.chunk_size = chunk_size
        self.k_scale = k_scale
        self.max_idle = max_idle
        self.slabs: Dict[int, _Slab] = {}
        self._regions: Dict[int, Region] = {}
        self._idle: Dict[int, int] = {}
        self._next_id = 0
        self.allocated_bytes = 0
        self.freed_bytes = 0

    def allocate(self, req_id: int, size: int, tokens: int = 0) -> Region:
        if req_id in self._regions:
            raise KeyError(f"request {req_id} already has a region")
        for slab in self.slabs.values():
            off = slab.best_gap(size)
            if off is not None:
                region = Region(req_id, slab.chunk_id, off, size, tokens)
                slab.live.append(region)
                self._regions[req_id] = region
                return region
        cap = max(self.chunk_size, int(size * self.k_scale))
        slab = _Slab(self._next_id, cap)
        self._next_id += 1
        self.slabs[slab.chunk_id] = slab
        self.allocated_bytes += cap
        region = Region(req_id, slab.chunk_id, 0, size, tokens)
        slab.live.append(region)
        self._regions[req_id] = region
        return region

    def has_region(self, req_id: int) -> bool:
        return req_id in self._regions

    def free(self, req_id: int) -> None:
        region = self._regions.pop(req_id)
        slab = self.slabs[region.chunk_id]
        slab.live.remove(region)

    def gc(self) -> None:
        """Release slabs idle for more than ``max_idle`` gc rounds."""
        for cid in list(self.slabs):
            slab = self.slabs[cid]
            if slab.live:
                self._idle[cid] = 0
                continue
            idles = self._idle.get(cid, 0) + 1
            if idles > self.max_idle:
                self.freed_bytes += slab.size
                del self.slabs[cid]
                self._idle.pop(cid, None)
            else:
                self._idle[cid] = idles

    @property
    def footprint(self) -> int:
        return sum(s.size for s in self.slabs.values())

    @property
    def live_bytes(self) -> int:
        return sum(r.size for r in self._regions.values())

    @property
    def live_tokens(self) -> int:
        """Tokens of KV state currently held — under iteration-level
        serving this tracks the *live* sequence set, dropping the moment
        a request hits EOS (paper Figs. 11/12, in KV form)."""
        return sum(r.tokens for r in self._regions.values())

    def metrics(self) -> dict:
        """Host-int gauge levels for the observability registry (see
        `repro_torch.obs`) — sampled at tick boundaries, never a device read."""
        return {"footprint_bytes": self.footprint,
                "live_bytes": self.live_bytes,
                "live_tokens": self.live_tokens}


DEFAULT_KV_BLOCK = 16      # tokens per paged-KV block


class BlockExhausted(RuntimeError):
    """No free blocks left in the paged-KV pool."""


class BlockTableManager:
    """Block tables over one preallocated paged-KV pool.

    ``num_blocks`` fixed-size blocks of ``block_size`` tokens each.  Block
    index 0 is reserved as the *trash* block: it is never handed out, block
    tables are initialized/reset to it, so stray writes from device rows
    whose host-side bookkeeping lags (e.g. a sequence that hit EOS between
    host syncs) land in a sink that no live sequence reads.

    The manager is pure host-side accounting — the device pool array lives
    in the engine's cache pytree; this class decides *which* physical block
    each (request, logical block index) maps to, recycles freed blocks
    through a free list, and reports live-token / live-block footprint.

    Every non-free block carries a **refcount** of its holders;
    :meth:`free` and :meth:`unref` return a block to the free list when
    the last holder lets go.
    """

    def __init__(self, num_blocks: int,
                 block_size: int = DEFAULT_KV_BLOCK) -> None:
        if block_size <= 0:
            raise ValueError(f"block_size must be positive: {block_size}")
        if num_blocks < 2:
            raise ValueError("need >= 2 blocks (block 0 is the trash "
                             f"block), got {num_blocks}")
        self.num_blocks = num_blocks
        self.block_size = block_size
        # LIFO recycling: recently freed blocks are re-used first
        self._free: List[int] = list(range(num_blocks - 1, 0, -1))
        self._tables: Dict[int, List[int]] = {}
        self._tokens: Dict[int, int] = {}
        # per-block holder counts; the trash block is permanently held by
        # the manager itself so it can never enter the free list
        self._refs: List[int] = [0] * num_blocks
        self._refs[0] = 1

    # -- queries ---------------------------------------------------------
    @property
    def capacity_tokens(self) -> int:
        """Tokens the whole pool can hold (trash block excluded)."""
        return (self.num_blocks - 1) * self.block_size

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    @property
    def used_blocks(self) -> int:
        return (self.num_blocks - 1) - len(self._free)

    @property
    def footprint_tokens(self) -> int:
        """Token capacity of the blocks currently held by live requests —
        the paged analogue of :attr:`KVSlabManager.live_tokens`, bounded
        by the live block set instead of per-request length reservations."""
        return self.used_blocks * self.block_size

    @property
    def live_tokens(self) -> int:
        """Tokens of KV state actually written by live requests."""
        return sum(self._tokens.values())

    def metrics(self) -> dict:
        """Host-int gauge levels for the observability registry (see
        `repro_torch.obs`) — sampled at tick boundaries, never a device read."""
        return {"blocks_free": self.free_blocks,
                "blocks_used": self.used_blocks,
                "capacity_tokens": self.capacity_tokens,
                "footprint_tokens": self.footprint_tokens,
                "live_tokens": self.live_tokens}

    def has_request(self, req_id: int) -> bool:
        return req_id in self._tables

    def block_table(self, req_id: int) -> List[int]:
        return list(self._tables[req_id])

    def blocks_of(self, req_id: int) -> int:
        return len(self._tables[req_id])

    def blocks_needed(self, tokens: int) -> int:
        return blocks_for_tokens(tokens, self.block_size)

    # -- refcounts -------------------------------------------------------
    def unref(self, block_id: int) -> bool:
        """Drop one holder; recycle the block when the last one lets go.
        Returns True iff the block went back to the free list."""
        if block_id <= 0 or self._refs[block_id] <= 0:
            raise ValueError(f"block {block_id} is not held")
        self._refs[block_id] -= 1
        if self._refs[block_id] == 0:
            self._free.append(block_id)
            return True
        return False

    # -- allocation ------------------------------------------------------
    def _take(self, n: int) -> List[int]:
        if n > len(self._free):
            raise BlockExhausted(
                f"need {n} blocks, only {len(self._free)} free "
                f"(pool {self.num_blocks - 1})")
        out = [self._free.pop() for _ in range(n)]
        for b in out:
            self._refs[b] = 1
        return out

    def allocate(self, req_id: int, tokens: int) -> List[int]:
        """Admission-time allocation: a table covering ``tokens``.
        Returns the physical block ids, in logical order."""
        if req_id in self._tables:
            raise KeyError(f"request {req_id} already has a block table")
        blocks = self._take(max(self.blocks_needed(tokens), 1))
        self._tables[req_id] = blocks
        self._tokens[req_id] = tokens
        return list(blocks)

    def ensure(self, req_id: int, tokens: int) -> List[int]:
        """Grow ``req_id``'s table to cover ``tokens`` (mid-decode block
        append).  Returns the newly appended physical block ids ([] when
        the current table already covers the length)."""
        table = self._tables[req_id]
        need = self.blocks_needed(tokens) - len(table)
        fresh = self._take(need) if need > 0 else []
        table.extend(fresh)
        self._tokens[req_id] = max(self._tokens[req_id], tokens)
        return fresh

    def free(self, req_id: int) -> None:
        """Release ``req_id``'s table: every block drops one holder and
        returns to the free list when none is left.  A no-op for unknown or
        already-freed ids, so engine error-path cleanup can sweep every
        session of a failed batch without tracking which ones got
        tables."""
        blocks = self._tables.pop(req_id, None)
        if blocks is None:
            return
        self._tokens.pop(req_id)
        for b in reversed(blocks):
            self.unref(b)
