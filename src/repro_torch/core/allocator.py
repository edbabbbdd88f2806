"""TurboTransformers Algorithm 1: the sequence-length-aware allocator,
copied from the JAX package (the same names, defaults and arithmetic).

Faithful reimplementation of the paper's chunked, computation-graph-aware
memory planner:

 - memory is organized in *chunks* (DEFAULT_CHUNK_SIZE = 2 MB);
 - tensor lifetimes come from the computation graph as usage records
   ``{first_op, last_op, size}`` (indices from a topological sort);
 - ``MemAllocate`` sorts records by decreasing size and, per record,
   ``FindGapFromChunk`` searches every chunk for the smallest gap that fits
   among offset-overlapping-lifetime tensors (a Greedy-by-Size-for-Offset-
   Calculation variant, O(n^2));
 - a new chunk of size ``max(DEFAULT_CHUNK_SIZE, size * K_SCALE)`` is
   appended when nothing fits; unused chunks are released after planning.

The planner is re-invoked per request length (that is the paper's point:
planning is cheap — Fig. 13 — and footprint tracks the *current* length
instead of the historical maximum).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

DEFAULT_CHUNK_SIZE = 2 * 1024 * 1024   # 2 MB, as in the paper
K_SCALE = 1.2                          # over-allocation factor, as in paper


@dataclass(frozen=True)
class TensorUsageRecord:
    tensor_id: str
    first_op: int
    last_op: int
    size: int                          # bytes

    def overlaps(self, other: "TensorUsageRecord") -> bool:
        return (max(self.first_op, other.first_op)
                <= min(self.last_op, other.last_op))


@dataclass
class _Placed:
    record: TensorUsageRecord
    offset: int


@dataclass
class Chunk:
    chunk_id: int
    size: int
    placed: List[_Placed] = field(default_factory=list)

    def insert(self, record: TensorUsageRecord, offset: int) -> None:
        self.placed.append(_Placed(record, offset))
        self.placed.sort(key=lambda p: p.offset)

    def used_this_plan(self) -> bool:
        return bool(self.placed)

    def reset(self) -> None:
        self.placed.clear()


@dataclass
class AllocationPlan:
    assignments: Dict[str, Tuple[int, int]]   # tensor_id -> (chunk, offset)
    chunks: List[Chunk]

    @property
    def footprint(self) -> int:
        return sum(c.size for c in self.chunks)


INVALID = -1


def find_gap_from_chunk(t: TensorUsageRecord, chunk: Chunk) -> int:
    """Paper's FindGapFromChunk: smallest gap among lifetime-overlapping
    tensors already placed in ``chunk`` that fits ``t``; INVALID if none."""
    smallest_gap = float("inf")
    prev_offset = 0
    best_offset: Optional[int] = None
    for placed in chunk.placed:                      # ordered by offset
        x = placed.record
        if t.overlaps(x):
            gap = placed.offset - prev_offset
            if t.size <= gap < smallest_gap:
                smallest_gap = gap
                best_offset = prev_offset
            prev_offset = max(prev_offset, placed.offset + x.size)
    if best_offset is None and chunk.size - prev_offset >= t.size:
        best_offset = prev_offset
    return INVALID if best_offset is None else best_offset


class SequenceAwareAllocator:
    """Stateful planner reused across inferences (chunks are cached).

    ``allocated_bytes`` / ``freed_bytes`` count real device-memory traffic
    (chunk creation/release), the quantity plotted in the paper's Fig. 12.
    """

    def __init__(self, default_chunk_size: int = DEFAULT_CHUNK_SIZE,
                 k_scale: float = K_SCALE,
                 max_idle_inferences: int = 0) -> None:
        self.default_chunk_size = default_chunk_size
        self.k_scale = k_scale
        self.max_idle_inferences = max_idle_inferences
        self.chunks: List[Chunk] = []
        self._idle_counts: Dict[int, int] = {}
        self._next_chunk_id = 0
        self.allocated_bytes = 0
        self.freed_bytes = 0
        self.alloc_events = 0
        self.free_events = 0

    # -- paper Algorithm 1, MemAllocate ------------------------------------
    def plan(self, records: Sequence[TensorUsageRecord]) -> AllocationPlan:
        for c in self.chunks:
            c.reset()
        assignments: Dict[str, Tuple[int, int]] = {}
        for t in sorted(records, key=lambda r: r.size, reverse=True):
            placed = False
            for chunk in self.chunks:
                offset = find_gap_from_chunk(t, chunk)
                if offset != INVALID:
                    chunk.insert(t, offset)
                    assignments[t.tensor_id] = (chunk.chunk_id, offset)
                    placed = True
                    break
            if not placed:
                size = max(self.default_chunk_size,
                           int(t.size * self.k_scale))
                chunk = self._new_chunk(size)
                chunk.insert(t, 0)
                assignments[t.tensor_id] = (chunk.chunk_id, 0)
        self._release_unused()
        return AllocationPlan(assignments, list(self.chunks))

    def _new_chunk(self, size: int) -> Chunk:
        chunk = Chunk(self._next_chunk_id, size)
        self._next_chunk_id += 1
        self.chunks.append(chunk)
        self.allocated_bytes += size
        self.alloc_events += 1
        return chunk

    def _release_unused(self) -> None:
        """Release chunks unused this inference (optionally after an idle
        grace period — the paper's 'maximum inference idle times')."""
        keep: List[Chunk] = []
        for c in self.chunks:
            if c.used_this_plan():
                self._idle_counts[c.chunk_id] = 0
                keep.append(c)
                continue
            idles = self._idle_counts.get(c.chunk_id, 0) + 1
            if idles > self.max_idle_inferences:
                self.freed_bytes += c.size
                self.free_events += 1
                self._idle_counts.pop(c.chunk_id, None)
            else:
                self._idle_counts[c.chunk_id] = idles
                keep.append(c)
        self.chunks = keep

    @property
    def footprint(self) -> int:
        return sum(c.size for c in self.chunks)


def validate_plan(records: Sequence[TensorUsageRecord],
                  plan: AllocationPlan) -> None:
    """Raise if any two lifetime-overlapping tensors overlap in memory or
    any tensor exceeds its chunk bounds. Used by property tests."""
    by_chunk: Dict[int, List[TensorUsageRecord]] = {}
    offsets = plan.assignments
    chunk_sizes = {c.chunk_id: c.size for c in plan.chunks}
    for r in records:
        cid, off = offsets[r.tensor_id]
        if off < 0 or off + r.size > chunk_sizes[cid]:
            raise AssertionError(
                f"{r.tensor_id} [{off}, {off + r.size}) exceeds chunk {cid} "
                f"of size {chunk_sizes[cid]}")
        by_chunk.setdefault(cid, []).append(r)
    for cid, rs in by_chunk.items():
        for i, a in enumerate(rs):
            oa = offsets[a.tensor_id][1]
            for b in rs[i + 1:]:
                ob = offsets[b.tensor_id][1]
                if a.overlaps(b):
                    if not (oa + a.size <= ob or ob + b.size <= oa):
                        raise AssertionError(
                            f"overlap in chunk {cid}: {a.tensor_id}@{oa} "
                            f"({a.size}B) vs {b.tensor_id}@{ob} ({b.size}B)")
