"""Shadow-state sanitizer for the paged-KV block pool.

The paged pool (`runtime/kv_cache.py::BlockTableManager`) is pure host-side
accounting, which makes its failure modes silent: a double-freed block gets
handed to two sequences, a write to a shared block corrupts a cached prefix,
a leaked block shrinks the pool until admission starves.  This module wraps
the manager with *shadow* ownership/refcount tracking that turns each of
those into a loud `SanitizerError` naming the block and the owning session:

- **double free** — `unref`/`free` of a block/table nobody holds;
- **free-while-referenced** — a table mapping a block whose refcount
  already hit zero (refcount corruption);
- **write-to-unowned-block** — an engine KV scatter routed to a block
  outside the writer's table, or to trash block 0;
- **COW aliasing** — a write to a block with other holders (the writer
  should have gone through `copy_on_write` first);
- **leaks at drain** — `take()`n blocks never adopted into a table, tables
  outliving their session, or pool usage the prefix cache can't account for.

Copied from the JAX package.

Enablement (`enabled()`): `TURBO_SANITIZE=1` forces it on, `TURBO_SANITIZE=0`
forces it off, unset means *on under pytest, off otherwise* — production
ticks pay zero overhead unless explicitly opted in.  The engine builds its
manager through `make_block_manager`, so the whole machinery is one
`isinstance` check away from being inert.

`ServingPipeline` adds the tick-boundary half: block conservation,
slot<->session bijection, reservation balance, and monotonic `streamed`
high-water marks (see `core/pipeline.py::ServingPipeline._check_invariants`
and `ContinuousEngine.check_invariants`).
"""
from __future__ import annotations

import os
import sys
from typing import Dict, Iterable, List, Optional, Sequence, Set

from repro_torch.runtime.kv_cache import BlockTableManager


class SanitizerError(RuntimeError):
    """A paged-KV ownership/refcount invariant was violated."""


def enabled() -> bool:
    """Resolve the sanitizer switch from the environment.

    `TURBO_SANITIZE=1` (or any truthy value) turns it on, `TURBO_SANITIZE=0`
    (also ``""``/``false``/``off``) turns it off, and when the variable is
    unset the sanitizer defaults to on iff running under pytest.
    """
    raw = os.environ.get("TURBO_SANITIZE")
    if raw is not None:
        return raw.strip().lower() not in ("", "0", "false", "off", "no")
    return "pytest" in sys.modules


def make_block_manager(num_blocks: int, block_size: int,
                       sanitize: Optional[bool] = None) -> BlockTableManager:
    """Build the block manager the engine should use: the sanitized
    subclass when the sanitizer is enabled (or ``sanitize`` forces it),
    the plain manager otherwise."""
    on = enabled() if sanitize is None else sanitize
    cls = SanitizedBlockTableManager if on else BlockTableManager
    return cls(num_blocks, block_size)


def check_write(btm: BlockTableManager, req_id: int,
                blocks: Iterable[int]) -> None:
    """Engine-side write hook: validate that ``req_id`` may scatter KV into
    ``blocks``.  A no-op on an unsanitized manager."""
    if isinstance(btm, SanitizedBlockTableManager):
        btm.check_write(req_id, blocks)


def check_pool_ownership(sessions_by_replica: Dict[int, Sequence[int]],
                         healthy: Iterable[int]) -> Dict[int, int]:
    """Cluster-tier invariant: every live session is owned by exactly one
    healthy replica.

    ``sessions_by_replica`` maps replica index -> the req_ids live on
    that replica (queued + chunking + decoding, finished excluded);
    ``healthy`` is the set of replicas the pool's health board still
    trusts.  Raises `SanitizerError` when a req_id appears under two
    replicas at once (a failover double-submitted it) or when a replica
    marked dead still owns live sessions (its work was never
    redistributed).  Returns the req_id -> replica owner map."""
    healthy_set = set(healthy)
    owner: Dict[int, int] = {}
    for idx, req_ids in sorted(sessions_by_replica.items()):
        if req_ids and idx not in healthy_set:
            raise SanitizerError(
                f"unhealthy replica {idx} still owns live sessions "
                f"{sorted(req_ids)}: failover must re-enqueue or fail "
                "them before the replica is abandoned")
        for rid in req_ids:
            if rid in owner:
                raise SanitizerError(
                    f"session {rid} is owned by replica {owner[rid]} "
                    f"and replica {idx} at once: routing/failover "
                    "double-submitted it")
            owner[rid] = idx
    return owner


class SanitizedBlockTableManager(BlockTableManager):
    """`BlockTableManager` with shadow ownership tracking.

    Behaviour is bit-identical to the base class on legal traces; illegal
    traces raise `SanitizerError` *before* the base state can be corrupted,
    with a report naming the block and its owning session(s).
    """

    def __init__(self, num_blocks: int, block_size: int = 16) -> None:
        super().__init__(num_blocks, block_size)
        # Shadow refcounts, maintained independently of self._refs; any
        # divergence between the two is itself reported as corruption.
        self._shadow: List[int] = [0] * num_blocks
        self._shadow[0] = 1
        # Blocks handed out by take() and not yet adopted by allocate().
        self._pending: Set[int] = set()
        # Last holder that returned each block to the free list.
        self._last_release: Dict[int, str] = {}
        # Request ids whose table existed and was freed (double-free bait);
        # free() of a *never-allocated* id stays a legal no-op.
        self._freed_tables: Set[int] = set()

    # -- reporting -------------------------------------------------------
    def owners_of(self, block_id: int) -> List[str]:
        """Human-readable holder list for a block, for error reports."""
        out = [f"session {rid}" for rid, tbl in self._tables.items()
               if block_id in tbl]
        if block_id in self._pending:
            out.append("take() pending adoption")
        if block_id == 0:
            out.append("<trash sentinel>")
        extra = self._shadow[block_id] - len(out)
        if extra > 0:
            out.append(f"{extra} anonymous holder(s) (prefix-cache trie)")
        return out or ["nobody"]

    def _describe(self, block_id: int) -> str:
        return (f"block {block_id} (refs {self._shadow[block_id]}, "
                f"held by {', '.join(self.owners_of(block_id))})")

    # -- refcount interception -------------------------------------------
    def ref(self, block_id: int) -> None:
        if block_id == 0:
            raise SanitizerError("ref of trash block 0: the sentinel can "
                                 "never gain holders")
        if not (0 < block_id < self.num_blocks) or \
                self._shadow[block_id] <= 0:
            last = self._last_release.get(block_id, "never held")
            raise SanitizerError(
                f"ref of free block {block_id}: only live blocks can gain "
                f"holders (last released by {last})")
        super().ref(block_id)
        self._shadow[block_id] += 1

    def unref(self, block_id: int, *, _holder: str = "caller") -> bool:
        if block_id == 0:
            raise SanitizerError("unref of trash block 0: the sentinel is "
                                 "permanently held by the manager")
        if not (0 < block_id < self.num_blocks) or \
                self._shadow[block_id] <= 0:
            last = self._last_release.get(block_id, "never held")
            raise SanitizerError(
                f"double free of block {block_id} by {_holder}: refcount "
                f"already zero (last released by {last})")
        freed = super().unref(block_id)
        self._shadow[block_id] -= 1
        if freed:
            self._last_release[block_id] = _holder
        return freed

    # -- allocation interception -----------------------------------------
    def _take(self, n: int) -> List[int]:
        out = super()._take(n)
        for b in out:
            if b == 0:
                raise SanitizerError("trash block 0 escaped to the free "
                                     "list and was handed out")
            if self._shadow[b] != 0:
                raise SanitizerError(
                    f"free list handed out {self._describe(b)} which is "
                    "still referenced (free-while-referenced corruption)")
            self._shadow[b] = 1
        return out

    def take(self, n: int) -> List[int]:
        out = super().take(n)
        self._pending.update(out)
        return out

    def allocate(self, req_id: int, tokens: int,
                 prefix_blocks: Sequence[int] = ()) -> List[int]:
        for b in prefix_blocks:
            if b == 0:
                raise SanitizerError(
                    f"session {req_id} adopts trash block 0 as a prefix "
                    "block")
            if self._shadow[b] <= 0:
                raise SanitizerError(
                    f"session {req_id} adopts free block {b}: prefix "
                    "blocks must already be held (last released by "
                    f"{self._last_release.get(b, 'never held')})")
        blocks = super().allocate(req_id, tokens, prefix_blocks)
        self._freed_tables.discard(req_id)
        self._pending.difference_update(blocks)
        return blocks

    def copy_on_write(self, req_id: int, logical_idx: int) -> int:
        table = self._tables[req_id]
        old = table[logical_idx]
        if self._shadow[old] <= 0:
            raise SanitizerError(
                f"session {req_id} copy-on-write of freed block {old} at "
                f"logical index {logical_idx}")
        new = self._take(1)[0]
        table[logical_idx] = new
        self.unref(old, _holder=f"session {req_id} (copy-on-write)")
        return new

    def free(self, req_id: int) -> None:
        blocks = self._tables.pop(req_id, None)
        if blocks is None:
            if req_id in self._freed_tables:
                raise SanitizerError(
                    f"double free of session {req_id}'s block table: it "
                    "was already released")
            return   # never-allocated id: legal error-path sweep no-op
        self._tokens.pop(req_id)
        for b in reversed(blocks):
            self.unref(b, _holder=f"session {req_id}")
        self._freed_tables.add(req_id)

    # -- engine hooks ----------------------------------------------------
    def check_write(self, req_id: int, blocks: Iterable[int]) -> None:
        """Validate a KV scatter by ``req_id`` into physical ``blocks``."""
        table = self._tables.get(req_id)
        if table is None:
            raise SanitizerError(
                f"session {req_id} writes KV with no block table")
        tset = set(table)
        for b in blocks:
            if b == 0:
                raise SanitizerError(
                    f"session {req_id} write routed to trash block 0 "
                    "unexpectedly")
            if b not in tset:
                raise SanitizerError(
                    f"session {req_id} write to unowned "
                    f"{self._describe(b)}")
            if self._shadow[b] > 1:
                raise SanitizerError(
                    f"COW aliasing violation: session {req_id} writes "
                    f"shared {self._describe(b)} without copy-on-write")

    def check_conservation(self) -> None:
        """Every block is either on the free list with refcount zero or
        referenced by at least one holder — and the shadow counts agree
        with the manager's own."""
        if len(self._free) != len(set(self._free)):
            dup = sorted(b for b in set(self._free)
                         if self._free.count(b) > 1)
            raise SanitizerError(f"free list holds duplicates: {dup}")
        for b in self._free:
            if self._refs[b] != 0 or self._shadow[b] != 0:
                raise SanitizerError(
                    f"free-while-referenced: {self._describe(b)} sits on "
                    "the free list")
        if self._refs != self._shadow:
            bad = [b for b in range(self.num_blocks)
                   if self._refs[b] != self._shadow[b]]
            raise SanitizerError(
                f"refcount corruption on blocks {bad}: manager counts "
                f"{[self._refs[b] for b in bad]} vs shadow "
                f"{[self._shadow[b] for b in bad]}")
        used = sum(1 for b in range(1, self.num_blocks)
                   if self._refs[b] > 0)
        if used + len(self._free) != self.num_blocks - 1:
            raise SanitizerError(
                f"block conservation broken: {used} used + "
                f"{len(self._free)} free != pool {self.num_blocks - 1}")
        for rid, tbl in self._tables.items():
            for b in tbl:
                if b != 0 and self._refs[b] <= 0:
                    raise SanitizerError(
                        f"session {rid} maps freed block {b}")

    def check_idle(self, live_requests: Iterable[int] = (),
                   cache_blocks: int = 0) -> None:
        """Leak check at drain: with no live sessions, every used block
        must be accounted for by the prefix cache."""
        live = set(live_requests)
        for rid, tbl in self._tables.items():
            if rid not in live:
                raise SanitizerError(
                    f"leaked block table: session {rid} still holds "
                    f"blocks {tbl} after drain")
        if self._pending:
            b = min(self._pending)
            raise SanitizerError(
                f"leaked block(s) {sorted(self._pending)}: taken via "
                f"take() but never adopted into a table or freed "
                f"(first: block {b}, held by "
                f"{', '.join(self.owners_of(b))})")
        if not self._tables and self.used_blocks != cache_blocks:
            raise SanitizerError(
                f"{self.used_blocks - cache_blocks} block(s) leaked at "
                f"drain: pool holds {self.used_blocks}, prefix cache "
                f"accounts for {cache_blocks}")
