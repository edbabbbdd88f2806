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
- **aliasing** — a write to a block with other holders;
- **leaks at drain** — tables outliving their session, or used blocks
  at drain.

Copied from the JAX package, without the prefix-cache and cluster hooks.

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
from typing import Dict, Iterable, List, Optional, Set

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
        if block_id == 0:
            out.append("<trash sentinel>")
        extra = self._shadow[block_id] - len(out)
        if extra > 0:
            out.append(f"{extra} anonymous holder(s)")
        return out or ["nobody"]

    def _describe(self, block_id: int) -> str:
        return (f"block {block_id} (refs {self._shadow[block_id]}, "
                f"held by {', '.join(self.owners_of(block_id))})")

    # -- refcount interception -------------------------------------------
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

    def allocate(self, req_id: int, tokens: int) -> List[int]:
        blocks = super().allocate(req_id, tokens)
        self._freed_tables.discard(req_id)
        return blocks

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
                    f"aliasing violation: session {req_id} writes "
                    f"shared {self._describe(b)}")

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

    def check_idle(self, live_requests: Iterable[int] = ()) -> None:
        """Leak check at drain: with no live sessions, no block may be
        in use."""
        live = set(live_requests)
        for rid, tbl in self._tables.items():
            if rid not in live:
                raise SanitizerError(
                    f"leaked block table: session {rid} still holds "
                    f"blocks {tbl} after drain")
        if not self._tables and self.used_blocks:
            raise SanitizerError(
                f"{self.used_blocks} block(s) leaked at drain")
