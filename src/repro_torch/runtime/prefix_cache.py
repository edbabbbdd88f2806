"""Refcounted prefix-sharing prompt cache over the paged block pool.

Serving traffic is dominated by requests that open with the same tokens —
system prompts, few-shot preambles, chat history replays.  Under the paged
KV layout (`repro_torch.runtime.kv_cache.BlockTableManager`) two sequences can
already point their block tables at the SAME physical block; this module
adds the policy layer that finds those opportunities and keeps them safe:

- :class:`RadixPrefixCache` — a radix trie keyed on block-granular token
  chunks.  Each node owns one physical block of prompt KV; a path from the
  root spells out a prompt prefix.  Matching an incoming prompt walks the
  trie and returns the physical blocks a new request can map instead of
  re-prefilling (`match`), and finished prompts donate their blocks to the
  trie (`insert`).
- **Refcounts** (held in the block manager) arbitrate ownership: a cached
  block is alive while any request table or trie node maps it; the trie's
  own hold keeps a block warm after its last request finishes.
- **Copy-on-write**: only *full* immutable chunks are shared in place.  A
  request whose match ends inside a block (a partially-filled cached tail,
  or a divergence mid-chunk) gets a private copy of that block before any
  write; likewise a live sequence whose first decode token would land in a
  block the trie also holds copies it first (the engine drives both via
  ``BlockTableManager.copy_on_write``).
- **LRU eviction**: under pool pressure (`evict`), trie leaves whose block
  has no holder besides the trie are dropped oldest-``last_used`` first;
  `evictable_blocks` is the admission planner's view of that reclaimable
  capacity, counted exactly (`reclaimable_blocks`).

The cache hierarchy this completes: slab (contiguous per-request regions)
-> paged (one pool of refcounted blocks) -> shared prefix (this module:
cross-request block sharing with COW + LRU).

The trie stores token tuples, not hashes of them, so a lookup can never
alias two different prompts (the dict hashing underneath IS the
block-granular prompt hash, with collisions resolved by key equality).
Device-side data movement (gathering matched prefix KV, COW block copies)
is the engine's job; this class is pure host-side policy, symmetric with
the block manager it sits on.

Copied from the JAX package.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from repro_torch.runtime.kv_cache import BlockTableManager


@dataclass
class PrefixMatch:
    """Outcome of matching one prompt against the trie.

    ``full_blocks`` may be mapped by the new request as-is (immutable,
    fully-valid chunks).  ``tail_block`` is a block whose first
    ``tail_tokens`` KV entries are valid for this prompt but which the
    request will write into (its suffix continues mid-block) — the engine
    must copy it before use.  The matcher already took one hold per
    returned block; ``consumed`` flips when those holds are transferred to
    a request table (or released on an aborted admission).
    """
    full_blocks: List[int] = field(default_factory=list)
    full_tokens: int = 0
    tail_block: Optional[int] = None
    tail_tokens: int = 0
    consumed: bool = False

    @property
    def cached_tokens(self) -> int:
        return self.full_tokens + self.tail_tokens


class _Node:
    """One cached block: ``chunk`` is the (<= block_size)-token slice of
    prompt this block's KV covers; children extend the prefix."""
    __slots__ = ("chunk", "block", "parent", "children", "last_used")

    def __init__(self, chunk: Tuple[int, ...], block: int,
                 parent: Optional["_Node"]) -> None:
        self.chunk = chunk
        self.block = block
        self.parent = parent
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.last_used = 0


def _common_prefix(a: Sequence[int], b: Sequence[int]) -> int:
    n = 0
    for x, y in zip(a, b):
        if x != y:
            break
        n += 1
    return n


class RadixPrefixCache:
    """Block-granular prompt-prefix trie over a :class:`BlockTableManager`.

    Pure host-side accounting: decides which physical blocks a prompt may
    share and which cached blocks may be reclaimed; the engine moves the
    actual KV.  All holds it takes/gives go through the block manager's
    refcounts, so the pool's conservation invariant covers cached blocks
    too.
    """

    def __init__(self, block_table: BlockTableManager) -> None:
        self.btm = block_table
        self.block_size = block_table.block_size
        self._root = _Node((), 0, None)
        self._clock = 0
        # telemetry (the bench's prefix-cache section reads these)
        self.hits = 0
        self.misses = 0
        self.reused_tokens = 0
        self.inserted_blocks = 0
        self.evicted_blocks = 0
        # cluster-tier donation hook: called as on_insert(tokens, new)
        # after every insert that took fresh blocks, so a ReplicaPool's
        # routing index learns which replica really caches which prefix
        self.on_insert: Optional[Callable[[List[int], List[int]], None]] \
            = None

    # -- internals -------------------------------------------------------
    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def _chunks(self, tokens: Sequence[int]) -> List[Tuple[int, ...]]:
        bs = self.block_size
        return [tuple(tokens[i:i + bs]) for i in range(0, len(tokens), bs)]

    def _nodes(self) -> List[_Node]:
        out: List[_Node] = []
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            out.append(n)
            stack.extend(n.children.values())
        return out

    # -- queries ---------------------------------------------------------
    @property
    def cached_blocks(self) -> int:
        return len(self._nodes())

    def reclaimable_blocks(self) -> Set[int]:
        """Blocks :meth:`evict` can return to the free list: held by
        nobody but the trie, with nothing held below them.  A ref-1 node
        CAN sit above a node a live request maps (that request's own
        copy of the ref-1 chunk stayed private when it donated its
        prompt), and leaf-first eviction never reaches such a node."""
        out: Set[int] = set()

        def walk(node: _Node) -> bool:
            free = True
            for child in node.children.values():
                free = walk(child) and free
            if free and self.btm.ref_count(node.block) == 1:
                out.add(node.block)
                return True
            return False

        for child in self._root.children.values():
            walk(child)
        return out

    def evictable_blocks(self) -> int:
        """Cached blocks eviction can reclaim — capacity the admission
        planner may count as free (see :meth:`reclaimable_blocks`; the
        JAX package counts every ref-1 node, which overstates it when a
        ref-1 node has a held descendant)."""
        return len(self.reclaimable_blocks())

    def metrics(self) -> dict:
        """:meth:`stats` plus the evictable-block level — the gauge set
        the observability registry samples at tick boundaries (see
        `repro_torch.obs`).  Host ints only."""
        out = dict(self.stats())
        out["evictable_blocks"] = self.evictable_blocks()
        return out

    # -- matching --------------------------------------------------------
    def match(self, tokens: Sequence[int], *,
              take_refs: bool = True) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``len(tokens) -
        1`` so at least one suffix token remains to prefill (the engine
        needs the last prompt position's logits to seed decoding).

        Walks full-chunk trie edges, then tries one partial step: the
        child sharing the longest token prefix of the remaining prompt
        (a partially-filled cached tail, or a divergence inside a full
        block) becomes ``tail_block`` — valid KV for ``tail_tokens``
        positions, copy-before-write.

        ``take_refs=False`` is a side-effect-free peek for admission
        accounting (`kv_demand`): no holds taken, no LRU touch, no
        hit/miss telemetry.
        """
        tokens = list(tokens)
        usable = len(tokens) - 1
        bs = self.block_size
        node = self._root
        full_blocks: List[int] = []
        matched = 0
        now = self._tick() if take_refs else None
        while usable - matched >= bs:
            child = node.children.get(tuple(tokens[matched:matched + bs]))
            if child is None:
                break
            full_blocks.append(child.block)
            matched += bs
            node = child
            if take_refs:
                child.last_used = now
        tail_block: Optional[int] = None
        tail_tokens = 0
        budget = usable - matched
        if budget > 0:
            best: Optional[_Node] = None
            for child in node.children.values():
                t = min(_common_prefix(child.chunk,
                                       tokens[matched:matched + bs]),
                        budget)
                if t > tail_tokens:
                    tail_tokens, best = t, child
            if best is not None:
                tail_block = best.block
                if take_refs:
                    best.last_used = now
        if take_refs:
            for b in full_blocks:
                self.btm.ref(b)
            if tail_block is not None:
                self.btm.ref(tail_block)
            if matched or tail_tokens:
                self.hits += 1
                self.reused_tokens += matched + tail_tokens
            else:
                self.misses += 1
        return PrefixMatch(full_blocks, matched, tail_block, tail_tokens)

    def release(self, m: PrefixMatch) -> None:
        """Give back the holds ``match`` took, for an admission that died
        before transferring them to a request table."""
        if m.consumed:
            return
        m.consumed = True
        for b in m.full_blocks:
            self.btm.unref(b)
        if m.tail_block is not None:
            self.btm.unref(m.tail_block)

    # -- insertion -------------------------------------------------------
    def insert(self, tokens: Sequence[int],
               block_ids: Sequence[int]) -> List[int]:
        """Donate a freshly prefilled prompt to the trie: one node per
        block-granular chunk of ``tokens``, backed by the request's own
        ``block_ids``.  Chunks already cached are just LRU-touched (the
        request's duplicate block stays private to it).  Each newly cached
        block gains a trie hold (ref), so it outlives the request.  A
        partial final chunk is cached too — the owner's next decode write
        into it must then copy first (the engine checks refcounts before
        every write).  Returns the block ids newly taken into the trie."""
        node = self._root
        now = self._tick()
        new: List[int] = []
        bs = self.block_size
        for chunk, bid in zip(self._chunks(tokens), block_ids):
            child = node.children.get(chunk)
            if child is None:
                if len(chunk) < bs and any(
                        c[:len(chunk)] == chunk for c in node.children):
                    break   # a cached full block already covers this tail
                child = _Node(chunk, bid, node)
                node.children[chunk] = child
                self.btm.ref(bid)
                self.inserted_blocks += 1
                new.append(bid)
            child.last_used = now
            node = child
        if new and self.on_insert is not None:
            self.on_insert(list(tokens), list(new))
        return new

    # -- eviction --------------------------------------------------------
    def evict(self, n_blocks: int) -> int:
        """Reclaim up to ``n_blocks`` cached blocks under pool pressure:
        repeatedly drop the least-recently-used *leaf* whose block has no
        holder besides the trie (never a block a live request maps).
        Evicting a leaf may expose its parent for the next round.
        Returns how many blocks actually went back to the free list.

        One tree traversal collects the candidates (ref-1 nodes — their
        refcounts cannot change while eviction runs, the engine is
        single-threaded); each round then scans only that list for the
        LRU current-leaf, so reclaiming N of M cached blocks is
        O(M + N·M_evictable), not a full re-traversal per block."""
        freed = 0
        cand = [n for n in self._nodes()
                if self.btm.ref_count(n.block) == 1]
        cand.sort(key=lambda n: n.last_used)
        while freed < n_blocks:
            victim: Optional[_Node] = None
            for n in cand:
                if not n.children:
                    victim = n
                    break
            if victim is None:
                break
            cand.remove(victim)
            self.btm.unref(victim.block)
            del victim.parent.children[victim.chunk]
            self.evicted_blocks += 1
            freed += 1
        return freed

    def stats(self) -> Dict[str, int]:
        return {
            "hits": self.hits,
            "misses": self.misses,
            "reused_tokens": self.reused_tokens,
            "inserted_blocks": self.inserted_blocks,
            "evicted_blocks": self.evicted_blocks,
            "cached_blocks": self.cached_blocks,
        }
