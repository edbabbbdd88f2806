"""Prefix-affinity request routing for the replica pool.

The router answers one question per submitted prompt: *which replica
should serve it?*  Policy (mirrors the cluster tier the LLM-serving
survey frames above iteration-level batching):

1. **Prefix affinity first.**  A block-granular index maps prompt-prefix
   chunks to the replica whose `RadixPrefixCache` holds their KV.  The
   index is fed two ways: every routed prompt is recorded at route time
   (:meth:`record` — identical in simulator and wall-clock modes, so
   routing decisions are parity-testable), and real engines additionally
   donate the prefixes their cache actually retained
   (`RadixPrefixCache.on_insert` -> :meth:`donate`).  A prompt whose
   longest indexed prefix lives on a healthy replica lands there — its
   prefill reuses the cached blocks instead of recomputing them.
2. **Skew guard.**  Affinity never overrides balance unboundedly: when
   the affinity replica already carries ``skew`` more live sessions than
   the least-loaded sibling, the prompt falls through to least-loaded
   placement (a hot prefix must not melt one replica).
3. **Least-loaded fallback**, scored on the same admission signals the
   pipeline itself computes: live-session depth first, then free decode
   slots, then free KV tokens, then replica index.  ``None`` capacities
   (unbounded) rank as infinitely free, so a simulator replica and a
   real engine replica sort consistently — the sim-vs-real routing
   parity tests depend on this.

``policy="least_loaded"`` disables affinity entirely and
``policy="random"`` routes uniformly at random (seeded) — the A/B
baselines the bench compares affinity hit rates against.  All methods
are internally locked: prefix-cache donation hooks fire from replica
pump threads while the pool routes under its own lock.
"""
from __future__ import annotations

import random
import threading
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Set, Tuple

__all__ = ["PrefixAffinityRouter", "ReplicaLoad", "RouteDecision"]

#: rank for an unbounded (None) capacity: sorts as "infinitely free"
_UNBOUNDED = 1 << 30


@dataclass(frozen=True)
class ReplicaLoad:
    """One replica's admission signals at route time (the pool samples
    these from each replica's pipeline + backend under its lock)."""
    depth: int                        # queued + chunking + decoding
    free_slots: Optional[int] = None  # backend.free_slots()
    free_kv: Optional[int] = None     # backend.free_kv_tokens()

    def sort_key(self, idx: int) -> Tuple[int, int, int, int]:
        fs = _UNBOUNDED if self.free_slots is None else self.free_slots
        fk = _UNBOUNDED if self.free_kv is None else self.free_kv
        return (self.depth, -fs, -fk, idx)


@dataclass(frozen=True)
class RouteDecision:
    """Outcome of routing one prompt: the chosen replica, why it was
    chosen (``affinity`` / ``least_loaded`` / ``random`` / ``failover``),
    and how many indexed prefix blocks the chosen replica already holds
    for this prompt (0 = no locality — the affinity-hit telemetry)."""
    replica: int
    reason: str
    matched_blocks: int = 0


class PrefixAffinityRouter:
    """Block-granular prompt-prefix -> replica index with least-loaded
    fallback.  Pure host-side policy; owns no sessions and no KV."""

    POLICIES = ("affinity", "least_loaded", "random")

    def __init__(self, num_replicas: int, block_size: int = 16, *,
                 policy: str = "affinity", skew: int = 4,
                 seed: int = 0) -> None:
        if policy not in self.POLICIES:
            raise ValueError(f"policy must be one of {self.POLICIES}, "
                             f"got {policy!r}")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_replicas = num_replicas
        self.block_size = block_size
        self.policy = policy
        self.skew = skew
        self._rng = random.Random(seed)
        # cumulative block-aligned prefix -> owning replica (last writer
        # wins: the most recent replica to serve/donate a prefix is the
        # one whose cache is warm).  Token tuples, not hashes — a lookup
        # can never alias two different prompts.
        self._index: Dict[Tuple[int, ...], int] = {}
        self._lock = threading.Lock()

    # -- index maintenance ------------------------------------------------
    def _keys(self, tokens: Sequence[int],
              cap_last: bool) -> List[Tuple[int, ...]]:
        """Cumulative block-aligned prefixes of ``tokens``.  With
        ``cap_last`` the walk stops at ``len(tokens) - 1`` — the
        matcher's cap (at least one suffix token must remain to
        prefill), so the index never promises a hit the replica's cache
        cannot serve."""
        usable = len(tokens) - 1 if cap_last else len(tokens)
        bs = self.block_size
        return [tuple(tokens[:k]) for k in range(bs, usable + 1, bs)]

    def record(self, prompt: Sequence[int], replica: int) -> None:
        """Route-time feed: ``prompt`` was just placed on ``replica``,
        so its prefix blocks are about to be cached there."""
        with self._lock:
            for key in self._keys(list(prompt), cap_last=True):
                self._index[key] = replica

    def donate(self, tokens: Sequence[int], replica: int) -> None:
        """Cache-side feed (`RadixPrefixCache.on_insert`): ``replica``'s
        cache really holds KV for these tokens now.  Authoritative over
        route-time guesses — runs last-writer-wins into the same index."""
        with self._lock:
            for key in self._keys(list(tokens), cap_last=False):
                self._index[key] = replica

    def purge(self, replica: int) -> int:
        """Drop every index entry owned by ``replica`` (it died — its
        cache is gone).  Returns how many entries went."""
        with self._lock:
            victims = [k for k, v in self._index.items() if v == replica]
            for k in victims:
                del self._index[k]
            return len(victims)

    def lookup(self, prompt: Sequence[int],
               healthy: Set[int]) -> Tuple[Optional[int], int]:
        """Longest indexed prefix of ``prompt`` owned by a healthy
        replica -> (owner, matched blocks); (None, 0) on a cold miss."""
        owner: Optional[int] = None
        blocks = 0
        with self._lock:
            for i, key in enumerate(self._keys(list(prompt),
                                               cap_last=True), start=1):
                rep = self._index.get(key)
                if rep is None:
                    break
                if rep in healthy:
                    owner, blocks = rep, i
        return owner, blocks

    @property
    def index_size(self) -> int:
        with self._lock:
            return len(self._index)

    # -- routing ----------------------------------------------------------
    def route(self, prompt: Sequence[int],
              loads: Dict[int, ReplicaLoad],
              healthy: Sequence[int]) -> RouteDecision:
        """Pick a replica for ``prompt`` among ``healthy`` candidates.
        ``loads`` must cover every healthy replica."""
        cands = list(healthy)
        if not cands:
            raise RuntimeError("no healthy replicas to route to")
        owner, blocks = self.lookup(prompt, set(cands))
        fallback = min(cands, key=lambda i: loads[i].sort_key(i))
        if self.policy == "random":
            pick = self._rng.choice(cands)
            return RouteDecision(pick, "random",
                                 blocks if pick == owner else 0)
        if self.policy == "affinity" and owner is not None:
            if loads[owner].depth <= loads[fallback].depth + self.skew:
                return RouteDecision(owner, "affinity", blocks)
        return RouteDecision(fallback, "least_loaded",
                             blocks if fallback == owner else 0)
