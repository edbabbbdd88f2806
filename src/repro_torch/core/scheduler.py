"""TurboTransformers Algorithm 2: the sequence-length-aware DP batch
scheduler, plus the baselines it is compared against (no-batch, naive),
copied from the JAX package.

Given pending requests of variable length and a ``cached_cost`` model, the
scheduler sorts requests by length and solves

  state[i] = min_j ( cached_cost[len_i][i-j+1] * (i-j+1) + state[j-1] )

(the paper's Eq. 2, O(n^2)) to find the partition into contiguous batches
(in sorted order) minimizing total execution time — i.e. maximizing
response throughput. Because requests are sorted, every batch pads only up
to its own maximum, balancing zero-padding waste against batching gains.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import CostModel


@dataclass(frozen=True)
class BatchPlan:
    """Indices into the *original* request list, one tuple per batch."""
    batches: Tuple[Tuple[int, ...], ...]
    total_cost: float

    @property
    def num_batches(self) -> int:
        return len(self.batches)


def _plan_cost(lengths: Sequence[int], batches: Sequence[Sequence[int]],
               cost: CostModel) -> float:
    """Single metric shared by ALL policies (and the DP recurrence): the
    summed full-batch latency.  Every ``BatchPlan.total_cost`` is therefore
    directly comparable across nobatch / naive / dp in benchmarks."""
    total = 0.0
    for batch in batches:
        max_len = max(lengths[i] for i in batch)
        total += cost.latency(max_len, len(batch))
    return total


def dp_schedule(lengths: Sequence[int], cost: CostModel,
                max_batch_size: Optional[int] = None) -> BatchPlan:
    """Paper Algorithm 2 (with optional max-batch-size constraint)."""
    n = len(lengths)
    if n == 0:
        return BatchPlan((), 0.0)
    order = sorted(range(n), key=lambda i: lengths[i])
    slen = [lengths[i] for i in order]
    max_b = max_batch_size or n

    INF = float("inf")
    states = [0.0] * (n + 1)
    start_idx = [0] * (n + 1)
    for i in range(1, n + 1):
        cur_len = slen[i - 1]
        best = INF
        best_j = i - 1
        # batch = sorted requests [j .. i-1], size i-j, padded to cur_len.
        # The paper writes the term as cached_cost[len][bs] * bs (per-
        # request cost times size); we charge cost.latency(len, bs)
        # directly — the same quantity, and the same metric _plan_cost
        # charges the baselines — so total_cost is policy-comparable.
        for j in range(i - 1, max(i - 1 - max_b, -1), -1):
            bs = i - j
            c = states[j] + cost.latency(cur_len, bs)
            if c < best:
                best = c
                best_j = j
        states[i] = best
        start_idx[i] = best_j

    batches: List[Tuple[int, ...]] = []
    i = n
    while i > 0:
        j = start_idx[i]
        batches.append(tuple(order[j:i]))
        i = j
    batches.reverse()
    return BatchPlan(tuple(batches), states[n])


def nobatch_schedule(lengths: Sequence[int], cost: CostModel) -> BatchPlan:
    batches = tuple((i,) for i in range(len(lengths)))
    return BatchPlan(batches, _plan_cost(lengths, batches, cost))


def naive_schedule(lengths: Sequence[int], cost: CostModel,
                   max_batch_size: Optional[int] = None) -> BatchPlan:
    """Pack everything currently queued into one batch (TF-serving style);
    with a size cap, consecutive arrival-order groups of ``max_batch``."""
    n = len(lengths)
    if n == 0:
        return BatchPlan((), 0.0)
    cap = max_batch_size or n
    batches = tuple(tuple(range(s, min(s + cap, n)))
                    for s in range(0, n, cap))
    return BatchPlan(batches, _plan_cost(lengths, batches, cost))


def brute_force_schedule(lengths: Sequence[int], cost: CostModel
                         ) -> BatchPlan:
    """Exhaustive optimum over contiguous partitions of the sorted order
    (oracle for tests; exponential, n <= ~12)."""
    n = len(lengths)
    if n == 0:
        return BatchPlan((), 0.0)
    order = sorted(range(n), key=lambda i: lengths[i])
    best: Optional[Tuple[float, List[Tuple[int, ...]]]] = None
    # each of the n-1 gaps is either a batch boundary or not
    for cuts in itertools.product([0, 1], repeat=n - 1):
        batches = []
        start = 0
        for pos, cut in enumerate(cuts, start=1):
            if cut:
                batches.append(tuple(order[start:pos]))
                start = pos
        batches.append(tuple(order[start:n]))
        c = _plan_cost(lengths, batches, cost)
        if best is None or c < best[0]:
            best = (c, batches)
    return BatchPlan(tuple(best[1]), best[0])
