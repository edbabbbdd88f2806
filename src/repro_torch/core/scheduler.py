"""TurboTransformers Algorithm 2: the sequence-length-aware DP batch
scheduler (copied from the JAX package; the port plans with DP only).

Given pending requests of variable length and a ``cached_cost`` model, the
scheduler sorts requests by length and solves

  state[i] = min_j ( cached_cost[len_i][i-j+1] * (i-j+1) + state[j-1] )

(the paper's Eq. 2, O(n^2)) to find the partition into contiguous batches
(in sorted order) minimizing total execution time — i.e. maximizing
response throughput. Because requests are sorted, every batch pads only up
to its own maximum, balancing zero-padding waste against batching gains.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import CostModel


@dataclass(frozen=True)
class BatchPlan:
    """Indices into the *original* request list, one tuple per batch."""
    batches: Tuple[Tuple[int, ...], ...]
    total_cost: float


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
        # directly — the same quantity.
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
