"""Cost models backing the DP batch scheduler's ``cached_cost`` table.

Semantics follow the paper's Eq. 2: ``cached_cost[len][batch]`` is the
*per-request* cost of running one inference at (len, batch); the latency of
a batch of size b is ``cached_cost[len][b] * b``.

The port keeps :class:`AnalyticCostModel`, a roofline model (compute
and memory terms plus a fixed launch overhead).  The admission planner
only needs relative costs to order and veto batches.
"""
from __future__ import annotations

from dataclasses import dataclass

# NVIDIA H100 SXM data-sheet peaks (dense bf16 tensor cores, HBM3)
PEAK_FLOPS_BF16 = 989e12
HBM_BW = 3.35e12


# -- paged-KV admission accounting ------------------------------------------
# Under a paged (block-table) cache the unit of KV capacity is a fixed-size
# token block, so admission control must veto a prefill whose *block*
# demand cannot be met even when the raw token count looks affordable.
# These helpers are the single source of truth for that rounding — the
# pipeline and the engine charge the same number.

def blocks_for_tokens(tokens: int, block_size: int) -> int:
    """Blocks needed to hold ``tokens`` KV entries (ceil division)."""
    if block_size <= 0:
        raise ValueError(f"block_size must be positive, got {block_size}")
    return -(-max(int(tokens), 0) // block_size)


def block_round(tokens: int, block_size: int) -> int:
    """``tokens`` rounded up to a whole number of blocks (in tokens)."""
    return blocks_for_tokens(tokens, block_size) * block_size


class CostModel:
    def latency(self, seq_len: int, batch: int) -> float:
        raise NotImplementedError

    # -- two-phase regime (iteration-level scheduling) -------------------
    # Continuous batching plans *ticks*, not whole requests: a tick is
    # either a prompt pass over newly admitted requests (prefill) or one
    # token for every in-flight sequence (decode).  The planner compares
    # the two so it can decide whether admitting prefills is worth
    # stalling the decode batch.

    def prefill_latency(self, seq_len: int, batch: int) -> float:
        """Prompt pass over ``batch`` requests padded to ``seq_len``."""
        return self.latency(seq_len, batch)

    def decode_latency(self, batch: int, context_len: int = 0) -> float:
        """One decode tick: a single new token for each of ``batch``
        sequences whose KV context averages ``context_len`` tokens.
        Default approximation: a length-1 forward pass (weight-bound);
        models that see KV traffic should override."""
        return self.latency(1, batch)


@dataclass
class AnalyticCostModel(CostModel):
    """Roofline latency for one inference step over a padded batch."""
    flops_per_token: float            # ~2 * active params (fwd)
    bytes_per_token: float            # activation traffic per token
    weight_bytes: float               # parameter bytes read per pass
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    overhead: float = 50e-6           # dispatch/launch overhead (s)
    chips: int = 1

    def latency(self, seq_len: int, batch: int) -> float:
        tokens = seq_len * batch
        compute = self.flops_per_token * tokens / \
            (self.peak_flops * self.chips)
        memory = (self.weight_bytes + self.bytes_per_token * tokens) / \
            (self.hbm_bw * self.chips)
        return max(compute, memory) + self.overhead

    def decode_latency(self, batch: int, context_len: int = 0) -> float:
        """Decode ticks are memory-bound: one token of compute per
        sequence plus the whole weight read plus streaming each
        sequence's KV context back in."""
        compute = self.flops_per_token * batch / \
            (self.peak_flops * self.chips)
        kv_read = self.bytes_per_token * context_len * batch
        memory = (self.weight_bytes + self.bytes_per_token * batch +
                  kv_read) / (self.hbm_bw * self.chips)
        return max(compute, memory) + self.overhead
