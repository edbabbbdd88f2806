"""Cost models backing the DP batch scheduler's ``cached_cost`` table.

Semantics follow the paper's Eq. 2: ``cached_cost[len][batch]`` is the
*per-request* cost of running one inference at (len, batch); the latency of
a batch of size b is ``cached_cost[len][b] * b``.

Three implementations (copied from the JAX package):

- :class:`TableCostModel` — built by a warm-up phase that measures the real
  engine "under all possible batch sizes and sequence lengths" (§5), with
  bilinear interpolation in (len, batch) for unseen points and lazy
  refinement from live measurements;
- :class:`BucketedCostModel` — wraps another model with the engine's
  sequence buckets, so cost is a step function of length;
- :class:`AnalyticCostModel` — an H100 roofline model (compute and memory
  terms plus a fixed launch overhead), for when nothing has been measured:
  the admission planner only needs relative costs to order and veto
  batches.
"""
from __future__ import annotations

import bisect
from dataclasses import dataclass
from typing import Dict, List, Sequence, Tuple

from repro_torch.configs.base import ModelConfig

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


def chunk_tokens_for_budget(cost: "CostModel", budget: float,
                            quantum: int, cap: int) -> int:
    """Chunked-prefill chunk size: the largest multiple of ``quantum``
    whose single-row prefill cost fits within ``budget`` seconds — the
    caller prices the budget as ``prefill_stall_factor`` decode ticks of
    the current batch, the same stall bound the two-phase admission veto
    enforces (chunking turns that all-or-nothing veto into a per-chunk
    guarantee).

    ``quantum`` is the backend's progress granule (the paged-KV block
    size, so chunk seams land on block boundaries and every distinct
    query offset is a reusable cell); the result is always at
    least one quantum — a budget too small for any progress would
    otherwise starve prefill forever.  ``cap`` bounds the search (the
    longest admissible prompt: a bigger chunk could never be
    dispatched).  Deterministic in its inputs, so the port and the JAX
    package size chunks identically given the same cost model.
    """
    if quantum <= 0:
        raise ValueError(f"quantum must be positive, got {quantum}")
    c = quantum
    while c + quantum <= cap and \
            cost.prefill_latency(c + quantum, 1) <= budget:
        c += quantum
    return c


def prefix_fresh_blocks(total_tokens: int, cached_tokens: int,
                        block_size: int) -> int:
    """Fresh blocks a request consumes when ``cached_tokens`` of its
    prompt are served from a shared prefix cache.

    Only *whole* shared blocks are free: a cached prefix ending mid-block
    still costs that block (the request copy-on-writes it before its
    suffix lands there).  The engine and the admission planner must both
    charge this same number.
    """
    return blocks_for_tokens(total_tokens, block_size) - \
        max(int(cached_tokens), 0) // block_size


class CostModel:
    def latency(self, seq_len: int, batch: int) -> float:
        raise NotImplementedError

    def per_request(self, seq_len: int, batch: int) -> float:
        return self.latency(seq_len, batch) / max(batch, 1)

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

    def packed_prefill_latency(self, flat_tokens: int,
                               segments: int = 1) -> float:
        """One *packed* prefill dispatch: ``segments`` independent
        prompts concatenated into a single flat sequence of
        ``flat_tokens`` tokens, priced as ONE launch over the flat tokens
        (a single-row prefill), so packing N segments amortizes N-1
        per-dispatch overheads.  ``segments`` is accepted for models whose
        per-segment cost is not purely token-proportional."""
        del segments
        return self.prefill_latency(max(int(flat_tokens), 1), 1)


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

    @classmethod
    def for_model(cls, cfg: ModelConfig, chips: int = 1,
                  dtype_bytes: int = 2) -> "AnalyticCostModel":
        n_active = cfg.active_param_count()
        return cls(
            flops_per_token=2.0 * n_active,
            bytes_per_token=2.0 * cfg.d_model * cfg.num_layers * dtype_bytes,
            weight_bytes=float(n_active * dtype_bytes),
            chips=chips)

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


class TableCostModel(CostModel):
    """Warm-up table + bilinear interpolation (paper §5, both strategies:
    dense warm-up for small parameter spaces, sampled+interpolated for
    large ones; `observe` implements the lazy live refinement)."""

    def __init__(self, table: Dict[Tuple[int, int], float]) -> None:
        if not table:
            raise ValueError("empty cost table")
        self.table = dict(table)
        self._rebuild()

    def _rebuild(self) -> None:
        self.lengths = sorted({k[0] for k in self.table})
        self.batches = sorted({k[1] for k in self.table})

    @classmethod
    def warmup(cls, measure, lengths: Sequence[int],
               batches: Sequence[int]) -> "TableCostModel":
        """measure(seq_len, batch) -> seconds (full-batch latency)."""
        table = {(l, b): float(measure(l, b))
                 for l in lengths for b in batches}
        return cls(table)

    def observe(self, seq_len: int, batch: int, latency: float,
                ema: float = 0.3) -> None:
        key = (seq_len, batch)
        if key in self.table:
            self.table[key] = (1 - ema) * self.table[key] + ema * latency
        else:
            self.table[key] = latency
            self._rebuild()

    def _nearest(self, grid: List[int], x: int) -> Tuple[int, int, float]:
        """Bracketing grid points and interpolation weight."""
        i = bisect.bisect_left(grid, x)
        if i == 0:
            return grid[0], grid[0], 0.0
        if i >= len(grid):
            return grid[-1], grid[-1], 0.0
        lo, hi = grid[i - 1], grid[i]
        if lo == hi:
            return lo, hi, 0.0
        w = (x - lo) / (hi - lo)
        return lo, hi, w

    def latency(self, seq_len: int, batch: int) -> float:
        l0, l1, wl = self._nearest(self.lengths, seq_len)
        b0, b1, wb = self._nearest(self.batches, batch)

        def at(l, b):
            if (l, b) in self.table:
                return self.table[(l, b)]
            # fall back to nearest available in batch dim
            cands = [bb for bb in self.batches if (l, bb) in self.table]
            bb = min(cands, key=lambda x: abs(x - b))
            return self.table[(l, bb)] * (b / bb)
        v00, v01 = at(l0, b0), at(l0, b1)
        v10, v11 = at(l1, b0), at(l1, b1)
        v0 = v00 * (1 - wb) + v01 * wb
        v1 = v10 * (1 - wb) + v11 * wb
        lat = v0 * (1 - wl) + v1 * wl
        # extrapolate beyond grid linearly in tokens
        if seq_len > self.lengths[-1]:
            lat *= seq_len / self.lengths[-1]
        if batch > self.batches[-1]:
            lat *= batch / self.batches[-1]
        return lat


@dataclass
class BucketedCostModel(CostModel):
    """Beyond-paper: accounts for length bucketing — the engine pads
    seq_len up to the next bucket, so cost is a step function of length.
    Wrapping the base model with the *actual executed* shape makes the DP
    scheduler bucket-aware (it then prefers batches that share a bucket)."""
    base: CostModel
    buckets: Sequence[int] = (32, 64, 128, 256, 512, 1024, 2048, 4096)

    def bucket_of(self, seq_len: int) -> int:
        for b in self.buckets:
            if seq_len <= b:
                return b
        return self.buckets[-1]

    def latency(self, seq_len: int, batch: int) -> float:
        return self.base.latency(self.bucket_of(seq_len), batch)

    def decode_latency(self, batch: int, context_len: int = 0) -> float:
        # decode executes a length-1 step regardless of bucketing; only
        # the KV context the step streams is bucket-padded
        ctx = self.bucket_of(context_len) if context_len else 0
        return self.base.decode_latency(batch, ctx)
