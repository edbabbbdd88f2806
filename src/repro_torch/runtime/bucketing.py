"""Length bucketing (copied from the JAX package): the engine pads each
batch up to a (sequence bucket, batch bucket) cell.  The port runs
eagerly, so a bucket is not a compiled executable here; it keeps the set
of shapes the card sees small and fixed, and the paged pool's block size
divides every bucket.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple


DEFAULT_BUCKETS: Tuple[int, ...] = (32, 64, 128, 256, 512, 1024, 2048, 4096)
DEFAULT_BATCH_BUCKETS: Tuple[int, ...] = (1, 2, 4, 8, 16, 32)


@dataclass(frozen=True)
class BucketLadder:
    seq_buckets: Tuple[int, ...] = DEFAULT_BUCKETS
    batch_buckets: Tuple[int, ...] = DEFAULT_BATCH_BUCKETS

    def seq_bucket(self, seq_len: int) -> int:
        for b in self.seq_buckets:
            if seq_len <= b:
                return b
        raise ValueError(
            f"seq_len {seq_len} exceeds max bucket {self.seq_buckets[-1]}")

    def pack_bucket(self, flat_tokens: int) -> int:
        """Bucket for a packed-prefill flat token count.  Packs concatenate
        many segments, so the flat length may exceed the top seq bucket;
        the ladder keeps doubling past it so the set of shapes stays
        logarithmic instead of per-length."""
        t = max(int(flat_tokens), 1)
        for b in self.seq_buckets:
            if t <= b:
                return b
        b = self.seq_buckets[-1]
        while b < t:
            b *= 2
        return b

    def batch_bucket(self, batch: int) -> int:
        for b in self.batch_buckets:
            if batch <= b:
                return b
        raise ValueError(
            f"batch {batch} exceeds max bucket {self.batch_buckets[-1]}")
