"""Data: deterministic training batches (``TokenStream``) and request
streams for serving, matching the paper's workloads: "randomly
generated texts whose lengths are uniformly distributed from 5 to 500"
with Poisson inter-arrival times (§6.2.1, §6.3).

Counterpart of the JAX package's `repro.data.pipeline`.  The request
generator is copied: the same ``random.Random(seed)`` draws in the same
order, so a seed gives the same requests in both packages.  The token
stream draws each step's batch from a ``torch.Generator`` seeded from
``(seed, step)`` where the JAX package folds the step into a key: the
same batch at every restart, not the JAX package's tokens.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import Any, Dict, Iterator, List

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.serving import Request
from repro_torch.models.io import synthetic_train_batch
from repro_torch.runtime.device import resolve_device


@dataclass(frozen=True)
class LengthDistribution:
    kind: str = "uniform"     # uniform | bimodal | fixed
    lo: int = 5
    hi: int = 500

    def sample(self, rng: random.Random) -> int:
        if self.kind == "fixed":
            return self.hi
        if self.kind == "bimodal":
            return rng.randint(self.lo, self.lo + 10) if rng.random() < 0.5 \
                else rng.randint(max(self.hi - 10, self.lo), self.hi)
        return rng.randint(self.lo, self.hi)


@dataclass
class RequestGenerator:
    """Poisson arrivals with random lengths and random token payloads."""
    rate: float
    lengths: LengthDistribution = LengthDistribution()
    vocab_size: int = 1000
    seed: int = 0

    def generate(self, duration: float, with_payload: bool = True
                 ) -> List[Request]:
        rng = random.Random(self.seed)
        t, i, out = 0.0, 0, []
        while True:
            t += rng.expovariate(self.rate)
            if t > duration:
                return out
            n = self.lengths.sample(rng)
            payload = [rng.randrange(self.vocab_size) for _ in range(n)] \
                if with_payload else None
            out.append(Request(i, n, t, payload))
            i += 1


def _step_seed(seed: int, step: int) -> int:
    """The generator seed of ``step``'s batch in a stream seeded with
    ``seed`` (``seed``, ``step`` >= 0): a hash of the pair, so nearby
    seeds give unrelated streams."""
    return int(np.random.SeedSequence([seed, step]).generate_state(
        1, np.uint64)[0])


@dataclass
class TokenStream:
    """Deterministic per-step training batches (restart-reproducible),
    made on ``device`` (default the card)."""
    cfg: ModelConfig
    batch_size: int
    seq_len: int
    seed: int = 0
    device: Any = None

    def batch(self, step: int) -> Dict[str, Any]:
        gen = torch.Generator(device=resolve_device(self.device))
        gen.manual_seed(_step_seed(self.seed, step))
        return synthetic_train_batch(self.cfg, gen, self.batch_size,
                                     self.seq_len)

    def __iter__(self) -> Iterator:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
