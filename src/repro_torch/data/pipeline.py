"""Request streams for serving, matching the paper's workloads: "randomly
generated texts whose lengths are uniformly distributed from 5 to 500"
with Poisson inter-arrival times (§6.2.1, §6.3).

The serving part of the JAX package's `repro.data.pipeline`, copied: the
same ``random.Random(seed)`` draws in the same order, so a seed gives the
same requests in both packages.
"""
from __future__ import annotations

import random
from dataclasses import dataclass
from typing import List

from repro_torch.core.serving import Request


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
