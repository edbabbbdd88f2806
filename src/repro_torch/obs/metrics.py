"""Zero-dependency metrics registry: counters, gauges, and histograms
with fixed log-spaced buckets.

Everything here is plain host-side Python — no torch, no numpy, no I/O —
so the serving tick loop can record at tick boundaries without ever
forcing a device->host sync.  The registry is the single counter
system for the serving stack: `ServingPipeline.stats` is a thin view
over it (see `repro_torch.core.pipeline.PipelineStats`).

Concurrency: the registry has no internal locking.  Every producer in
the serving stack records under the pipeline owner's lock
(`TurboClient._cv` when a pump thread exists); readers snapshot under
the same lock (`TurboClient.metrics()`).

A **disabled** registry (``MetricsRegistry(enabled=False)``) is a
no-op: every ``counter()/gauge()/histogram()`` lookup returns a shared
null instrument whose record methods do nothing, and ``snapshot()``
returns ``{}``.
"""
from __future__ import annotations

import math
from bisect import bisect_left
from typing import Dict, List, Optional, Tuple

__all__ = ["Counter", "Gauge", "Histogram", "MetricsRegistry"]


class Counter:
    """Monotonically increasing count (ticks, admissions, vetoes...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-set level (queue depth, free blocks, batch occupancy...)."""

    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def set(self, v) -> None:
        self.value = v


class Histogram:
    """Fixed log-spaced buckets: bucket ``i`` holds observations
    ``<= lo * growth**i``, plus one overflow bucket.  Percentiles are
    read from the bucket edges (relative error bounded by ``growth``),
    clamped to the exact observed min/max so single-valued and
    tight distributions report exactly.

    Non-positive observations land in the first bucket (log buckets
    have no home for them; the serving stack only ever records
    durations and sizes, where 0 means "instant").
    """

    __slots__ = ("_edges", "_bucket_tally", "_count", "_sum",
                 "_min", "_max")

    def __init__(self, lo: float = 1e-6, growth: float = 2.0,
                 n: int = 40) -> None:
        if lo <= 0 or growth <= 1.0 or n < 1:
            raise ValueError(
                f"need lo > 0, growth > 1, n >= 1; got lo={lo} "
                f"growth={growth} n={n}")
        self._edges: Tuple[float, ...] = tuple(
            lo * growth ** i for i in range(n))
        self._bucket_tally: List[int] = [0] * (n + 1)   # +1 = overflow
        self._count = 0
        self._sum = 0.0
        self._min = math.inf
        self._max = -math.inf

    # -- recording -----------------------------------------------------
    def observe(self, v: float) -> None:
        self._bucket_tally[bisect_left(self._edges, v)] += 1
        self._count += 1
        self._sum += v
        if v < self._min:
            self._min = v
        if v > self._max:
            self._max = v

    # -- queries -------------------------------------------------------
    @property
    def count(self) -> int:
        return self._count

    @property
    def total(self) -> float:
        return self._sum

    @property
    def min(self) -> Optional[float]:
        return None if self._count == 0 else self._min

    @property
    def max(self) -> Optional[float]:
        return None if self._count == 0 else self._max

    @property
    def mean(self) -> float:
        return self._sum / self._count if self._count else 0.0

    def percentile(self, q: float) -> float:
        """Value at quantile ``q`` in (0, 1], e.g. 0.5 for the median;
        0.0 when nothing was observed.  Reads the upper edge of the
        bucket where the cumulative count crosses ``q``, clamped to
        the observed [min, max]."""
        if not 0.0 < q <= 1.0:
            raise ValueError(f"q must be in (0, 1], got {q}")
        if self._count == 0:
            return 0.0
        target = q * self._count
        seen = 0
        edge = self._max
        for i, c in enumerate(self._bucket_tally):
            seen += c
            if seen >= target:
                edge = self._edges[i] if i < len(self._edges) \
                    else self._max
                break
        return min(max(edge, self._min), self._max)

    def snapshot(self) -> dict:
        nonzero = {
            f"{self._edges[i]:.3g}" if i < len(self._edges) else "+inf":
            c for i, c in enumerate(self._bucket_tally) if c
        }
        return {
            "count": self._count,
            "sum": self._sum,
            "min": self.min if self._count else 0.0,
            "max": self.max if self._count else 0.0,
            "mean": self.mean,
            "p50": self.percentile(0.50),
            "p90": self.percentile(0.90),
            "p99": self.percentile(0.99),
            "buckets": nonzero,
        }


class _NullCounter(Counter):
    """Shared no-op counter handed out by a disabled registry."""

    __slots__ = ()

    def inc(self, n: int = 1) -> None:
        pass


class _NullGauge(Gauge):
    __slots__ = ()

    def set(self, v) -> None:
        pass


class _NullHistogram(Histogram):
    __slots__ = ()

    def observe(self, v: float) -> None:
        pass


_NULL_COUNTER = _NullCounter()
_NULL_GAUGE = _NullGauge()
_NULL_HISTOGRAM = _NullHistogram()


class MetricsRegistry:
    """Name -> instrument map with create-on-first-use semantics.

    Names are dotted paths (``pipeline.decode_ticks``,
    ``kv.blocks_free``); the catalog lives in `src/repro/obs/README.md`.
    Asking for an existing name with a different instrument type is an
    error — one name, one meaning.
    """

    def __init__(self, enabled: bool = True) -> None:
        self.enabled = enabled
        self._instruments: Dict[str, object] = {}

    def _get(self, name: str, cls, null, **kw):
        if not self.enabled:
            return null
        inst = self._instruments.get(name)
        if inst is None:
            inst = cls(**kw)
            self._instruments[name] = inst
        elif type(inst) is not cls:
            raise TypeError(
                f"metric {name!r} already registered as "
                f"{type(inst).__name__}, not {cls.__name__}")
        return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter, _NULL_COUNTER)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge, _NULL_GAUGE)

    def histogram(self, name: str, lo: float = 1e-6,
                  growth: float = 2.0, n: int = 40) -> Histogram:
        return self._get(name, Histogram, _NULL_HISTOGRAM,
                         lo=lo, growth=growth, n=n)

    def snapshot(self) -> dict:
        """Plain-dict (JSON-safe) view of every instrument; ``{}`` for
        a disabled registry."""
        if not self.enabled:
            return {}
        out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
        for name in sorted(self._instruments):
            inst = self._instruments[name]
            if isinstance(inst, Counter):
                out["counters"][name] = inst.value
            elif isinstance(inst, Gauge):
                out["gauges"][name] = inst.value
            else:
                out["histograms"][name] = inst.snapshot()
        return out
