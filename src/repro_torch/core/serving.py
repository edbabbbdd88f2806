"""Serving framework (paper §5) for one-shot requests: admission queue,
response cache, batch scheduler triggering (hungry/lazy), SLO guard.
Copied from the JAX package's one-shot (classification) half.

:class:`ServingSystem` is a thin wall-clock wrapper over
`repro_torch.api.client.TurboClient` — the handle-based front-end that
owns the shared scheduler loop (`repro_torch.core.pipeline`).  It runs
an ``execute(batch, padded_len) -> results`` callable, such as
`repro_torch.runtime.engine.InferenceEngine.execute_requests`; requests
finish at prefill.  It adds what the client deliberately leaves out: the
Clipper-style :class:`ResponseCache` and the batch-level
:class:`Response` record keeping the paper's benchmarks comparable.
"""
from __future__ import annotations

import collections
import hashlib
import time
from dataclasses import dataclass
from typing import Any, Callable, List, Optional, Sequence

from repro_torch.core.cost_model import CostModel
from repro_torch.core.pipeline import (PipelineBackend, PipelineConfig,
                                       plan_for_policy)
from repro_torch.runtime.session import Session

__all__ = ["Request", "Response", "ResponseCache", "ServingConfig",
           "ServingSystem", "plan_for_policy"]


def _payload_key(seq_len: int, payload: Any) -> str:
    h = hashlib.sha1(repr(payload).encode()).hexdigest()
    return f"{seq_len}:{h}"


@dataclass
class Request:
    req_id: int
    seq_len: int
    arrival_time: float
    payload: Any = None               # e.g. token ids

    def cache_key(self) -> str:
        """One-shot identity: the payload IS the request."""
        return _payload_key(self.seq_len, self.payload)


@dataclass
class Response:
    req_id: int
    arrival_time: float
    finish_time: float
    batch_size: int
    padded_len: int
    result: Any = None
    cached: bool = False

    @property
    def latency(self) -> float:
        return self.finish_time - self.arrival_time


class ResponseCache:
    """Clipper-style result memoization for frequent identical requests."""

    def __init__(self, capacity: int = 4096) -> None:
        self.capacity = capacity
        self._store: "collections.OrderedDict[str, Any]" = \
            collections.OrderedDict()
        self.hits = 0
        self.misses = 0

    def get(self, key: str):
        if key in self._store:
            self._store.move_to_end(key)
            self.hits += 1
            return self._store[key]
        self.misses += 1
        return None

    def put(self, key: str, value: Any) -> None:
        self._store[key] = value
        self._store.move_to_end(key)
        while len(self._store) > self.capacity:
            self._store.popitem(last=False)


@dataclass
class ServingConfig(PipelineConfig):
    enable_cache: bool = False
    cache_capacity: int = 4096          # ResponseCache size


class CallableBackend(PipelineBackend):
    """One-shot execution through the classic ``execute(requests,
    padded_len) -> results`` callable.  Sessions finish at prefill; there
    is no decode phase and capacity is unbounded."""

    def __init__(self, execute: Callable[[List[Request], int], List[Any]],
                 clock: Callable[[], float]) -> None:
        self.execute = execute
        self.clock = clock

    def prefill_batch(self, sessions: List[Session],
                      padded_len: int) -> None:
        reqs = [Request(s.req_id, s.seq_len, s.arrival_time, s.payload)
                for s in sessions]
        results = self.execute(reqs, padded_len)
        now = self.clock()
        for s, res in zip(sessions, results):
            s.finish(now, result=res)

    def decode_tick(self, sessions: List[Session]) -> None:
        raise RuntimeError("one-shot backend has no decode phase")


class ServingSystem:
    """Real-time one-shot serving loop over a live engine.

    ``clock()`` returns the current time (wall clock by default; tests
    swap in virtual clocks).  The scheduler loop itself is owned by an
    embedded :class:`repro_torch.api.client.TurboClient`
    (``auto_pump=False`` — ServingSystem drives the ticks).
    """

    def __init__(self, execute: Callable[[List[Request], int], List[Any]],
                 cost_model: CostModel,
                 config: Optional[ServingConfig] = None,
                 clock: Callable[[], float] = time.monotonic) -> None:
        # deferred import: repro_torch.api.client sits on
        # repro_torch.core.pipeline / cost_model, and importing it at
        # module scope would close an import cycle through
        # repro_torch.core.__init__ when repro_torch.api loads first
        from repro_torch.api.client import TurboClient
        self.config = config if config is not None else ServingConfig()
        self.clock = clock
        self.client = TurboClient(CallableBackend(execute, clock),
                                  cost_model=cost_model, config=self.config,
                                  clock=clock, auto_pump=False)
        self.pipeline = self.client.pipeline
        self.cache = ResponseCache(self.config.cache_capacity)
        self.responses: List[Response] = []

    def submit(self, req: Request) -> Optional[Response]:
        """Returns the Response immediately on a cache hit, else None (the
        response arrives from a later ``step()``/``drain()``)."""
        if self.config.enable_cache:
            cached = self.cache.get(req.cache_key())
            if cached is not None:
                resp = Response(req.req_id, req.arrival_time, self.clock(),
                                1, req.seq_len, cached, cached=True)
                self.responses.append(resp)
                return resp
        prompt = req.payload if isinstance(req.payload, (list, tuple)) \
            else None
        self.client.submit_session(Session(
            req_id=req.req_id, seq_len=req.seq_len,
            arrival_time=req.arrival_time, prompt=prompt,
            payload=req.payload))
        return None

    def _collect(self, finished: Sequence[Session]) -> List[Response]:
        out = []
        for s in finished:
            resp = Response(s.req_id, s.arrival_time, s.finish_time,
                            s.batch_size, s.padded_len, s.result)
            out.append(resp)
            # never memoize a failed session: its missing result is not
            # the answer to the request's key
            if self.config.enable_cache and s.error is None:
                self.cache.put(_payload_key(s.seq_len, s.payload), s.result)
        self.responses.extend(out)
        return out

    def step(self) -> List[Response]:
        """One scheduler tick: a prefill admission round (the whole
        plan)."""
        return self._collect(self.pipeline.tick())

    def drain(self) -> List[Response]:
        return self._collect(self.pipeline.drain())
