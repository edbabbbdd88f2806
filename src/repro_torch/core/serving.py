"""Serving framework (paper §5): admission queue, response cache, batch
scheduler triggering (hungry/lazy), SLO guard.

Since the streaming-API redesign, :class:`ServingSystem` is a thin
wall-clock wrapper over `repro_torch.api.client.TurboClient` — the handle-based
submit/stream/cancel front-end that owns the shared scheduler loop
(`repro_torch.core.pipeline`, the same loop the virtual-clock simulator
drives).  ServingSystem adds what the client deliberately leaves out:
the Clipper-style :class:`ResponseCache` and the batch-level
:class:`Response` record keeping the paper's benchmarks comparable.
Two execution styles are supported:

- one-shot (classification): construct with ``execute(batch, padded_len)
  -> results``, exactly as before; requests finish at prefill;
- generative continuous batching: construct with ``backend=`` an engine
  backend (e.g. `repro_torch.runtime.engine.ContinuousEngine`) and submit
  sessions with a ``max_new_tokens`` budget (plus per-request sampling
  params); new arrivals join the next decode tick without waiting for
  in-flight generations to drain.
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


@dataclass
class Request:
    req_id: int
    seq_len: int
    arrival_time: float
    payload: Any = None               # e.g. token ids

    def cache_key(self) -> str:
        """One-shot identity: the payload IS the request (generative
        sessions key on prompt + every generation param — see
        `repro_torch.runtime.session.Session.cache_key`)."""
        h = hashlib.sha1(repr(self.payload).encode()).hexdigest()
        return f"{self.seq_len}:{h}"


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
    """Real-time serving loop over a live engine.

    ``clock()`` returns the current time (wall clock by default; tests and
    the simulator swap in virtual clocks).  The scheduler loop itself is
    owned by an embedded :class:`repro_torch.api.client.TurboClient`
    (``auto_pump=False`` — ServingSystem drives the ticks), so handles
    obtained from ``self.client`` interoperate with ``step()``/``drain()``.
    """

    def __init__(self,
                 execute: Optional[
                     Callable[[List[Request], int], List[Any]]] = None,
                 cost_model: Optional[CostModel] = None,
                 config: Optional[ServingConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 backend: Optional[PipelineBackend] = None) -> None:
        if (execute is None) == (backend is None):
            raise ValueError("pass exactly one of execute= or backend=")
        if cost_model is None:
            raise ValueError("cost_model is required (admission planning "
                             "and the two-phase regime depend on it)")
        # deferred import: repro_torch.api.client sits on repro_torch.core.pipeline /
        # cost_model, and importing it at module scope would close an
        # import cycle through repro_torch.core.__init__ when repro_torch.api loads
        # first
        from repro_torch.api.client import TurboClient
        self.config = config if config is not None else ServingConfig()
        self.clock = clock
        if backend is None:
            backend = CallableBackend(execute, clock)
        self.backend = backend
        self.client = TurboClient(backend, cost_model=cost_model,
                                  config=self.config, clock=clock,
                                  auto_pump=False)
        self.pipeline = self.client.pipeline
        self.cache = ResponseCache(self.config.cache_capacity)
        self.responses: List[Response] = []

    # -- compatibility helpers ----------------------------------------
    @property
    def cost(self) -> CostModel:
        return self.pipeline.cost

    def should_flush(self) -> bool:
        return self.pipeline.should_admit()

    def _as_session(self, req) -> Session:
        if isinstance(req, Session):
            return req
        return Session.from_request(req)

    def submit(self, req) -> Optional[Response]:
        """Accepts a Request (one-shot) or a Session (generative).
        Returns the Response immediately on a cache hit, else None (the
        response arrives from a later ``step()``/``drain()``).  The
        cache key covers the FULL request identity — prompt, budget,
        eos/stop, and every sampling param — so two same-prompt requests
        with different generation params never collide."""
        session = self._as_session(req)
        if self.config.enable_cache:
            cached = self.cache.get(session.cache_key())
            if cached is not None:
                resp = Response(session.req_id, session.arrival_time,
                                self.clock(), 1, session.seq_len, cached,
                                cached=True)
                self.responses.append(resp)
                return resp
        self.client.submit_session(session)
        return None

    def _collect(self, finished: Sequence[Session]) -> List[Response]:
        out = []
        for s in finished:
            result = s.result
            if result is None and s.generated:
                result = list(s.prompt or []) + list(s.generated)
            resp = Response(s.req_id, s.arrival_time, s.finish_time,
                            s.batch_size, s.padded_len, result)
            out.append(resp)
            # never memoize a cancelled or failed session: its partial /
            # missing result is not the answer to the request's key
            if self.config.enable_cache and s.error is None \
                    and not s.cancelled:
                self.cache.put(s.cache_key(), result)
        self.responses.extend(out)
        return out

    def step(self) -> List[Response]:
        """One scheduler tick: a prefill admission round (the whole
        plan), one resumable-prefill chunk, or one decode step over the
        in-flight batch."""
        return self._collect(self.pipeline.tick())

    def drain(self) -> List[Response]:
        return self._collect(self.pipeline.drain())

    def cancel(self, session: Session) -> bool:
        """Cancel a submitted session in any state (queued, resumable
        prefill, mid-decode); every block/slot it held is released and
        its (partial) response is collected immediately."""
        if not self.pipeline.cancel(session):
            return False
        self._collect([session])
        return True
