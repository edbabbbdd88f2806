"""Handle-based streaming client over the serving pipeline.

:class:`TurboClient` is the front door to the serving stack: construct
it from an arch name (:meth:`TurboClient.from_arch`), an existing
`repro_torch.runtime.engine.ContinuousEngine`, or a virtual-clock
`repro_torch.core.simulator.VirtualBackend` (:meth:`TurboClient.simulated`),
then ``submit(prompt, params)`` and consume the returned
:class:`RequestHandle`.  Copied from the JAX package; the port builds
its stack with PyTorch on CUDA devices (or the CPU, when asked).

The client owns a `repro_torch.core.pipeline.ServingPipeline` and pumps it so
callers never touch ``tick()``:

- ``auto_pump="sync"`` (default): ``result()`` / ``stream()`` drive the
  pipeline on demand from the calling thread — deterministic, and
  exactly what the virtual-clock backend needs;
- ``auto_pump="thread"``: a daemon thread ticks whenever work is
  pending and handle calls just wait;
- ``auto_pump=False``: the owner drives ``pipeline.tick()`` itself.

The engine, the simulator and the cluster tier are imported lazily by
the constructors, so the client imports no torch code of its own.
"""
from __future__ import annotations

import itertools
import threading
import time
import weakref
from collections import deque
from typing import (Callable, Deque, Iterator, List, Optional, Sequence,
                    Union)

from repro_torch.core.cost_model import AnalyticCostModel, CostModel
from repro_torch.core.pipeline import (PipelineBackend, PipelineConfig,
                                 ServingPipeline)
from repro_torch.obs import Histogram, Observability, TraceRecorder
from repro_torch.runtime.session import GenerationParams, Session, SessionState

__all__ = ["GenerationParams", "RequestHandle", "TurboClient"]

# cheap default cost model (the admission planner only needs relative
# costs to order/veto batches)
_DEFAULT_COST = dict(flops_per_token=1e6, bytes_per_token=1e3,
                     weight_bytes=1e6, overhead=1e-4)


class _FairRLock:
    """A reentrant lock that passes, on release, to the thread that has
    waited longest.  The client's lock: a pump thread ticks under it and
    takes it again right after each tick, and with a plain lock a thread
    waiting for it (a submit, a pool routing a prompt, a warm-up's round
    boundary) would almost never get in until the pipeline idled.
    Supports what `threading.Condition` uses (``acquire`` with
    ``blocking`` and ``timeout``, ``release``, and the save / restore
    pair that lets ``wait`` drop every recursion level)."""

    def __init__(self) -> None:
        self._mutex = threading.Lock()
        self._owner: Optional[int] = None
        self._count = 0
        self._waiters: Deque[tuple] = deque()    # (gate, thread id)

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        me = threading.get_ident()
        with self._mutex:
            if self._owner == me:
                self._count += 1
                return True
            if self._owner is None and not self._waiters:
                self._owner, self._count = me, 1
                return True
            if not blocking:
                return False
            gate = threading.Lock()
            gate.acquire()
            entry = (gate, me)
            self._waiters.append(entry)
        if gate.acquire(True, timeout):
            return True
        with self._mutex:
            if self._owner == me:      # handed over as the wait timed out
                return True
            self._waiters.remove(entry)
            return False

    def _hand_over(self) -> None:
        if self._waiters:
            gate, self._owner = self._waiters.popleft()
            self._count = 1
            gate.release()
        else:
            self._owner, self._count = None, 0

    def release(self) -> None:
        with self._mutex:
            if self._owner != threading.get_ident():
                raise RuntimeError("cannot release un-acquired lock")
            self._count -= 1
            if self._count == 0:
                self._hand_over()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> None:
        self.release()

    def _is_owned(self) -> bool:
        return self._owner == threading.get_ident()

    def _release_save(self) -> int:
        with self._mutex:
            saved = self._count
            self._hand_over()
            return saved

    def _acquire_restore(self, saved: int) -> None:
        self.acquire()
        self._count = saved


class RequestHandle:
    """One submitted request: ``result()`` / ``stream()`` / ``cancel()``.

    Tokens arrive through the pipeline's token-emission callback; the
    handle records a wall-clock timestamp per delivery, so client-side
    TTFT (`ttft`) and inter-token latencies (`inter_token_latencies`)
    are measured where a user would measure them — at the handle, not
    inside the engine.

    ITL telemetry is bounded: raw delivery timestamps live in a ring
    of the most recent `ITL_WINDOW` deliveries (an unbounded list once
    grew one float per token for the stream's whole life), and
    percentile math over the FULL stream goes through a shared
    `repro_torch.obs.Histogram` (`itl_percentile`), which is O(buckets)
    however long the stream runs.
    """

    #: delivery timestamps retained for `inter_token_latencies` — a
    #: window, not the stream's life
    ITL_WINDOW = 1024

    def __init__(self, client: "TurboClient", session: Session) -> None:
        self._client = client
        self.session = session
        self.submit_time = client.clock()
        self._tokens: List[int] = []         # delivered, in order
        self._first_token_time: Optional[float] = None
        # wall time per delivery, most recent ITL_WINDOW only
        self._token_times: Deque[float] = deque(maxlen=self.ITL_WINDOW)
        self._itl_hist = Histogram()         # full-stream ITL summary

    # -- queries ---------------------------------------------------------
    @property
    def req_id(self) -> int:
        return self.session.req_id

    @property
    def state(self) -> SessionState:
        return self.session.state

    @property
    def done(self) -> bool:
        return self.session.is_finished

    @property
    def cancelled(self) -> bool:
        return self.session.cancelled

    def tokens(self) -> List[int]:
        """Generated tokens delivered so far (no pumping)."""
        return list(self._tokens)

    @property
    def ttft(self) -> Optional[float]:
        """Client-side time to first token (None until it lands)."""
        if self._first_token_time is None:
            return None
        return self._first_token_time - self.submit_time

    def inter_token_latencies(self) -> List[float]:
        """Client-side gaps between consecutive token deliveries,
        within the most recent `ITL_WINDOW` deliveries (use
        `itl_percentile` for full-stream summaries)."""
        times = list(self._token_times)
        return [b - a for a, b in zip(times, times[1:])]

    def itl_percentile(self, q: float) -> float:
        """Full-stream inter-token latency at quantile ``q`` in (0, 1]
        (log-bucketed `repro_torch.obs.Histogram` — constant memory no matter
        how long the stream ran); 0.0 before the second token."""
        return self._itl_hist.percentile(q)

    # -- consumption -----------------------------------------------------
    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block (pumping the pipeline as needed) until the request
        finishes; returns the full token list (prompt + generation).
        A cancelled request returns its partial generation.  Raises
        RuntimeError if the request failed terminally or ``timeout``
        (seconds) elapses first."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self.session.is_finished:
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(
                    f"request {self.req_id} not finished within "
                    f"{timeout}s")
            self._client._advance(self)
        s = self.session
        if s.error is not None and not s.cancelled:
            raise RuntimeError(f"request {self.req_id} failed: {s.error}")
        if s.result is not None:
            return list(s.result)
        return list(s.prompt or []) + list(s.generated)

    def stream(self) -> Iterator[int]:
        """Yield generated tokens as decode ticks land, in order,
        ending when the request finishes (or is cancelled — the stream
        then ends after the tokens generated before the cancel)."""
        i = 0
        while True:
            while i < len(self._tokens):
                yield self._tokens[i]
                i += 1
            if self.session.is_finished:
                break
            self._client._advance(self)
        while i < len(self._tokens):        # tokens from the final tick
            yield self._tokens[i]
            i += 1
        s = self.session
        if s.error is not None and not s.cancelled:
            raise RuntimeError(f"request {self.req_id} failed: {s.error}")

    def cancel(self) -> bool:
        """Tear the request down in whatever state it is in — queued,
        mid-(chunked-)prefill, or mid-decode.  Every block / slot /
        shared-prefix hold it had is released.  Returns False if it had
        already finished."""
        return self._client._cancel(self.session)

    # internal: the client's token callback appends here
    def _deliver(self, toks: Sequence[int], now: float) -> None:
        if not toks:
            return
        if self._first_token_time is None:
            self._first_token_time = now
        for t in toks:
            self._tokens.append(int(t))
            if self._token_times:
                # tokens within one delivery share a timestamp, so the
                # intra-batch gaps land as 0.0 — same as the old
                # unbounded-list telemetry
                self._itl_hist.observe(now - self._token_times[-1])
            self._token_times.append(now)


class TurboClient:
    """Submit/stream/cancel front-end over any pipeline backend.

    A few lines integrate the serving stack into user code::

        from repro_torch.api import GenerationParams, TurboClient
        client = TurboClient.from_arch("internlm2-1.8b")
        handle = client.submit([1, 2, 3],
                               GenerationParams(max_new_tokens=16,
                                                temperature=0.8, seed=7))
        for token in handle.stream():
            ...                         # tokens land as decode ticks run
    """

    def __init__(self, backend: PipelineBackend, *,
                 cost_model: Optional[CostModel] = None,
                 config: Optional[PipelineConfig] = None,
                 clock: Optional[Callable[[], float]] = None,
                 auto_pump: Union[str, bool] = "sync",
                 warmup: Union[bool, str] = False,
                 trace: Union[bool, TraceRecorder] = False) -> None:
        if auto_pump not in ("sync", "thread", False):
            raise ValueError("auto_pump must be 'sync', 'thread' or "
                             f"False, got {auto_pump!r}")
        if warmup not in (True, False, "background"):
            raise ValueError("warmup must be True, False or "
                             f"'background', got {warmup!r}")
        if clock is None:
            clock = getattr(backend, "clock", None) or time.monotonic
        self.clock = clock
        self.backend = backend
        cost = cost_model if cost_model is not None \
            else AnalyticCostModel(**_DEFAULT_COST)
        # observability: metrics always on; tracing per `trace` (True
        # for a default recorder, or bring your own TraceRecorder)
        if isinstance(trace, TraceRecorder):
            obs = Observability(trace=trace)
        else:
            obs = Observability.with_trace() if trace else Observability()
        self.obs = obs
        self.pipeline = ServingPipeline(
            backend, cost, config if config is not None
            else PipelineConfig(), clock, obs=obs)
        self.pipeline.on_token = self._on_token
        self.auto_pump = auto_pump
        # weak-valued: the registry only serves token routing and never
        # keeps a handle alive — callers that discard their handle leak
        # nothing, while held handles keep receiving tokens for as long
        # as they exist
        self._handles: "weakref.WeakValueDictionary[int, RequestHandle]" \
            = weakref.WeakValueDictionary()
        self._ids = itertools.count()
        self._cv = threading.Condition(_FairRLock())
        self._closed = False
        self._pump_error: Optional[BaseException] = None
        self._pump_thread: Optional[threading.Thread] = None
        # warmup: `warmup_aot` walks the reference's warm-up rounds
        # (the slot state at its top size, one sampled round per
        # reachable prefill cell and admission size, the greedy and
        # sampled decode ticks, and on the packed path a pack with
        # prefix keys and one per admission size), so on the card every
        # reachable prefill and tick cell is captured as a CUDA graph
        # before the first request.  ``True`` warms at construction;
        # ``"background"`` walks the same rounds on a daemon thread,
        # yielding the client lock between rounds so early submits are
        # served between them (`warmup_stats` reports progress).  Opt-in
        # here; `from_arch` warms by default, as the reference's does.
        self.warmup_stats: Optional[dict] = None
        if warmup and hasattr(backend, "warmup_aot"):
            if warmup == "background":
                self.warmup_stats = {"mode": "background", "done": False,
                                     "rounds_completed": 0}
            else:
                self.warmup_stats = backend.warmup_aot()
        self._warmup_thread: Optional[threading.Thread] = None
        if auto_pump == "thread":
            self._pump_thread = threading.Thread(
                target=self._pump_loop, daemon=True,
                name="turbo-client-pump")
            self._pump_thread.start()
        # started last: the warmup thread takes `_cv`, so every other
        # field must exist before it can observe the client
        if warmup == "background" and hasattr(backend, "warmup_aot"):
            self._warmup_thread = threading.Thread(
                target=self._background_warmup, daemon=True,
                name="turbo-client-warmup")
            self._warmup_thread.start()

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_arch(cls, arch: str, *, smoke: bool = True,
                  device: str = "cuda",
                  max_slots: int = 8, cap_new: int = 64,
                  seq_buckets: Sequence[int] = (32, 64, 128),
                  batch_buckets: Sequence[int] = (1, 2, 4, 8),
                  prefix_cache: bool = False,
                  cost_model: Optional[CostModel] = None,
                  config: Optional[PipelineConfig] = None,
                  init_seed: int = 0,
                  auto_pump: Union[str, bool] = "sync",
                  warmup: Union[bool, str] = True,
                  sample_candidates: Optional[int] = None,
                  trace: Union[bool, TraceRecorder] = False,
                  replicas: int = 1,
                  **backend_kw):
        """Build the whole serving stack from an arch name: reduced
        (``smoke=True``) or full config, fresh params drawn from
        ``init_seed`` on ``device``, a bucketed InferenceEngine, and a
        ContinuousEngine backend (paged KV unless ``backend_kw`` asks for
        ``kv_layout="contiguous"``; ``prefix_cache=True`` shares prompt
        prefixes across requests over the paged pool).  ``device`` defaults to
        ``"cuda"``; without a card the call raises unless the caller
        passes ``device="cpu"``.  ``warmup`` defaults to True, as the
        reference's does: `ContinuousEngine.warmup_aot` captures every
        reachable cell before the first request; ``warmup="background"``
        warms on a daemon thread instead.  ``replicas=N`` returns a
        `repro_torch.cluster.ReplicaPool` of N such stacks behind the
        same submit/stream/cancel surface: the weights are drawn once;
        each replica has its own InferenceEngine (its own cells) and
        ContinuousEngine (its own KV pool); on one card every replica
        reads the same weight tensors, and with several visible cards
        replica i goes on ``cuda:{i % n}``, as the reference places
        replicas over ``jax.devices()``."""
        from repro_torch.configs import get_config, get_smoke_config
        from repro_torch.models import init_params
        from repro_torch.runtime.bucketing import BucketLadder
        from repro_torch.runtime.device import resolve_device
        from repro_torch.runtime.engine import (ContinuousEngine,
                                                InferenceEngine)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        dev = resolve_device(device)
        cfg = get_smoke_config(arch) if smoke else get_config(arch)
        params = init_params(cfg, seed=init_seed, device=dev)
        devices = [dev]
        if dev.type == "cuda" and replicas > 1:
            import torch
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]

        def build_one(i: int, rec) -> "TurboClient":
            engine = InferenceEngine(cfg, params, ladder=BucketLadder(
                seq_buckets=tuple(seq_buckets),
                batch_buckets=tuple(batch_buckets)),
                sample_candidates=sample_candidates,
                device=devices[i % len(devices)])
            backend = ContinuousEngine(engine, max_slots=max_slots,
                                       cap_new=cap_new,
                                       prefix_cache=prefix_cache,
                                       **backend_kw)
            return cls(backend, cost_model=cost_model, config=config,
                       auto_pump=auto_pump, warmup=warmup, trace=rec)

        if replicas == 1:
            # single replica keeps the historical path (including a
            # caller-supplied TraceRecorder)
            return build_one(0, trace)
        # lazy: repro_torch.cluster imports nothing from repro_torch.api,
        # but keep the cluster tier out of the api import graph regardless
        from repro_torch.cluster import ReplicaPool
        return ReplicaPool([build_one(i, bool(trace))
                            for i in range(replicas)], trace=bool(trace))

    @classmethod
    def simulated(cls, cost_model: Optional[CostModel] = None,
                  sim_config=None,
                  auto_pump: Union[str, bool] = "sync",
                  trace: Union[bool, TraceRecorder] = False,
                  replicas: int = 1):
        """The same client API over the virtual-clock simulator backend
        — parity harness for scheduling/streaming/cancellation tests
        with no model or device anywhere.  ``replicas=N`` returns a
        `repro_torch.cluster.ReplicaPool` of N independent virtual
        replicas (each with its own clock; the pool drains them
        min-clock-first, the same discipline
        `repro_torch.core.simulator.simulate` uses)."""
        from repro_torch.core.simulator import SimConfig, virtual_replica
        cfg = sim_config if sim_config is not None else SimConfig()
        cost = cost_model if cost_model is not None \
            else AnalyticCostModel(**_DEFAULT_COST)
        if replicas < 1:
            raise ValueError(f"replicas must be >= 1, got {replicas}")
        if replicas == 1:
            backend, clock = virtual_replica(cost, cfg)
            return cls(backend, cost_model=cost,
                       config=cfg.pipeline_config(), clock=clock,
                       auto_pump=auto_pump, trace=trace)
        if auto_pump == "thread":
            raise ValueError("replicas > 1 over the virtual clock is "
                             "sync-driven; auto_pump='thread' would "
                             "race the per-replica clocks")
        from repro_torch.cluster import ReplicaPool

        def build_one() -> "TurboClient":
            backend, clock = virtual_replica(cost, cfg)
            return cls(backend, cost_model=cost,
                       config=cfg.pipeline_config(), clock=clock,
                       auto_pump=auto_pump, trace=bool(trace))

        return ReplicaPool([build_one() for _ in range(replicas)],
                           trace=bool(trace))

    # -- submission ------------------------------------------------------
    def submit(self, prompt: Sequence[int],
               params: Optional[GenerationParams] = None, *,
               stream: bool = True,
               req_id: Optional[int] = None) -> RequestHandle:
        """Queue a generation request; returns its handle immediately.
        ``params`` defaults to greedy ``GenerationParams()``.  With
        ``stream=True`` (default) tokens become host-visible every tick
        (one tiny device read); ``stream=False`` keeps the engine's
        no-per-token-host-sync loop and delivers the whole generation
        when the request finishes."""
        params = params if params is not None else GenerationParams()
        session = Session.from_params(
            req_id if req_id is not None else next(self._ids),
            list(prompt), params, arrival_time=self.clock())
        session.stream = stream
        return self.submit_session(session)

    def submit_session(self, session: Session) -> RequestHandle:
        """Lower-level submit for a pre-built Session (caller owns the
        req_id)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("client is closed")
            handle = RequestHandle(self, session)
            self.pipeline.submit(session)     # backend validation here
            self._handles[session.req_id] = handle
            self._cv.notify_all()
        return handle

    # -- pumping ---------------------------------------------------------
    def pump(self, max_ticks: Optional[int] = None) -> int:
        """Drive the pipeline until idle (or ``max_ticks``); returns the
        number of ticks executed.  Never needed with auto-pump — exposed
        for step-by-step tests and external event loops."""
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            with self._cv:
                if self.pipeline.idle():
                    break
                self.pipeline.tick()
                ticks += 1
                self._cv.notify_all()
        return ticks

    def drain(self) -> List[Session]:
        """Pump everything to completion; returns sessions finished
        across the whole run so far."""
        self.pump()
        # snapshot under the lock: with auto_pump="thread" the pump
        # thread appends to `finished` concurrently
        with self._cv:
            return list(self.pipeline.finished)

    def _advance(self, handle: RequestHandle) -> None:
        """One step of progress on behalf of a blocked handle."""
        if self.auto_pump == "thread":
            with self._cv:
                if self._pump_error is not None:
                    raise RuntimeError("pump thread died") \
                        from self._pump_error
                if self._closed and not handle.session.is_finished:
                    raise RuntimeError(
                        f"client is closed; request {handle.req_id} "
                        "will make no further progress")
                if not handle.session.is_finished:
                    self._cv.wait(0.05)
            return
        with self._cv:
            if handle.session.is_finished:
                return
            if self.auto_pump is False:
                raise RuntimeError(
                    f"request {handle.req_id} is not finished and this "
                    "client is owner-driven (auto_pump=False): drive "
                    "pipeline.tick() / pump() "
                    "before consuming the handle")
            if self.pipeline.idle():
                raise RuntimeError(
                    f"request {handle.req_id} cannot make progress: "
                    "the pipeline is idle (was it submitted to this "
                    "client?)")
            self.pipeline.tick()
            self._cv.notify_all()

    def _pump_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                if self.pipeline.idle():
                    self._cv.wait(0.01)
                    continue
                try:
                    self.pipeline.tick()
                except BaseException as exc:   # propagate to waiters
                    self._pump_error = exc
                    self._cv.notify_all()
                    raise
                self._cv.notify_all()

    def _background_warmup(self) -> None:
        """Daemon-thread body for ``warmup="background"``: run the
        backend's warm-up rounds under the client lock, but drop the
        lock at every round boundary (the ``progress`` callback below)
        so submits and ticks made during warmup interleave instead of
        blocking until the whole walk completes."""

        class _Aborted(Exception):
            pass

        def progress(rounds: int) -> None:
            # nested function: it needs its own `with self._cv:` — and
            # Condition.wait(0) releases every RLock recursion level, so
            # callers blocked on the lock (submits, sync-mode handle
            # waits) run right here (the lock passes to them in turn).
            # Work they queued is then served to completion BEFORE the
            # next warm round: warm rounds assume every engine slot is
            # free, so the engine must be drained at each round boundary.
            with self._cv:
                if self._closed:
                    raise _Aborted()
                self.warmup_stats["rounds_completed"] = rounds
                self._cv.notify_all()
                self._cv.wait(0)
                while not self.pipeline.idle():
                    self.pipeline.tick()
                    self._cv.notify_all()
                if self._closed:
                    raise _Aborted()

        try:
            with self._cv:
                stats = self.backend.warmup_aot(progress=progress)
                self.warmup_stats.update(stats)
                self.warmup_stats["mode"] = "background"
                self.warmup_stats["done"] = True
                self._cv.notify_all()
        except _Aborted:
            with self._cv:
                self.warmup_stats["aborted"] = True
                self.warmup_stats["done"] = True
                self._cv.notify_all()
        except BaseException as exc:
            with self._cv:
                self.warmup_stats["error"] = repr(exc)
                self.warmup_stats["done"] = True
                self._cv.notify_all()

    def wait_warmup(self, timeout: Optional[float] = None) -> dict:
        """Block until background warmup finishes (no-op for eager or
        disabled warmup); returns ``warmup_stats``."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while (self.warmup_stats is not None
                   and not self.warmup_stats.get("done", True)):
                if deadline is not None and time.monotonic() > deadline:
                    raise RuntimeError(
                        f"warmup not finished within {timeout}s")
                self._cv.wait(0.05)
            return dict(self.warmup_stats or {})

    # -- observability ---------------------------------------------------
    def metrics(self) -> dict:
        """Plain-dict snapshot of the serving stack's metrics registry
        (pipeline counters/gauges/histograms plus whatever the backend
        samples at tick boundaries).  Taken under the client lock so a
        concurrent pump thread never half-updates it."""
        with self._cv:
            return self.obs.metrics.snapshot()

    def trace_events(self) -> List[dict]:
        """Raw trace-recorder events so far ([] when tracing is off);
        snapshot under the client lock."""
        with self._cv:
            rec = self.obs.trace
            return list(rec.events) if rec is not None else []

    def save_trace(self, path: str) -> dict:
        """Export the trace as Chrome trace-event JSON (Perfetto /
        ``chrome://tracing``) to ``path``; returns the document.  Raises
        RuntimeError when the client was built without ``trace``."""
        from repro_torch.obs import save_chrome_trace
        with self._cv:
            rec = self.obs.trace
            if rec is None:
                raise RuntimeError("tracing is off: construct the "
                                   "client with trace=True")
            events = list(rec.events)
        return save_chrome_trace(events, path)

    # -- cancellation / teardown -----------------------------------------
    def _cancel(self, session: Session) -> bool:
        with self._cv:
            out = self.pipeline.cancel(session)
            self._cv.notify_all()
        return out

    def _on_token(self, session: Session, toks: List[int]) -> None:
        handle = self._handles.get(session.req_id)
        if handle is not None:
            handle._deliver(toks, self.clock())

    def close(self) -> None:
        """Stop the pump thread (if any).  In-flight requests stay
        wherever the last tick left them."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._pump_thread is not None:
            self._pump_thread.join(timeout=2.0)
        if self._warmup_thread is not None:
            # aborts at its next round boundary (daemon: never blocks
            # interpreter exit even if a capture is in flight)
            self._warmup_thread.join(timeout=0.5)

    def __enter__(self) -> "TurboClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
