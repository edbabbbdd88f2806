"""`ReplicaPool` — N engine replicas behind the one-client API.

The pool owns N independent replicas (each a `repro_torch.api.TurboClient`
over its own `ContinuousEngine` or `VirtualBackend`), routes every
submitted prompt through the `PrefixAffinityRouter`, and exposes the
same surface a single client does: ``submit`` / ``submit_session`` ->
:class:`PooledHandle` with ``result()`` / ``stream()`` / ``cancel()``,
plus ``pump`` / ``drain`` / ``metrics`` / ``trace_events`` /
``save_trace`` / ``close``.  Replica count is a constructor knob
(`TurboClient.from_arch(..., replicas=N)`), not an API change.

Drive modes follow the replicas' ``auto_pump``:

- **sync** replicas (the default; required for `VirtualBackend`): handle
  calls pump the owning replica on demand, and :meth:`pump` /
  :meth:`drain` interleave all replicas — virtual-clock pools tick the
  replica whose clock is earliest (the same min-clock discipline
  `core.simulator.simulate` uses), wall-clock pools rotate round-robin.
- **thread** replicas: each replica's own pump thread drives it; the
  pool adds a watchdog thread that detects pump death and tick stalls.

**Failure semantics** (see `cluster/health.py`): when a replica dies,
its QUEUED and resumable-PREFILL sessions are re-enqueued from the
prompt on siblings (reason ``failover``; prefix hits on the new replica
recover most of the lost prefill work, and since no tokens were emitted
yet, greedy generations come out identical to an unfailed run).  Its
in-flight DECODE sessions lost generated KV and surface a typed
`ReplicaFailure` from their handles instead of hanging.  Every other
handle is unaffected.

**Lock order** is strictly pool ``_cv`` -> replica ``_cv`` -> router
internal lock; prefix-cache donation hooks run under a replica lock and
take only the router lock, so the graph is acyclic.  All pool-shared
state (router, health board, ownership map) mutates under ``_cv``.
Below a replica's lock, its engine's device calls take the engine's lock
and the process's device gate (`repro_torch.runtime.graphs.DEVICE_GATE`),
which a CUDA graph capture holds alone; neither takes a pool or replica
lock, so the order stays acyclic.

Copied from the JAX package.  One change: a kill marks the victim's
client closed before it waits for the victim's lock, so a pump thread
that is ticking stops at its next tick boundary and lets the lock go,
instead of re-taking it at once until the wait times out and the
failover proceeds beside a live tick.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence

from repro_torch.core.simulator import VirtualClock
from repro_torch.obs import Observability, save_chrome_trace
from repro_torch.runtime import sanitizer
from repro_torch.runtime.session import GenerationParams, Session, SessionState

from .health import HealthBoard, ReplicaFailure
from .router import PrefixAffinityRouter, ReplicaLoad, RouteDecision

__all__ = ["PooledHandle", "ReplicaPool"]


def _clone_for_failover(s: Session) -> Session:
    """A fresh QUEUED session replaying ``s`` from its prompt: same
    req_id and generation params, no execution state.  Greedy token
    identity holds because the dead replica emitted nothing for ``s``
    (failover only covers pre-token states)."""
    clone = Session.from_params(s.req_id, list(s.prompt or []), s.params,
                                arrival_time=s.arrival_time)
    clone.stream = s.stream
    clone.eos_at = s.eos_at
    clone.prefix_group = s.prefix_group
    clone.shared_prefix_len = s.shared_prefix_len
    clone.payload = s.payload
    if s.prompt is None:           # simulator sessions carry no tokens
        clone.prompt = None
        clone.seq_len = s.seq_len
    return clone


class PooledHandle:
    """One pooled request.  Mirrors `repro_torch.api.RequestHandle`'s consumer
    surface but survives failover: the handle tracks the request's
    *current* inner handle, which the pool swaps when the owning replica
    dies with the request still pre-token.  A request lost mid-decode
    gets a `ReplicaFailure` raised from ``result()`` / ``stream()``."""

    def __init__(self, pool: "ReplicaPool", inner, replica: int) -> None:
        self._pool = pool
        self._cur = inner                   # RequestHandle on the owner
        self._replica = replica
        self._failure: Optional[ReplicaFailure] = None
        self.req_id = inner.session.req_id

    # -- queries ---------------------------------------------------------
    def _snapshot(self):
        with self._pool._cv:
            return self._cur, self._failure

    @property
    def replica(self) -> int:
        """Index of the replica currently serving this request."""
        with self._pool._cv:
            return self._replica

    @property
    def session(self) -> Session:
        return self._snapshot()[0].session

    @property
    def state(self) -> SessionState:
        return self.session.state

    @property
    def failure(self) -> Optional[ReplicaFailure]:
        return self._snapshot()[1]

    @property
    def done(self) -> bool:
        inner, fail = self._snapshot()
        return fail is not None or inner.session.is_finished

    @property
    def cancelled(self) -> bool:
        return self.session.cancelled

    def tokens(self) -> List[int]:
        return self._snapshot()[0].tokens()

    @property
    def ttft(self) -> Optional[float]:
        return self._snapshot()[0].ttft

    def inter_token_latencies(self) -> List[float]:
        return self._snapshot()[0].inter_token_latencies()

    def itl_percentile(self, q: float) -> float:
        return self._snapshot()[0].itl_percentile(q)

    # -- consumption -----------------------------------------------------
    def result(self, timeout: Optional[float] = None) -> List[int]:
        """Block until the request finishes on *some* replica; returns
        the full token list.  Raises `ReplicaFailure` if the request was
        lost mid-decode to a replica death, RuntimeError on a terminal
        engine error or timeout."""
        deadline = None if timeout is None else time.monotonic() + timeout
        while True:
            inner, fail = self._snapshot()
            if fail is not None:
                raise fail
            if inner.session.is_finished:
                with self._pool._cv:
                    if inner is not self._cur:
                        continue       # failed over; consult the new owner
                    if self._failure is not None:
                        raise self._failure
                return inner.result()
            if deadline is not None and time.monotonic() > deadline:
                raise RuntimeError(f"request {self.req_id} not finished "
                                   f"within {timeout}s")
            self._pool._advance(self, inner)

    def stream(self) -> Iterator[int]:
        """Yield generated tokens in order until the request finishes.
        On a mid-decode replica death the tokens delivered before the
        failure are yielded, then `ReplicaFailure` raises."""
        sent = 0
        while True:
            inner, fail = self._snapshot()
            toks = inner.tokens()
            while sent < len(toks):
                yield toks[sent]
                sent += 1
            if fail is not None:
                raise fail
            if inner.session.is_finished:
                with self._pool._cv:
                    if inner is not self._cur:
                        continue
                    if self._failure is not None:
                        raise self._failure
                toks = inner.tokens()           # final-tick stragglers
                while sent < len(toks):
                    yield toks[sent]
                    sent += 1
                s = inner.session
                if s.error is not None and not s.cancelled:
                    raise RuntimeError(
                        f"request {self.req_id} failed: {s.error}")
                return
            self._pool._advance(self, inner)

    def cancel(self) -> bool:
        return self._pool._cancel(self)


class ReplicaPool:
    """N `TurboClient` replicas behind prefix-affinity routing with
    health tracking and failover.  Build directly from clients, or let
    `TurboClient.from_arch(..., replicas=N)` /
    `TurboClient.simulated(..., replicas=N)` assemble one."""

    def __init__(self, clients: Sequence, *,
                 routing: str = "affinity", affinity_skew: int = 4,
                 trace: bool = False, seed: int = 0,
                 watchdog_interval: Optional[float] = None,
                 stall_deadline: float = 5.0) -> None:
        if not clients:
            raise ValueError("a ReplicaPool needs at least one replica")
        self._cv = threading.Condition(threading.RLock())
        self._replicas = list(clients)
        self._virtual = isinstance(self._replicas[0].clock, VirtualClock)
        quantum = 16
        be = self._replicas[0].backend
        if hasattr(be, "chunk_quantum"):
            quantum = be.chunk_quantum()
        self._router = PrefixAffinityRouter(
            len(self._replicas), block_size=quantum, policy=routing,
            skew=affinity_skew, seed=seed)
        self._health = HealthBoard(len(self._replicas))
        # req_id -> live PooledHandle (strong refs: failover must reach
        # handles even after the caller's loop dropped its reference;
        # pruned as requests finish)
        self._owner: Dict[int, PooledHandle] = {}
        self._ids = itertools.count()
        self._rr = 0                       # round-robin pump cursor
        self._closed = False
        self._obs = Observability.with_trace() if trace \
            else Observability()
        m = self._obs.metrics
        self._c_routed = m.counter("pool.routed")
        self._c_aff = m.counter("pool.affinity_hits")
        self._c_failover = m.counter("pool.failovers")
        self._c_resub = m.counter("pool.failover_resubmitted")
        self._c_failed = m.counter("pool.failed_sessions")
        self._g_replicas = m.gauge("pool.replicas")
        self._g_healthy = m.gauge("pool.healthy")
        self._g_replicas.set(len(self._replicas))
        self._g_healthy.set(len(self._replicas))
        # real replicas with a prefix cache feed the routing index the
        # prefixes they actually retained (hook fires under the replica
        # lock; the router is internally locked — see lock order above).
        # The backend-level seam covers lazily created caches; an
        # already-materialized cache is wired directly too.
        for i, c in enumerate(self._replicas):
            be = c.backend

            def hook(toks, _blocks, _i=i):
                self._router.donate(toks, _i)

            if hasattr(be, "on_prefix_insert"):
                be.on_prefix_insert = hook
            cache = getattr(be, "prefix_cache", None)
            if cache is not None and hasattr(cache, "on_insert"):
                cache.on_insert = hook
        # watchdog: needed whenever replicas pump themselves (thread
        # mode); sync pools surface replica errors at the pumping call
        # site instead
        threaded = any(c.auto_pump == "thread" for c in self._replicas)
        if watchdog_interval is None:
            watchdog_interval = 0.2 if threaded else None
        self._stall_deadline = stall_deadline
        self._watchdog: Optional[threading.Thread] = None
        if watchdog_interval:
            self._watchdog_interval = watchdog_interval
            self._watchdog = threading.Thread(
                target=self._watch_loop, daemon=True,
                name="replica-pool-watchdog")
            self._watchdog.start()

    # -- introspection ---------------------------------------------------
    @property
    def num_replicas(self) -> int:
        return len(self._replicas)

    def replica(self, idx: int):
        """The idx-th replica client (tests / telemetry)."""
        return self._replicas[idx]

    def healthy_replicas(self) -> List[int]:
        with self._cv:
            return self._health.healthy_indices()

    def health(self) -> List[dict]:
        with self._cv:
            return self._health.snapshot()

    @property
    def warmup_stats(self) -> List[Optional[dict]]:
        return [c.warmup_stats for c in self._replicas]

    def owner_of(self, req_id: int) -> Optional[int]:
        """Replica currently serving ``req_id`` (None once finished and
        pruned, or never seen)."""
        with self._cv:
            h = self._owner.get(req_id)
            return h._replica if h is not None else None

    def virtual_makespan(self) -> float:
        """Largest virtual-clock reading across replicas — the pool's
        wall time for a drained workload (simulated pools only)."""
        return max(float(c.clock()) for c in self._replicas)

    # -- routing / submission --------------------------------------------
    def _load(self, idx: int) -> ReplicaLoad:
        c = self._replicas[idx]
        with c._cv:
            return ReplicaLoad(depth=c.pipeline.depth(),
                               free_slots=c.backend.free_slots(),
                               free_kv=c.backend.free_kv_tokens())

    def _route(self, prompt: Sequence[int]) -> RouteDecision:
        with self._cv:
            healthy = self._health.healthy_indices()
            if not healthy:
                raise RuntimeError("no healthy replicas left in the pool")
            loads = {i: self._load(i) for i in healthy}
            return self._router.route(prompt, loads, healthy)

    def submit(self, prompt: Sequence[int],
               params: Optional[GenerationParams] = None, *,
               stream: bool = True,
               req_id: Optional[int] = None) -> PooledHandle:
        """Route and queue a generation request; same contract as
        `TurboClient.submit`, plus failover semantics on the handle."""
        params = params if params is not None else GenerationParams()
        with self._cv:
            if self._closed:
                raise RuntimeError("pool is closed")
            decision = self._route(list(prompt))
            target = self._replicas[decision.replica]
            session = Session.from_params(
                req_id if req_id is not None else next(self._ids),
                list(prompt), params, arrival_time=target.clock())
            session.stream = stream
            return self._place(session, decision)

    def submit_session(self, session: Session) -> PooledHandle:
        """Route a pre-built Session (caller owns the req_id — ids must
        be unique pool-wide, failover tracking is keyed on them)."""
        with self._cv:
            if self._closed:
                raise RuntimeError("pool is closed")
            decision = self._route(list(session.prompt or []))
            return self._place(session, decision)

    def _place(self, session: Session,
               decision: RouteDecision) -> PooledHandle:
        with self._cv:
            target = self._replicas[decision.replica]
            inner = target.submit_session(session)   # validates; may raise
            handle = PooledHandle(self, inner, decision.replica)
            self._owner[session.req_id] = handle
            self._router.record(list(session.prompt or []),
                                decision.replica)
            self._c_routed.inc()
            if decision.matched_blocks:
                self._c_aff.inc()
            trace = self._obs.trace
            if trace is not None:
                trace.req_event(session, "route", target.clock(),
                                replica=decision.replica,
                                reason=decision.reason,
                                matched_blocks=decision.matched_blocks)
            self._prune_owners()
            if sanitizer.enabled():
                self._check_ownership()
            self._cv.notify_all()
        return handle

    def _prune_owners(self) -> None:
        with self._cv:
            self._owner = {
                rid: h for rid, h in self._owner.items()
                if h._failure is None and not h._cur.session.is_finished}

    # -- pumping ----------------------------------------------------------
    def _thread_mode(self) -> bool:
        return any(c.auto_pump == "thread" for c in self._replicas)

    def _busy(self) -> List[int]:
        return [i for i in self._health.healthy_indices()
                if not self._replicas[i].pipeline.idle()]

    def pump(self, max_ticks: Optional[int] = None) -> int:
        """Drive every healthy replica until the pool is idle (or
        ``max_ticks`` total).  Virtual pools tick the earliest-clock
        replica (min-clock discipline); wall-clock sync pools rotate;
        thread pools just wait for the replicas' own pumps."""
        ticks = 0
        while max_ticks is None or ticks < max_ticks:
            with self._cv:
                busy = self._busy()
                if not busy:
                    break
                if self._thread_mode():
                    self._cv.wait(0.05)
                    continue
                if self._virtual:
                    idx = min(busy,
                              key=lambda i: self._replicas[i].clock())
                else:
                    idx = busy[self._rr % len(busy)]
                    self._rr += 1
                try:
                    ticks += self._replicas[idx].pump(max_ticks=1)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except BaseException as exc:
                    if len(self._health.healthy_indices()) <= 1:
                        raise
                    self._fail_replica(
                        idx, f"{type(exc).__name__}: {exc}")
        return ticks

    def drain(self) -> List[Session]:
        """Pump everything to completion; returns the sessions finished
        across all replicas so far (failover-superseded and
        decode-failed sessions excluded — each request appears at most
        once)."""
        self.pump()
        with self._cv:
            out: List[Session] = []
            for i, c in enumerate(self._replicas):
                got = c._cv.acquire(timeout=0.5)
                try:
                    out.extend(c.pipeline.finished)
                finally:
                    if got:
                        c._cv.release()
            return out

    def _advance(self, handle: PooledHandle, inner) -> None:
        """One step of progress on behalf of a blocked handle: pump (or
        wait on) the owning replica; a replica error here triggers
        failover instead of surfacing on this unrelated caller."""
        try:
            inner._client._advance(inner)
        except (KeyboardInterrupt, SystemExit):
            raise
        except BaseException as exc:
            self._absorb(handle, inner, exc)

    def _absorb(self, handle: PooledHandle, inner,
                exc: BaseException) -> None:
        with self._cv:
            if handle._cur is not inner or handle._failure is not None:
                return       # already failed over / failed: loop re-reads
            idx = handle._replica
            if not self._health.healthy(idx):
                return       # death already being handled
            if len(self._health.healthy_indices()) <= 1:
                raise exc    # nowhere to fail over: surface the root cause
            self._fail_replica(idx, f"{type(exc).__name__}: {exc}")

    # -- health / failover ------------------------------------------------
    def kill_replica(self, idx: int, reason: str = "killed") -> None:
        """Cooperatively mark replica ``idx`` dead and fail its work over
        (tests, demos, operator action)."""
        with self._cv:
            self._fail_replica(idx, reason)

    def _tick_count(self, c) -> int:
        st = c.pipeline.stats
        return (st.prefill_ticks + st.decode_ticks + st.chunk_ticks +
                st.cancelled)

    def _watch_loop(self) -> None:
        while True:
            with self._cv:
                if self._closed:
                    return
                for i in self._health.healthy_indices():
                    c = self._replicas[i]
                    # racy reads by design: taking the replica lock here
                    # could block the watchdog behind the very stall it
                    # exists to detect
                    if c._pump_error is not None:
                        self._fail_replica(
                            i, f"pump thread died: {c._pump_error!r}")
                        continue
                    stalled = self._health.beat(
                        i, self._tick_count(c), not c.pipeline.idle())
                    if stalled > self._stall_deadline:
                        self._fail_replica(
                            i, f"tick stalled for {stalled:.1f}s "
                               f"(deadline {self._stall_deadline}s)")
            time.sleep(self._watchdog_interval)

    def _fail_replica(self, idx: int, reason: str) -> None:
        """Mark ``idx`` dead and redistribute its work.  Callers hold
        ``_cv`` (RLock: re-entry is free).  Best-effort on the dead
        replica's own state — a wedged replica may not give up its lock,
        in which case its host-side bookkeeping is abandoned along with
        its device state."""
        with self._cv:
            if not self._health.healthy(idx):
                return
            self._health.mark_dead(idx, reason)
            self._router.purge(idx)
            self._c_failover.inc()
            self._g_healthy.set(len(self._health.healthy_indices()))
            dead = self._replicas[idx]
            # closed first: a live pump thread returns at its next loop
            # top and leaves the lock to this wait
            dead._closed = True
            got = dead._cv.acquire(timeout=0.5)
            try:
                if got:
                    dead._cv.notify_all()
                p = dead.pipeline
                queued = list(p.queue)
                prefills = list(p.chunking)
                decodes = [s for s in p.live
                           if s.state is SessionState.DECODE]
                for s in queued + prefills + decodes:
                    try:
                        p.cancel(s)
                    except Exception:
                        pass     # wedged backend: device cleanup is lost
                    # keep pool-wide finished lists disjoint: the request
                    # either finishes on a sibling or fails on its handle
                    if s in p.finished:
                        p.finished.remove(s)
            finally:
                if got:
                    dead._cv.release()
            trace = self._obs.trace
            for s in queued + prefills:
                handle = self._owner.get(s.req_id)
                clone = _clone_for_failover(s)
                try:
                    decision = self._route(list(clone.prompt or []))
                except RuntimeError:
                    fail = ReplicaFailure(
                        idx, s.req_id,
                        f"{reason}; no healthy replica to fail over to")
                    if handle is not None:
                        handle._failure = fail
                    self._c_failed.inc()
                    continue
                target = self._replicas[decision.replica]
                inner = target.submit_session(clone)
                self._router.record(list(clone.prompt or []),
                                    decision.replica)
                self._c_routed.inc()
                self._c_resub.inc()
                if handle is not None:
                    handle._cur = inner
                    handle._replica = decision.replica
                if trace is not None:
                    trace.req_event(clone, "failover", target.clock(),
                                    src=idx, dst=decision.replica,
                                    was=s.state.value, reason=reason)
                    trace.req_event(clone, "route", target.clock(),
                                    replica=decision.replica,
                                    reason="failover",
                                    matched_blocks=decision.matched_blocks)
            for s in decodes:
                handle = self._owner.get(s.req_id)
                fail = ReplicaFailure(idx, s.req_id, reason)
                if handle is not None:
                    handle._failure = fail
                self._c_failed.inc()
                if trace is not None:
                    trace.req_event(s, "failover",
                                    self._pool_clock(), src=idx, dst=-1,
                                    was="decode", reason=reason)
            self._prune_owners()
            if sanitizer.enabled():
                self._check_ownership()
            self._cv.notify_all()

    def _pool_clock(self) -> float:
        healthy = self._health.healthy_indices()
        c = self._replicas[healthy[0] if healthy else 0]
        return float(c.clock())

    # -- cancellation -----------------------------------------------------
    def _cancel(self, handle: PooledHandle) -> bool:
        with self._cv:
            if handle._failure is not None:
                return False
            inner = handle._cur
            out = inner.cancel()
            self._owner.pop(handle.req_id, None)
            self._cv.notify_all()
        return out

    # -- sanitizer hook ---------------------------------------------------
    def _check_ownership(self) -> None:
        """Pool-level invariant: every live pooled session is owned by
        exactly one healthy replica.  Snapshots each replica under its
        lock (skipping wedged dead replicas whose lock never frees)."""
        with self._cv:
            owned: Dict[int, List[int]] = {}
            for i, c in enumerate(self._replicas):
                got = c._cv.acquire(timeout=0.05)
                if not got and not self._health.healthy(i):
                    continue         # wedged corpse: nothing to verify
                try:
                    p = c.pipeline
                    owned[i] = [
                        s.req_id for s in
                        list(p.queue) + list(p.chunking) + list(p.live)
                        if not s.is_finished]
                finally:
                    if got:
                        c._cv.release()
            sanitizer.check_pool_ownership(
                owned, set(self._health.healthy_indices()))

    # -- observability ----------------------------------------------------
    def metrics(self) -> dict:
        """Pool counters/gauges merged with every replica's snapshot,
        the latter re-keyed under ``replica.<i>.*``."""
        with self._cv:
            out: dict = {"counters": {}, "gauges": {}, "histograms": {}}
            for kind, vals in self._obs.metrics.snapshot().items():
                out.setdefault(kind, {}).update(vals)
            for i, c in enumerate(self._replicas):
                got = c._cv.acquire(timeout=0.2)
                try:
                    snap = c.obs.metrics.snapshot()
                finally:
                    if got:
                        c._cv.release()
                for kind, vals in snap.items():
                    dst = out.setdefault(kind, {})
                    for name, v in vals.items():
                        dst[f"replica.{i}.{name}"] = v
            return out

    def trace_events(self) -> List[dict]:
        """Pool route/failover events merged with every replica's trace,
        each replica event tagged ``replica=<i>``, sorted by timestamp.
        [] when the pool and its replicas were built without tracing."""
        with self._cv:
            events: List[dict] = []
            rec = self._obs.trace
            if rec is not None:
                events.extend(dict(ev) for ev in rec.events)
            for i, c in enumerate(self._replicas):
                got = c._cv.acquire(timeout=0.2)
                try:
                    rrec = c.obs.trace
                    revs = list(rrec.events) if rrec is not None else []
                finally:
                    if got:
                        c._cv.release()
                for ev in revs:
                    tagged = dict(ev)
                    args = dict(tagged.get("args", {}))
                    args["replica"] = i
                    tagged["args"] = args
                    events.append(tagged)
            events.sort(key=lambda ev: ev["ts"])
            return events

    def save_trace(self, path: str) -> dict:
        """Merged Chrome trace-event export across the pool."""
        events = self.trace_events()
        if not events:
            raise RuntimeError("tracing is off: construct the pool and "
                               "its replicas with trace=True")
        return save_chrome_trace(events, path)

    # -- teardown ---------------------------------------------------------
    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        for c in self._replicas:
            c.close()
        if self._watchdog is not None:
            self._watchdog.join(timeout=2.0)

    def __enter__(self) -> "ReplicaPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
