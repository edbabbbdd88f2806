"""Iteration-level serving event loop over a pipeline backend.

TurboTransformers' original framework (paper §5) batches at *request*
granularity: plan over the queue, execute every planned batch, repeat.
This module generalizes that loop to *iteration* granularity (continuous
batching, cf. the LLM-serving survey's iteration-level scheduling): each
:meth:`ServingPipeline.tick` either

  1. admits queued sessions as a **prefill** batch (planned by the paper's
     DP scheduler over the admissible prefix of the queue), or
  2. advances every in-flight **decode** session by one token.

One-shot (classification) sessions finish at prefill, which makes the
request-granularity system of the paper a special case of this loop.

This is the port's copy of the JAX package's pipeline, cut to what the
port serves: prefill admission planned by the configured policy (the
paper's DP scheduler or a baseline) and decode ticks.  A backend that
packs (``supports_packed_prefill``) serves each admission group as one
flat dispatch, and the two-phase veto prices it so
(``CostModel.packed_prefill_latency``).  Chunked prefill, and with it the
pack turn that mixes chunks into packs, is not ported yet.

The pipeline is execution-agnostic: a :class:`PipelineBackend` runs the
work.  `repro_torch.runtime.engine.ContinuousEngine` backs it with a
live model and wall clock.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import CostModel
from repro_torch.core.scheduler import (BatchPlan, dp_schedule,
                                       naive_schedule, nobatch_schedule)
from repro_torch.obs import Observability
from repro_torch.runtime.session import Session, SessionState

# NOTE: repro_torch.runtime.sanitizer is imported lazily (it subclasses
# kv_cache.BlockTableManager, and kv_cache -> core.cost_model ->
# core/__init__ -> this module would make the import circular).


def plan_for_policy(policy: str, lengths: Sequence[int], cost: CostModel,
                    max_batch_size: Optional[int]) -> BatchPlan:
    if policy == "nobatch":
        return nobatch_schedule(lengths, cost)
    if policy == "naive":
        return naive_schedule(lengths, cost, max_batch_size)
    if policy == "dp":
        return dp_schedule(lengths, cost, max_batch_size)
    raise ValueError(f"unknown policy {policy!r}")


class PipelineBackend:
    """Executes the work the pipeline schedules.

    Implementations mutate the sessions' state machines: ``prefill_batch``
    must move every session to DECODE (or FINISHED for one-shot work);
    ``decode_tick`` must append tokens and finish sessions that hit EOS or
    their budget, releasing their KV immediately.
    """

    def prefill_batch(self, sessions: List[Session],
                      padded_len: int) -> None:
        raise NotImplementedError

    def decode_tick(self, sessions: List[Session]) -> None:
        raise NotImplementedError

    def supports_packed_prefill(self) -> bool:
        """Whether ``prefill_batch`` serves an admission group as ONE
        packed dispatch over the flat tokens (so the admission veto must
        price it that way)."""
        return False

    def free_slots(self) -> Optional[int]:
        """Decode slots available for new admissions; None = unbounded."""
        return None

    def free_kv_tokens(self) -> Optional[int]:
        """KV capacity (in tokens) available for new admissions; None =
        unbounded.  Paged backends report free *blocks* x block size so
        admission is vetoed when a prefill cannot get blocks, independent
        of how many decode slots are open.  Prefix-sharing backends add
        the capacity of cached blocks nobody references (reclaimable by
        LRU eviction at admission) — so a full-looking pool still admits
        when its contents are merely warm, not live."""
        return None

    def kv_demand(self, session: Session) -> int:
        """Tokens of KV capacity admitting ``session`` will consume over
        its lifetime (block-rounded by paged backends).  Prefix-sharing
        backends discount prompt blocks the session would share with
        already-pinned cache entries — concurrent same-prefix sessions
        then fit together where their summed raw lengths would not,
        which is how cache hits turn into higher admission rates.  The
        discount must never count capacity ``free_kv_tokens`` already
        reported reclaimable, or the planner would double-spend it."""
        return session.total_len

    def validate(self, session: Session) -> None:
        """Raise ValueError for a session this backend can never serve
        (checked at submit time, before any state transition)."""

    # -- invariant checking (optional capability) ------------------------
    def check_invariants(self, pipeline: "ServingPipeline") -> None:
        """Sanitizer hook, called at every tick boundary when the
        sanitizer is enabled (see `repro_torch.runtime.sanitizer`).  Backends
        with internal accounting (block pools, decode slots, reservation
        ledgers) should cross-check it against the pipeline's view of the
        live set and raise `SanitizerError` on divergence.  Default:
        nothing to check."""

    # -- cancellation (optional capability) ------------------------------
    def cancel_session(self, session: Session) -> None:
        """Tear down a mid-DECODE session immediately: free its KV
        (blocks, slab region, reservations), release its decode slot,
        and neutralize any device-resident row.  QUEUED cancellation
        needs no backend work; only backends with a decode phase must
        implement this."""
        raise NotImplementedError(
            f"{type(self).__name__} does not support mid-decode "
            "cancellation")


@dataclass
class PipelineConfig:
    policy: str = "dp"                  # nobatch | naive | dp
    strategy: str = "hungry"            # hungry | lazy
    max_batch_size: int = 20
    lazy_timeout: float = 5e-3          # lazy: flush after this wait
    slo_latency: Optional[float] = None  # start early if at risk (§5)
    # iteration-level admission:
    #   continuous — new prefills may join while decodes are in flight
    #   drain      — batch-at-a-time: admit only when nothing is in
    #                flight (the paper's request-granularity baseline)
    admission: str = "continuous"
    # two-phase regime: admit a prefill mid-decode only if it stalls the
    # decode batch by at most this many decode ticks
    prefill_stall_factor: float = 32.0
    # always admit while the decode batch is below this size (prefills
    # are cheap to amortize into an underfull decode batch)
    min_decode_batch: int = 1
    # packed prefill: a backend that can pack (paged KV) dispatches each
    # admission group as ONE flat segment-id prefill
    packed_prefill: bool = True


@dataclass
class PipelineStats:
    """Scheduler counters.  Since the observability refactor the
    pipeline's single counter system is its `repro_torch.obs.MetricsRegistry`
    (``pipeline.<field>`` counters); :attr:`ServingPipeline.stats` is a
    view built from those counters on access."""
    prefill_ticks: int = 0
    decode_ticks: int = 0
    prefill_batches: int = 0
    admitted: int = 0
    deferred_prefills: int = 0          # two-phase regime said "keep decoding"
    cancelled: int = 0                  # sessions torn down by cancel()


#: PipelineStats fields, in declaration order — each is mirrored by the
#: registry counter ``pipeline.<field>``
STAT_FIELDS = ("prefill_ticks", "decode_ticks", "prefill_batches",
               "admitted", "deferred_prefills", "cancelled")

#: admission-veto reasons counted per tick under ``pipeline.veto.<r>``
VETO_REASONS = ("stall", "capacity", "trigger", "drain")


class ServingPipeline:
    """The shared scheduler loop.  Owns the admission queue and the set of
    in-flight sessions; delegates execution to a backend."""

    def __init__(self, backend: PipelineBackend, cost: CostModel,
                 config: Optional[PipelineConfig] = None,
                 clock: Callable[[], float] = time.monotonic,
                 obs: Optional[Observability] = None) -> None:
        self.backend = backend
        self.cost = cost
        self.config = config if config is not None else PipelineConfig()
        self.clock = clock
        self.queue: List[Session] = []          # QUEUED, arrival order
        self.live: List[Session] = []           # DECODE in flight
        self.finished: List[Session] = []
        # observability: the registry is the pipeline's ONE counter
        # system (``stats`` is a view over it); the optional trace
        # recorder gets a lifecycle span per request and a duration
        # event per executed tick, timestamped by self.clock so wall
        # and virtual clocks yield structurally identical traces.
        # Recording touches host scalars only — never a device value.
        self.obs = obs if obs is not None else Observability()
        m = self.obs.metrics
        self._stat = {f: m.counter("pipeline." + f) for f in STAT_FIELDS}
        self._veto = {r: m.counter("pipeline.veto." + r)
                      for r in VETO_REASONS}
        self._c_tokens = m.counter("pipeline.tokens_delivered")
        self._hist_tick = m.histogram("pipeline.tick_seconds")
        self._hist_itl = m.histogram("pipeline.itl_seconds")
        self._hist_ttft = m.histogram("pipeline.ttft_seconds")
        self._hist_qwait = m.histogram("pipeline.queue_wait_seconds")
        self._g_queue = m.gauge("pipeline.queue_depth")
        self._g_batch = m.gauge("pipeline.decode_batch")
        self._trace_ids = itertools.count(1)
        self._last_compile_count = 0
        # did the last tick execute work (prefill/decode)?  The
        # no-progress guard in drain() reads this instead of counters,
        # so it keeps working even under a disabled registry.
        self._tick_worked = False
        # token-emission callback (session, fresh_tokens): invoked after
        # every tick for each session whose host-visible generation grew
        # — the `repro_torch.api` streaming handles hang off this.  Real-engine
        # sessions publish incrementally only when `session.stream` is
        # set; otherwise the whole generation arrives in one call at
        # finish time.
        self.on_token: Optional[
            Callable[[Session, List[int]], None]] = None
        # req-id composition of every executed prefill batch, in dispatch
        # order — lets tests assert real-vs-virtual scheduling equivalence
        self.batch_log: List[Tuple[int, ...]] = []
        # sanitizer state: per-session `streamed` high-water marks,
        # checked monotonic at every tick boundary (TURBO_SANITIZE /
        # pytest default — see repro_torch.runtime.sanitizer)
        from repro_torch.runtime import sanitizer
        self._sanitize = sanitizer.enabled()
        self._stream_hwm: Dict[int, int] = {}

    @property
    def stats(self) -> PipelineStats:
        """Compat view over the registry counters (all zeros under a
        disabled registry — recording is a no-op there)."""
        return PipelineStats(**{f: c.value
                                for f, c in self._stat.items()})

    # ------------------------------------------------------------------
    # Admission control
    # ------------------------------------------------------------------
    def submit(self, session: Session) -> None:
        if session.state is not SessionState.QUEUED:
            raise ValueError(f"session {session.req_id} already "
                             f"{session.state}")
        self.backend.validate(session)
        if session.trace_id is None:
            session.trace_id = next(self._trace_ids)
        self.queue.append(session)
        trace = self.obs.trace
        if trace is not None:
            trace.req_event(session, "enqueue", session.arrival_time,
                            seq_len=session.seq_len,
                            max_new_tokens=session.max_new_tokens)

    def cancel(self, session: Session) -> bool:
        """Tear down ``session`` in whatever state it is in — QUEUED
        (drop from the admission queue) or DECODE (free KV / slot via the
        backend).
        Tokens generated before the cancel stay on the session as a
        partial result.  Returns False when the session is already
        FINISHED (nothing to do), True when it was cancelled here."""
        if session.is_finished:
            return False
        was = session.state.value
        if session in self.queue:
            self.queue.remove(session)
        elif session in self.live:
            if session.state is SessionState.DECODE:
                self.backend.cancel_session(session)
            self.live.remove(session)
        else:
            raise ValueError(f"session {session.req_id} is not owned by "
                             "this pipeline")
        session.cancel(self.clock())
        # same telemetry trim as the tick path: a row that finished on
        # device between host syncs accumulated timestamps for ticks
        # that emitted it nothing
        del session.token_times[len(session.generated):]
        self._stat["cancelled"].inc()
        self.finished.append(session)
        self._deliver_tokens([session])
        trace = self.obs.trace
        if trace is not None:
            trace.req_event(session, "cancel", session.finish_time,
                            was=was, generated=len(session.generated))
        self._stream_hwm.pop(session.req_id, None)
        return True

    def _decoding(self) -> List[Session]:
        return [s for s in self.live if s.state is SessionState.DECODE]

    def _trigger(self) -> bool:
        """Hungry/lazy/SLO flush trigger (paper §5), over the queue."""
        cfg = self.config
        if cfg.strategy == "hungry":
            return True
        if len(self.queue) >= cfg.max_batch_size:
            return True
        oldest = self.queue[0]
        now = self.clock()
        if now - oldest.arrival_time >= cfg.lazy_timeout:
            return True
        if cfg.slo_latency is not None:
            est = self.cost.latency(oldest.seq_len, len(self.queue))
            if (now - oldest.arrival_time) + est > cfg.slo_latency / 2:
                return True
        return False

    def _admissible(self) -> List[Session]:
        """Oldest queued sessions that fit the backend's free capacity:
        decode slots AND free KV (block) budget.  The prefix stops at the
        first session whose KV demand does not fit, preserving FIFO order
        — the DP planner only ever sees prefills that can get blocks."""
        free = self.backend.free_slots()
        cand = self.queue if free is None else self.queue[:free]
        kv_free = self.backend.free_kv_tokens()
        if kv_free is None:
            return cand
        out: List[Session] = []
        charged = 0
        for s in cand:
            demand = self.backend.kv_demand(s)
            if charged + demand > kv_free:
                break
            charged += demand
            out.append(s)
        return out

    def _decode_tick_cost(self, decoding: List[Session]) -> float:
        ctx = sum(s.seq_len + s.tokens_emitted for s in decoding) \
            / len(decoding)
        return self.cost.decode_latency(len(decoding), int(ctx))

    def _prefill_worthwhile(self, batch: List[Session]) -> bool:
        """Two-phase cost regime: is dispatching THIS prefill batch worth
        stalling the in-flight decode batch?  Charged against the batch
        the planner actually composed — not the first-k queue estimate —
        so the stall bound the veto enforces is the stall the dispatch
        imposes."""
        decoding = self._decoding()
        if not decoding or len(decoding) < self.config.min_decode_batch:
            return True
        if self._pack_enabled():
            # a packed admission executes as ONE flat dispatch over the
            # group's total tokens: price the stall it actually imposes
            stall = self.cost.packed_prefill_latency(
                sum(s.seq_len for s in batch), len(batch))
        else:
            stall = self.cost.prefill_latency(
                max(s.seq_len for s in batch), len(batch))
        return stall <= self.config.prefill_stall_factor * \
            self._decode_tick_cost(decoding)

    def _pack_enabled(self) -> bool:
        return bool(self.config.packed_prefill and
                    self.backend.supports_packed_prefill())

    def _admission_decision(self, record: bool = False):
        """What an admission round would do right now:
        ``None`` (nothing to admit), ``"defer"`` (two-phase veto),
        or ``("plan", cand, plan)`` (dispatch
        ``plan``'s batches over ``cand``; plan is None when the idle
        path skipped the veto and the dispatcher should plan itself).
        Pure unless ``record`` (tick-internal): real scheduling rounds
        count each non-admitting outcome with a queued request waiting
        under ``pipeline.veto.<reason>`` — so ``should_admit`` and
        ``tick`` cannot disagree, and "why is the queue not draining"
        is answerable from the registry."""
        if not self.queue:
            return None
        if self.config.admission == "drain" and self.live:
            if record:
                self._veto["drain"].inc()
            return None
        cand = self._admissible()
        if not cand:
            if record:
                self._veto["capacity"].inc()
            return None
        if not self._trigger():
            if record:
                self._veto["trigger"].inc()
            return None
        decoding = self._decoding()
        if not decoding or len(decoding) < self.config.min_decode_batch:
            return ("plan", cand, None)
        plan = plan_for_policy(
            self.config.policy, [s.seq_len for s in cand], self.cost,
            self.config.max_batch_size)
        if not self._prefill_worthwhile(
                [cand[i] for i in plan.batches[0]]):
            if record:
                self._veto["stall"].inc()
            return "defer"
        return ("plan", cand, plan)

    def should_admit(self, record: bool = False) -> bool:
        """Pure query unless ``record`` (tick-internal): only real
        scheduling decisions count a deferral in the stats."""
        decision = self._admission_decision(record=record)
        if decision == "defer":
            if record:
                self._stat["deferred_prefills"].inc()
            return False
        return decision is not None

    # ------------------------------------------------------------------
    # The loop
    # ------------------------------------------------------------------
    def tick(self) -> List[Session]:
        """One scheduler iteration: a prefill admission round OR one
        decode step over every in-flight sequence.  Returns the sessions
        that finished during this tick."""
        done: List[Session] = []
        self._tick_worked = False
        t0 = self.clock()
        kind: Optional[str] = None
        decoding = self._decoding()
        decision = self._admission_decision(record=True)
        if decision == "defer":
            self._stat["deferred_prefills"].inc()
            decision = None
        if decision is not None:
            _, cand, plan = decision
            self._dispatch_prefills(cand, done, plan)
            kind = "prefill"
        elif decoding:
            self.backend.decode_tick(decoding)
            now = self.clock()
            for s in decoding:
                s.token_times.append(now)
            self._observe_decode(decoding, now)
            self._stat["decode_ticks"].inc()
            kind = "decode"
        # unified sweep: collect everything that finished this tick —
        # decode completions AND sessions the backend's sync marked
        # finished during a prefill tick
        done.extend(s for s in self.live if s.is_finished)
        self.live = [s for s in self.live if not s.is_finished]
        for s in done:
            # keep ITL telemetry to the tokens actually generated
            del s.token_times[len(s.generated):]
        self.finished.extend(done)
        self._deliver_tokens(done)
        self._emit_finished(done)
        self._tick_boundary(kind, t0, len(decoding))
        if self._sanitize:
            self._check_invariants(done)
        return done

    # ------------------------------------------------------------------
    # Observability recording (host scalars only — see repro_torch.obs)
    # ------------------------------------------------------------------
    def _observe_decode(self, decoding: List[Session],
                        now: float) -> None:
        """Per-decode-tick telemetry: inter-token-latency samples from
        the just-appended emission timestamps, plus a per-request
        ``decode`` span event when tracing."""
        h = self._hist_itl
        for s in decoding:
            tt = s.token_times
            if len(tt) >= 2:
                h.observe(tt[-1] - tt[-2])
        trace = self.obs.trace
        if trace is not None:
            b = len(decoding)
            for s in decoding:
                trace.req_event(s, "decode", now, batch=b)

    def _emit_finished(self, done: List[Session]) -> None:
        """Exactly one terminal span event per finished session (the
        cancel() path emits its own ``cancel`` terminal instead)."""
        trace = self.obs.trace
        if trace is None:
            return
        for s in done:
            trace.req_event(s, "finish", s.finish_time,
                            reason=self._finish_reason(s),
                            generated=len(s.generated))

    @staticmethod
    def _finish_reason(s: Session) -> str:
        if s.cancelled:
            return "cancel"
        if s.error is not None:
            return "error"
        if s.is_one_shot:
            return "oneshot"
        if len(s.generated) >= s.max_new_tokens:
            return "budget"
        return "stop"            # eos / stop id

    def _tick_boundary(self, kind: Optional[str], t0: float,
                       decode_batch: int) -> None:
        """Tick-boundary recording: scheduler gauges, the tick-duration
        histogram, backend gauge sampling (duck-typed
        ``observe_metrics`` — host ints only, never a device read), and
        the tick's trace slice.  ``kind`` is None when the tick
        executed nothing (empty pipeline / un-triggered lazy queue)."""
        m = self.obs.metrics
        self._g_queue.set(len(self.queue))
        self._g_batch.set(len(self.live))
        observe = getattr(self.backend, "observe_metrics", None)
        if observe is not None:
            observe(m)
        if kind is None:
            return
        self._tick_worked = True
        t1 = self.clock()
        self._hist_tick.observe(t1 - t0)
        trace = self.obs.trace
        if trace is not None:
            trace.tick(kind, t0, t1, batch=decode_batch,
                       queue=len(self.queue), live=len(self.live))
            cc = m.gauge("engine.compile_count").value
            if cc > self._last_compile_count:
                trace.record("compile", "engine", t1,
                             n=cc - self._last_compile_count)
            self._last_compile_count = cc

    def _record_splice(self, s: Session) -> None:
        """A session just spliced into decode: its seed token exists, so
        TTFT is known — observe it and emit the ``splice`` span event at
        the first-token timestamp."""
        ft = s.first_token_time
        self._hist_ttft.observe(ft - s.arrival_time)
        trace = self.obs.trace
        if trace is not None:
            trace.req_event(s, "splice", ft, cached=s.cached_tokens)

    def _check_invariants(self, done: List[Session]) -> None:
        """Tick-boundary sanitizer checks: monotonic `streamed` delivery
        high-water marks (a regression would re-deliver tokens; an
        overshoot would deliver tokens that do not exist), then the
        backend's own accounting cross-check (block conservation,
        slot<->session bijection, reservation balance — see
        `ContinuousEngine.check_invariants`)."""
        from repro_torch.runtime.sanitizer import SanitizerError
        for s in self.live + done:
            prev = self._stream_hwm.get(s.req_id, 0)
            if s.streamed < prev:
                raise SanitizerError(
                    f"session {s.req_id} streamed high-water regressed "
                    f"{prev} -> {s.streamed}: tokens would be delivered "
                    "twice")
            if s.streamed > len(s.generated):
                raise SanitizerError(
                    f"session {s.req_id} streamed {s.streamed} of only "
                    f"{len(s.generated)} generated tokens")
            self._stream_hwm[s.req_id] = s.streamed
        for s in done:
            self._stream_hwm.pop(s.req_id, None)
        # Duck-typed: test doubles implement the backend protocol
        # structurally and may predate this hook.
        check = getattr(self.backend, "check_invariants", None)
        if check is not None:
            check(self)

    def _deliver_tokens(self, done: List[Session]) -> None:
        """Hand every freshly host-visible token to the emission
        callback, in generation order.  ``session.streamed`` is the
        delivery high-water mark, so a session is never handed the same
        token twice regardless of how the backend batches its host
        syncs."""
        if self.on_token is None:
            return
        trace = self.obs.trace
        now = self.clock() if trace is not None else 0.0
        for s in self.live + done:
            fresh = s.generated[s.streamed:]
            if fresh:
                s.streamed = len(s.generated)
                self._c_tokens.inc(len(fresh))
                if trace is not None:
                    trace.req_event(s, "stream", now, n=len(fresh),
                                    total=s.streamed)
                self.on_token(s, list(fresh))

    def _dispatch_prefills(self, cand: List[Session], done: List[Session],
                           plan: Optional[BatchPlan] = None) -> None:
        """The classic admission round: plan over ``cand`` (reusing the
        plan the veto already priced, when there is one), dispatch."""
        if plan is None:
            plan = plan_for_policy(self.config.policy,
                                   [s.seq_len for s in cand], self.cost,
                                   self.config.max_batch_size)
        batches = plan.batches
        # with decodes in flight, dispatch ONE batch per tick: the
        # two-phase veto bounded the stall of a single prefill pass,
        # and the rest of the queue re-plans next tick, interleaved
        # with decode progress (idle pipelines run the whole plan —
        # the paper's batch-at-a-time behavior)
        if self._decoding():
            batches = batches[:1]
        trace = self.obs.trace
        admitted = set()
        for batch_idx in batches:
            batch = [cand[i] for i in batch_idx]
            padded = max(s.seq_len for s in batch)
            now = self.clock()
            for s in batch:
                s.start_prefill(now, batch_size=len(batch),
                                padded_len=padded)
                self._hist_qwait.observe(now - s.arrival_time)
                if trace is not None:
                    trace.req_event(s, "admit", now, batch=len(batch),
                                    padded=padded)
            try:
                self.backend.prefill_batch(batch, padded)
            except Exception as exc:
                # fail this batch terminally and flush the tick's
                # bookkeeping so neither the failed batch nor the
                # already-admitted earlier batches wedge the queue
                for s in batch:
                    if not s.is_finished:
                        s.error = str(exc)
                        s.finish(self.clock())
                admitted.update(id(s) for s in batch)
                done.extend(batch)
                self.queue = [s for s in self.queue
                              if id(s) not in admitted]
                self.finished.extend(done)
                # the raise skips tick()'s sweep — terminals emit here
                self._emit_finished(done)
                raise
            self.batch_log.append(tuple(s.req_id for s in batch))
            self._stat["prefill_batches"].inc()
            now = self.clock()
            for s in batch:
                admitted.add(id(s))
                if trace is not None:
                    trace.req_event(s, "prefill", now, upto=s.seq_len,
                                    cached=s.cached_tokens,
                                    fresh=s.seq_len - s.cached_tokens)
                if s.is_finished:
                    done.append(s)
                elif s.state is SessionState.DECODE:
                    self._record_splice(s)
                    self.live.append(s)
                else:
                    raise RuntimeError(
                        f"backend left session {s.req_id} in "
                        f"{s.state} after prefill")
        self.queue = [s for s in self.queue if id(s) not in admitted]
        self._stat["prefill_ticks"].inc()
        self._stat["admitted"].inc(len(admitted))

    def idle(self) -> bool:
        return not self.queue and not self.live

    def depth(self) -> int:
        """Live-session count — queued + decoding."""
        return len(self.queue) + len(self.live)

    def drain(self) -> List[Session]:
        """Tick until nothing is queued or in flight.  Breaks instead of
        spinning when the pipeline can make no further progress: if a
        tick executed nothing (no prefill / decode, nothing
        finished) and the clock did not move, the pipeline state is
        bit-identical to before the tick — every future tick would
        repeat it, so waiting cannot help.  Under a wall clock a lazy
        pipeline's trigger eventually fires because the clock DOES move
        between ticks; under a virtual clock (which only advances on
        executed work) this is the guard that keeps a never-triggered
        lazy queue from spinning forever."""
        out: List[Session] = []
        while not self.idle():
            t_before = self.clock()
            finished = self.tick()
            out.extend(finished)
            if finished:
                continue
            # _tick_worked (not a registry counter, which a disabled
            # registry pins at zero) says whether the tick executed any
            # prefill / decode work
            if not self._tick_worked and (
                    self.clock() == t_before
                    or self.config.strategy == "hungry"):
                # nothing executed; and either the clock is frozen (so
                # nothing ever will) or the strategy is hungry (whose
                # admission decision is time-independent — waiting on
                # the wall clock cannot unblock it either)
                break
        return out
