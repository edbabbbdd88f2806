"""Per-tick / per-request trace recording and the Chrome-trace exporter.

The :class:`TraceRecorder` collects two kinds of events, both
timestamped by the **pipeline's own clock**:

- **tick events** — one duration event per executed scheduler tick
  (``prefill`` / ``decode``), each on its own component track;
- **request lifecycle events** — ``enqueue``, ``admit``, ``prefill``
  (one per chunk, with cached/fresh token counts), ``splice``,
  ``decode`` (one per decode tick the request participated in),
  ``stream`` (token delivery), and exactly one terminal ``finish`` or
  ``cancel`` with a reason.

Events are plain dicts (host scalars only — recording in the tick loop
must never touch a device value).
:func:`chrome_trace` renders them in the Chrome trace-event JSON format
(`chrome://tracing` / Perfetto): ticks become duration events on
per-component threads of a "scheduler" process, requests become
per-request threads of a "requests" process with queued/prefill/decode
phase slices, instant lifecycle markers, and flow arrows connecting
enqueue -> admit -> splice -> finish.
"""
from __future__ import annotations

import json
from typing import Dict, Iterable, List, Optional, Sequence

__all__ = ["TraceRecorder", "chrome_trace", "save_chrome_trace",
           "TERMINAL_EVENTS"]

#: lifecycle event names that end a request's span (exactly one of
#: these per submitted request — asserted by tests/test_obs.py)
TERMINAL_EVENTS = ("finish", "cancel")

#: default cap on retained events; beyond it the recorder drops new
#: events and counts them in ``dropped`` (a trace, unlike a metric, is
#: unbounded in event count — long soak runs must not OOM the host)
DEFAULT_MAX_EVENTS = 1_000_000


class TraceRecorder:
    """Append-only event log.  Producers call :meth:`tick` and
    :meth:`req_event`; consumers read ``events`` (raw, for structural
    assertions) or :meth:`chrome_trace` (for Perfetto).

    No internal locking: producers record under the pipeline owner's
    lock (`TurboClient._cv` when a pump thread exists), and exports
    snapshot under the same lock.
    """

    def __init__(self, max_events: int = DEFAULT_MAX_EVENTS) -> None:
        self.events: List[dict] = []
        self.dropped = 0
        self._max_events = max_events

    # -- recording -----------------------------------------------------
    def record(self, name: str, track: str, ts: float, *,
               dur: Optional[float] = None, req: Optional[int] = None,
               trace_id: Optional[int] = None, **args) -> None:
        if len(self.events) >= self._max_events:
            self.dropped += 1
            return
        ev = {"name": name, "track": track, "ts": ts}
        if dur is not None:
            ev["dur"] = dur
        if req is not None:
            ev["req"] = req
            ev["trace_id"] = trace_id
        if args:
            ev["args"] = args
        self.events.append(ev)

    def tick(self, kind: str, t0: float, t1: float, **args) -> None:
        """One executed scheduler tick as a duration event on the
        ``kind`` component track (slice name = kind, so Perfetto labels
        read ``prefill`` / ``decode`` / ``chunk+decode``)."""
        self.record(kind, kind, t0, dur=t1 - t0, **args)

    def req_event(self, session, name: str, ts: float, **args) -> None:
        """One request-lifecycle event, keyed by the session's trace
        id (assigned at submit by the pipeline)."""
        self.record(name, "request", ts, req=session.req_id,
                    trace_id=session.trace_id, **args)

    # -- structural queries (tests / summaries) ------------------------
    def request_ids(self) -> List[int]:
        seen: Dict[int, None] = {}
        for ev in self.events:
            if ev["track"] == "request":
                seen.setdefault(ev["req"], None)
        return list(seen)

    def request_events(self, req_id: int) -> List[dict]:
        return [ev for ev in self.events
                if ev["track"] == "request" and ev["req"] == req_id]

    def request_names(self, req_id: int) -> List[str]:
        """Event-name sequence of one request's span — the unit of
        simulator-vs-wall-clock structural parity."""
        return [ev["name"] for ev in self.request_events(req_id)]

    # -- export --------------------------------------------------------
    def chrome_trace(self) -> dict:
        return chrome_trace(self.events)

    def save(self, path: str) -> dict:
        return save_chrome_trace(self.events, path)


# ---------------------------------------------------------------------------
# Chrome trace-event JSON rendering
# ---------------------------------------------------------------------------

_SCHED_PID = 1
_REQ_PID = 2
# phase slices synthesized per request from its lifecycle events
_PHASE_STARTS = {"enqueue": "queued", "admit": "prefill",
                 "splice": "decode"}


def _meta(pid: int, tid: int, what: str, name: str) -> dict:
    return {"ph": "M", "pid": pid, "tid": tid, "name": what,
            "args": {"name": name}}


def chrome_trace(events: Sequence[dict]) -> dict:
    """Render recorder events as a Chrome trace-event JSON object
    (``{"traceEvents": [...]}`` — loadable in Perfetto and
    ``chrome://tracing``).

    Layout: process 1 "scheduler" holds one thread per tick kind with
    the tick duration events; process 2 "requests" holds one thread
    per request with queued/prefill/decode phase slices, instant
    markers for every lifecycle event, and flow arrows (``s``/``t``/
    ``f``) tying enqueue -> admit -> splice -> terminal together so a
    request's full journey is one connected chain on screen.
    """
    if not events:
        return {"traceEvents": [],
                "displayTimeUnit": "ms"}
    t_zero = min(ev["ts"] for ev in events)

    def us(ts: float) -> int:
        return int(round((ts - t_zero) * 1e6))

    out: List[dict] = [
        _meta(_SCHED_PID, 0, "process_name", "scheduler"),
        _meta(_REQ_PID, 0, "process_name", "requests"),
    ]
    track_tid: Dict[str, int] = {}
    by_req: Dict[int, List[dict]] = {}

    for ev in events:
        if ev["track"] == "request":
            by_req.setdefault(ev["req"], []).append(ev)
            continue
        tid = track_tid.get(ev["track"])
        if tid is None:
            tid = len(track_tid) + 1
            track_tid[ev["track"]] = tid
            out.append(_meta(_SCHED_PID, tid, "thread_name",
                             ev["track"]))
        dur = max(int(round(ev.get("dur", 0.0) * 1e6)), 1)
        out.append({"name": ev["name"], "cat": "tick", "ph": "X",
                    "pid": _SCHED_PID, "tid": tid, "ts": us(ev["ts"]),
                    "dur": dur, "args": ev.get("args", {})})

    for req_id, evs in by_req.items():
        tid = evs[0].get("trace_id") or (req_id + 1)
        out.append(_meta(_REQ_PID, tid, "thread_name", f"req {req_id}"))
        # phase slices: each lifecycle boundary closes the previous
        # phase and opens the next; the terminal event closes the last
        open_name: Optional[str] = None
        open_ts = 0.0
        flow_done = False
        for ev in evs:
            name, ts = ev["name"], ev["ts"]
            boundary = name in _PHASE_STARTS or name in TERMINAL_EVENTS
            if boundary and open_name is not None:
                out.append({"name": open_name, "cat": "request",
                            "ph": "X", "pid": _REQ_PID, "tid": tid,
                            "ts": us(open_ts),
                            "dur": max(us(ts) - us(open_ts), 1)})
                open_name = None
            if name in _PHASE_STARTS:
                open_name, open_ts = _PHASE_STARTS[name], ts
            # instant marker for every lifecycle event
            out.append({"name": name, "cat": "request", "ph": "i",
                        "pid": _REQ_PID, "tid": tid, "ts": us(ts),
                        "s": "t", "args": ev.get("args", {})})
            # flow chain: start at enqueue, step through the phase
            # boundaries, end exactly once at the terminal event
            flow_ph = None
            if name == "enqueue":
                flow_ph = "s"
            elif name in TERMINAL_EVENTS and not flow_done:
                flow_ph, flow_done = "f", True
            elif name in ("admit", "splice"):
                flow_ph = "t"
            if flow_ph is not None:
                flow = {"name": "req-flow", "cat": "request",
                        "ph": flow_ph, "id": tid, "pid": _REQ_PID,
                        "tid": tid, "ts": us(ts)}
                if flow_ph == "f":
                    flow["bp"] = "e"
                out.append(flow)
        if open_name is not None:   # request still live at export time
            last = evs[-1]["ts"]
            out.append({"name": open_name + " (live)", "cat": "request",
                        "ph": "X", "pid": _REQ_PID, "tid": tid,
                        "ts": us(open_ts),
                        "dur": max(us(last) - us(open_ts), 1)})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def save_chrome_trace(events: Iterable[dict], path: str) -> dict:
    doc = chrome_trace(list(events))
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc
