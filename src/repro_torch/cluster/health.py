"""Replica health model: states, heartbeats, and the typed failure.

A replica is ``healthy`` until the pool marks it ``dead`` — there is no
recovery transition (a dead engine's device state is unrecoverable; a
fresh replica is a new pool).  Death comes from three detectors, all
owned by the pool:

- **pump death** — the replica's pump thread raised (`_pump_error` set);
- **tick stall** — the replica has pending work but its tick counters
  have not moved past the watchdog deadline (wedged device call);
- **cooperative kill** — `ReplicaPool.kill_replica` (tests, demos,
  operator action).

On death the pool fails QUEUED and resumable-PREFILL sessions over to
siblings (re-enqueued from the prompt — no tokens were emitted, so
greedy generations stay identical) and surfaces :class:`ReplicaFailure`
on the handles of in-flight DECODE sessions, whose partial KV died with
the replica.
"""
from __future__ import annotations

import time
from typing import Callable, List, Optional

__all__ = ["HealthBoard", "ReplicaFailure", "HEALTHY", "DEAD"]

HEALTHY = "healthy"
DEAD = "dead"


class ReplicaFailure(RuntimeError):
    """A request's replica died while the request was mid-decode: its
    generated KV is lost and the request cannot be transparently
    resumed.  Raised from ``result()`` / ``stream()`` of the affected
    handle (never from unrelated requests — those fail over silently)."""

    def __init__(self, replica: int, req_id: int, reason: str) -> None:
        super().__init__(
            f"replica {replica} failed while request {req_id} was "
            f"in flight: {reason}")
        self.replica = replica
        self.req_id = req_id
        self.reason = reason


class HealthBoard:
    """Per-replica health states + tick-progress heartbeats.

    Not internally locked: the owning `ReplicaPool` mutates it under its
    own ``_cv``."""

    def __init__(self, num_replicas: int,
                 clock: Callable[[], float] = time.monotonic) -> None:
        self._clock = clock
        self._state: List[str] = [HEALTHY] * num_replicas
        self._reason: List[Optional[str]] = [None] * num_replicas
        # (last observed tick count, when it last changed)
        self._progress: List[tuple] = [(0, clock())] * num_replicas

    # -- queries ----------------------------------------------------------
    def healthy(self, idx: int) -> bool:
        return self._state[idx] == HEALTHY

    def healthy_indices(self) -> List[int]:
        return [i for i, s in enumerate(self._state) if s == HEALTHY]

    def state(self, idx: int) -> str:
        return self._state[idx]

    def reason(self, idx: int) -> Optional[str]:
        return self._reason[idx]

    def snapshot(self) -> List[dict]:
        return [{"replica": i, "state": s, "reason": self._reason[i]}
                for i, s in enumerate(self._state)]

    # -- transitions ------------------------------------------------------
    def mark_dead(self, idx: int, reason: str) -> None:
        if self._state[idx] == DEAD:
            return
        self._state[idx] = DEAD
        self._reason[idx] = reason

    def beat(self, idx: int, ticks: int, busy: bool) -> float:
        """Record a watchdog observation of ``idx``'s cumulative tick
        count.  Returns seconds since the replica last made progress —
        0.0 whenever the counter moved or the replica is idle (an idle
        replica is quiescent, not stalled)."""
        last_ticks, last_t = self._progress[idx]
        now = self._clock()
        if ticks != last_ticks or not busy:
            self._progress[idx] = (ticks, now)
            return 0.0
        return now - last_t
