"""Request-lifecycle state machine for iteration-level serving.

A :class:`Session` is one request's journey through the continuous-batching
pipeline: ``QUEUED -> PREFILL -> DECODE -> FINISHED`` for generative
requests, or ``QUEUED -> PREFILL -> FINISHED`` for one-shot (classification)
requests that complete in a single batched forward pass.

Sessions are the currency shared by the scheduler loop
(`repro_torch.core.pipeline`) and the engine (`repro_torch.runtime.engine`).
Copied from the JAX package.

This module is deliberately dependency-free (no torch, no
repro_torch.core) so both packages can import it without cycles.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Any, List, Optional, Sequence, Tuple


@dataclass(frozen=True)
class GenerationParams:
    """Per-request generation controls, carried by every :class:`Session`
    and delivered to the engine's on-device sampler.

    ``temperature == 0`` is greedy decoding (bit-identical to argmax);
    ``temperature > 0`` draws from the softmax of ``logits/temperature``
    after optional top-k / top-p (nucleus) filtering.  ``seed`` makes a
    sampled request reproducible independent of batch composition: token
    ``i`` of a request is always drawn with ``fold_in(key(seed), i)``,
    so re-running the request — alone or co-batched with strangers —
    yields the same stream.  ``stop`` is extra stop-token ids beyond
    ``eos`` (generation includes the stop token, then halts).
    """
    max_new_tokens: int = 16
    temperature: float = 0.0
    top_k: int = 0                    # 0 = disabled (full vocab)
    top_p: float = 1.0                # 1.0 = disabled
    seed: int = 0
    eos: Optional[int] = None
    stop: Tuple[int, ...] = ()

    def __post_init__(self) -> None:
        if self.max_new_tokens < 0:
            raise ValueError("max_new_tokens must be >= 0")
        if self.temperature < 0:
            raise ValueError("temperature must be >= 0")
        if self.top_k < 0:
            raise ValueError("top_k must be >= 0")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError("top_p must be in (0, 1]")
        # tuple-ify so callers can pass lists; frozen needs object.__setattr__
        object.__setattr__(self, "stop", tuple(self.stop))


class SessionState(enum.Enum):
    QUEUED = "queued"        # waiting in the admission queue
    PREFILL = "prefill"      # admitted; its prompt pass is running
    DECODE = "decode"        # holds a KV slot; advances one token per tick
    FINISHED = "finished"    # response ready, KV freed

    def __str__(self) -> str:  # nicer asserts/logs
        return self.value


_VALID = {
    SessionState.QUEUED: (SessionState.PREFILL,),
    SessionState.PREFILL: (SessionState.DECODE, SessionState.FINISHED),
    SessionState.DECODE: (SessionState.FINISHED,),
    SessionState.FINISHED: (),
}


class InvalidTransition(RuntimeError):
    pass


@dataclass
class Session:
    """One request moving through the serving pipeline.

    ``seq_len`` is the declared prompt length (used for planning);
    ``max_new_tokens == 0`` marks a one-shot request that finishes at
    prefill (the paper's BERT classification service).
    """
    req_id: int
    seq_len: int
    arrival_time: float
    prompt: Optional[Sequence[int]] = None
    max_new_tokens: int = 0
    eos_id: Optional[int] = None
    payload: Any = None               # raw request payload (one-shot input)
    # per-request sampling controls (see GenerationParams; temperature 0
    # keeps the classic greedy path bit-for-bit)
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    stop: Tuple[int, ...] = ()        # extra stop ids beyond eos_id

    # observability: span identity for the request's lifecycle trace.
    # Assigned by the pipeline at submit (monotonic per pipeline) unless
    # the caller set one; every trace event the session emits carries it
    # (see repro_torch.obs.trace — this module stays dependency-free).
    trace_id: Optional[int] = None

    state: SessionState = SessionState.QUEUED
    generated: List[int] = field(default_factory=list)
    result: Any = None
    error: Optional[str] = None       # set when execution failed terminally
    cancelled: bool = False           # torn down by Session.cancel()
    # streaming: when True the serving backend publishes generated tokens
    # to `generated` every tick (one tiny host read) instead of only at
    # finish; `streamed` counts tokens already delivered through the
    # pipeline's token-emission callback
    stream: bool = False
    streamed: int = 0

    # execution bookkeeping (filled in as the session advances)
    slot: int = -1                    # decode-slot index in the engine
    batch_size: int = 0               # size of the batch it was prefilled in
    padded_len: int = 0               # padded length of that batch
    prefill_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    # host-visible emission timestamps (first entry = the prefill's seed
    # token, then one per decode tick); inter-token-latency telemetry for
    # the serving benchmarks — diffs of this list are the ITL samples.
    token_times: List[float] = field(default_factory=list)
    # prompt tokens served from a KV cache instead of the prefill pass
    # (telemetry; always 0 until the port has a prefix cache)
    cached_tokens: int = 0

    # -- constructors ----------------------------------------------------
    @classmethod
    def from_params(cls, req_id: int, prompt: Sequence[int],
                    params: GenerationParams,
                    arrival_time: float = 0.0) -> "Session":
        """Build a generative session from a prompt + GenerationParams
        (the `repro_torch.api` entry point's constructor)."""
        return cls(req_id=req_id, seq_len=len(prompt),
                   arrival_time=arrival_time, prompt=list(prompt),
                   max_new_tokens=params.max_new_tokens,
                   eos_id=params.eos, temperature=params.temperature,
                   top_k=params.top_k, top_p=params.top_p,
                   seed=params.seed, stop=tuple(params.stop))

    @property
    def params(self) -> GenerationParams:
        """The session's generation controls as a GenerationParams view."""
        return GenerationParams(
            max_new_tokens=self.max_new_tokens,
            temperature=self.temperature, top_k=self.top_k,
            top_p=self.top_p, seed=self.seed, eos=self.eos_id,
            stop=tuple(self.stop))

    # -- state machine ---------------------------------------------------
    def _to(self, new: SessionState) -> None:
        if new not in _VALID[self.state]:
            raise InvalidTransition(
                f"session {self.req_id}: {self.state} -> {new}")
        self.state = new

    def start_prefill(self, now: float, batch_size: int,
                      padded_len: int) -> None:
        self._to(SessionState.PREFILL)
        self.prefill_time = now
        self.batch_size = batch_size
        self.padded_len = padded_len

    def start_decode(self, now: float, slot: int = -1) -> None:
        self._to(SessionState.DECODE)
        self.slot = slot
        self.first_token_time = now
        self.token_times.append(now)

    def finish(self, now: float, result: Any = None) -> None:
        self._to(SessionState.FINISHED)
        self.finish_time = now
        if result is not None:
            self.result = result
        self.slot = -1

    def cancel(self, now: float) -> None:
        """Terminal cancellation from ANY live state (QUEUED, PREFILL,
        DECODE).  Unlike :meth:`finish` this is not a normal
        transition — it marks the session cancelled and force-finishes
        it; the serving backend has already released every resource the
        session held.  Tokens generated before the cancel stay in
        ``generated`` (a partial result)."""
        if self.state is SessionState.FINISHED:
            raise InvalidTransition(
                f"session {self.req_id}: cannot cancel a finished session")
        self.cancelled = True
        self.state = SessionState.FINISHED
        self.finish_time = now
        self.slot = -1

    # -- queries ---------------------------------------------------------
    @property
    def is_one_shot(self) -> bool:
        return self.max_new_tokens == 0

    @property
    def is_finished(self) -> bool:
        return self.state == SessionState.FINISHED

    @property
    def tokens_emitted(self) -> int:
        return len(self.generated)

    @property
    def total_len(self) -> int:
        """Prompt + full generation budget: the KV reach this session may
        need, used to size slab regions and decode-slot caches."""
        return self.seq_len + self.max_new_tokens

    @property
    def latency(self) -> Optional[float]:
        if self.finish_time is None:
            return None
        return self.finish_time - self.arrival_time

    @property
    def ttft(self) -> Optional[float]:
        """Time to first generated token (None until decoding starts)."""
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival_time

    def inter_token_latencies(self) -> List[float]:
        """Gaps between consecutive emission timestamps — the per-token
        stall a co-scheduled prefill imposes shows up here."""
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]
