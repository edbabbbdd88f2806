"""Discrete-event serving simulator (paper §6.3: Figs. 15/16, Tables 4/5).

Requests arrive with Poisson inter-arrival times and uniform random
lengths; replicas execute work with service times given by a CostModel.
Policies: nobatch / naive / dp — exactly the four systems in the paper
once combined with the PyTorch-vs-Turbo cost models.

Since the iteration-level refactor the simulator carries NO plan/execute
logic of its own: each replica is a `repro_torch.core.pipeline.ServingPipeline`
— the same loop the port's engines run on the card — driven by a
:class:`VirtualBackend` that advances a virtual clock by cost-model
estimates instead of running a model.  Generative workloads
(``Workload.gen_tokens > 0``) exercise the continuous-batching decode
phase, including early release of KV the moment a sequence hits its
(synthetic) EOS.

Beyond-paper scale features: straggler injection + timeout-requeue
mitigation, and multi-replica serving with a shared arrival stream (the
Nexus-style upper-level balancer the paper defers to).

Copied from the JAX package: host code only, it touches no device, and
the same workload, configuration and cost model give the same result in
both packages.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import (CostModel, block_round,
                                   prefix_fresh_blocks)
from repro_torch.core.pipeline import (PipelineBackend, PipelineConfig,
                                 PipelineStats, ServingPipeline)
from repro_torch.core.serving import Request, Response
from repro_torch.obs import Observability
from repro_torch.runtime.session import Session


@dataclass
class Workload:
    rate: float                       # requests / second
    duration: float                   # seconds of arrivals
    len_min: int = 2
    len_max: int = 100
    seed: int = 0
    # generation: 0 = one-shot classification (paper's workload);
    # > 0 = each request decodes up to gen_tokens new tokens, hitting a
    # synthetic EOS uniformly in [gen_min, gen_tokens] when gen_min is set
    gen_tokens: int = 0
    gen_min: Optional[int] = None
    # prefix mix: with probability prefix_mix a request opens with the
    # cohort's shared ``prefix_tokens``-token preamble (system prompt /
    # few-shot header) in FRONT of its drawn length — the workload the
    # prefix-sharing KV cache exists for.  prefix_tokens=0 leaves the rng
    # stream untouched (older seeds reproduce exactly).
    prefix_tokens: int = 0
    prefix_mix: float = 0.0
    # long-prompt mix: with probability long_frac a request's prompt is
    # ``long_len`` tokens instead of the U(len_min, len_max) draw — the
    # mixed long/short workload whose decode stalls chunked prefill
    # bounds.  long_len=0 leaves the rng stream untouched.
    long_len: int = 0
    long_frac: float = 0.0

    def generate_sessions(self) -> List[Session]:
        rng = random.Random(self.seed)
        t = 0.0
        out: List[Session] = []
        i = 0
        while True:
            t += rng.expovariate(self.rate)
            if t > self.duration:
                break
            base_len = rng.randint(self.len_min, self.len_max)
            if self.long_len and rng.random() < self.long_frac:
                base_len = self.long_len
            shared = 0
            if self.prefix_tokens and rng.random() < self.prefix_mix:
                shared = self.prefix_tokens
            s = Session(req_id=i,
                        seq_len=shared + base_len,
                        arrival_time=t,
                        max_new_tokens=self.gen_tokens,
                        prefix_group=0 if shared else None,
                        shared_prefix_len=shared)
            if self.gen_tokens and self.gen_min is not None:
                s.eos_at = rng.randint(self.gen_min, self.gen_tokens)
            out.append(s)
            i += 1
        return out

    def generate(self) -> List[Request]:
        return [Request(s.req_id, s.seq_len, s.arrival_time)
                for s in self.generate_sessions()]


@dataclass
class SimConfig:
    policy: str = "dp"
    max_batch_size: int = 20
    num_replicas: int = 1
    # iteration-level knobs (see PipelineConfig): "continuous" admits
    # prefills mid-decode; "drain" reproduces batch-at-a-time serving
    admission: str = "continuous"
    max_decode_slots: Optional[int] = None
    prefill_stall_factor: float = 32.0
    min_decode_batch: int = 1
    # KV accounting: "eos" frees a sequence's region the moment it
    # finishes; "batch" holds every region until its whole prefill group
    # drains (the pre-refactor engine behavior, kept as a baseline)
    kv_free: str = "eos"
    # paged-KV model: when kv_block_size is set, per-request KV charges
    # are rounded up to whole blocks, and num_kv_blocks (if also set)
    # bounds the pool — admission then vetoes prefills that cannot get
    # blocks, mirroring the real engine's BlockTableManager
    kv_block_size: Optional[int] = None
    num_kv_blocks: Optional[int] = None
    # chunked prefill (see PipelineConfig): long prompts advance one
    # budget-sized chunk per tick instead of stalling the decode batch
    # for a whole prompt pass; prefill_chunk_tokens pins the chunk size
    # (None derives it from prefill_stall_factor x decode tick cost)
    chunked_prefill: bool = False
    prefill_chunk_tokens: Optional[int] = None
    # decode-fused chunks (see PipelineConfig): a non-final chunk and
    # the decode tick dispatch as one group, saving one per-dispatch
    # overhead and a stalled decode tick per chunk
    fused_chunk_decode: bool = True
    # packed prefill (see PipelineConfig): chunk turns serve a pack
    # group — every resumable prefill's share plus queued prompts — as
    # ONE dispatch priced over the flat tokens; False models the
    # one-chunk-per-tick baseline for A/B dispatch comparisons
    packed_prefill: bool = True
    # prefix-sharing model (mirrors the real engine's RadixPrefixCache
    # over a Workload prefix mix): once one member of a prefix cohort has
    # prefilled, later members are charged only their uncached suffix —
    # prefill time over suffix tokens, KV demand via the shared
    # prefix_fresh_blocks() rounding — while the shared prefix KV is
    # charged ONCE, in a cohort-level pool entry.  Divergence from the
    # real cache: the simulator pins resident prefixes for the run (no
    # LRU-eviction pressure model); hit accounting is otherwise aligned.
    prefix_cache: bool = False
    # straggler model: with prob p a service takes x`slowdown`; if
    # mitigation is on, a straggling service is cut off at
    # `timeout_factor` x expected and re-executed (requeue), modelling
    # replica failover.
    straggler_prob: float = 0.0
    straggler_slowdown: float = 5.0
    mitigate_stragglers: bool = False
    straggler_timeout_factor: float = 2.0
    seed: int = 0

    def pipeline_config(self) -> PipelineConfig:
        return PipelineConfig(
            policy=self.policy, strategy="hungry",
            max_batch_size=self.max_batch_size, admission=self.admission,
            prefill_stall_factor=self.prefill_stall_factor,
            min_decode_batch=self.min_decode_batch,
            chunked_prefill=self.chunked_prefill,
            prefill_chunk_tokens=self.prefill_chunk_tokens,
            fused_chunk_decode=self.fused_chunk_decode,
            packed_prefill=self.packed_prefill)


class VirtualClock:
    def __init__(self, now: float = 0.0) -> None:
        self.now = now

    def __call__(self) -> float:
        return self.now

    def advance(self, dt: float) -> None:
        self.now += dt


class VirtualBackend(PipelineBackend):
    """Cost-model execution: every pipeline action advances the replica's
    virtual clock by the modelled service time.  Shared KV accounting (in
    tokens) lets benchmarks compare footprint under eos-early-free vs
    hold-to-batch-end."""

    def __init__(self, cost: CostModel, clock: VirtualClock,
                 service: Callable[[float], float],
                 config: SimConfig,
                 kv_live: Dict[int, int],
                 kv_timeline: List[Tuple[float, int]]) -> None:
        self.cost = cost
        self.clock = clock
        self.service = service
        self.config = config
        self.decoding: List[Session] = []
        self.kv_live = kv_live              # req_id -> held tokens
        self.kv_timeline = kv_timeline      # (virtual time, live tokens)
        self._groups: List[Dict[int, Session]] = []   # kv_free="batch"
        # prefix cohorts resident in the (virtual) cache: group -> cached
        # tokens; the shared KV is charged once, under a negative pool key
        self._prefix_resident: Dict[int, int] = {}
        self.prefix_hits = 0
        self.prefix_tokens_saved = 0
        # chunked prefill: sessions mid-resumable-prefill (they hold a
        # reserved decode slot + their whole prompt's KV), the modelled
        # latency of every chunk executed while decodes were in flight
        # (the stall-relevant ones), and of every decode tick — the
        # stall-bound assertions in tests and benches read these
        self._chunking: Dict[int, Session] = {}
        self.chunk_latencies: List[float] = []
        self.decode_latencies: List[float] = []
        # prefill device dispatches the model would make — the packed
        # vs sequential A/B metric benches read
        self.prefill_dispatches = 0
        self.pack_dispatches = 0
        self.pack_segments = 0

    def observe_metrics(self, m) -> None:
        """Tick-boundary gauge sampling (the duck-typed hook
        `ServingPipeline._tick_boundary` calls) — the virtual analogue
        of `ContinuousEngine.observe_metrics`, over the same name
        prefixes so wall and virtual snapshots line up."""
        m.gauge("kv.live_tokens").set(
            sum(self._charge(t) for t in self.kv_live.values()))
        m.gauge("prefix.hits").set(self.prefix_hits)
        m.gauge("prefix.reused_tokens").set(self.prefix_tokens_saved)
        m.gauge("engine.prefill_dispatches").set(self.prefill_dispatches)

    # -- capacity ------------------------------------------------------
    def free_slots(self) -> Optional[int]:
        if self.config.max_decode_slots is None:
            return None
        return self.config.max_decode_slots - len(self.decoding) \
            - len(self._chunking)

    def free_kv_tokens(self) -> Optional[int]:
        cfg = self.config
        if cfg.kv_block_size is None or cfg.num_kv_blocks is None:
            return None
        cap = cfg.num_kv_blocks * cfg.kv_block_size
        return max(cap - sum(self._charge(t) for t in
                             self.kv_live.values()), 0)

    def kv_demand(self, session: Session) -> int:
        cached = self._cached_for(session)
        if self.config.kv_block_size is not None:
            return prefix_fresh_blocks(
                session.total_len, cached,
                self.config.kv_block_size) * self.config.kv_block_size
        return session.total_len - cached

    def _charge(self, tokens: int) -> int:
        if self.config.kv_block_size is None:
            return tokens
        return block_round(tokens, self.config.kv_block_size)

    def _cached_for(self, s: Session) -> int:
        """Shared-prefix tokens this session would reuse: its cohort's
        resident prefix, capped so >= 1 suffix token stays to prefill
        (the real matcher's cap)."""
        if not self.config.prefix_cache or s.prefix_group is None:
            return 0
        resident = self._prefix_resident.get(s.prefix_group, 0)
        return max(min(resident, s.shared_prefix_len, s.seq_len - 1), 0)

    # -- KV accounting ---------------------------------------------------
    def _sample_kv(self) -> None:
        self.kv_timeline.append((self.clock.now,
                                 sum(self._charge(t) for t in
                                     self.kv_live.values())))

    def _on_finish(self, s: Session) -> None:
        if self.config.kv_free == "eos":
            self.kv_live.pop(s.req_id, None)

    def _install_prefix(self, s: Session) -> int:
        """First cohort member through prefill makes the shared prefix
        resident (full blocks only — a mid-block tail is copy-on-write
        private in the real cache); the cohort pool entry charges it
        once.  Returns the tokens newly moved under the cohort entry so
        the caller can leave them off the member's own charge."""
        g = s.prefix_group
        resident = s.shared_prefix_len
        if self.config.kv_block_size is not None:
            resident = (resident // self.config.kv_block_size) * \
                self.config.kv_block_size
        prev = self._prefix_resident.get(g, 0)
        if resident > prev:
            self._prefix_resident[g] = resident
            self.kv_live[-(1000 + g)] = resident
            return resident - prev
        return 0

    def _sweep_groups(self) -> None:
        """Hold-to-batch-end accounting: release a prefill group's regions
        only once every member has finished."""
        kept = []
        for group in self._groups:
            if all(m.is_finished for m in group.values()):
                for rid in group:
                    self.kv_live.pop(rid, None)
            else:
                kept.append(group)
        self._groups = kept

    # -- execution -------------------------------------------------------
    def prefill_batch(self, sessions: List[Session],
                      padded_len: int) -> None:
        b = len(sessions)
        for s in sessions:
            s.cached_tokens = self._cached_for(s)
            if s.cached_tokens:
                self.prefix_hits += 1
                self.prefix_tokens_saved += s.cached_tokens
        # prefix hits prefill only their uncached suffix: the batch pads
        # to the longest *suffix*, mirroring the real engine's resumable
        # suffix prefill
        eff_len = max(s.seq_len - s.cached_tokens for s in sessions)
        self.clock.advance(
            self.service(self.cost.prefill_latency(max(eff_len, 1), b)))
        self.prefill_dispatches += 1
        now = self.clock.now
        for s in sessions:
            if s.is_one_shot:
                s.finish(now)
                continue
            installed = 0
            if self.config.prefix_cache and s.prefix_group is not None:
                installed = self._install_prefix(s)
            # charge-once: tokens the cohort pool entry now covers are
            # NOT also charged to the member — in the real engine the
            # cold member's prompt blocks ARE the cached blocks (one
            # physical copy, shared with the trie)
            self.kv_live[s.req_id] = \
                s.total_len - s.cached_tokens - installed
            s.start_decode(now)
            s.generated.append(1)        # first token comes from prefill
            if s.stop_after(1):
                s.finish(now)
                self._on_finish(s)
            else:
                self.decoding.append(s)
        if self.config.kv_free == "batch":
            group = {s.req_id: s for s in sessions if not s.is_one_shot}
            if group:
                self._groups.append(group)
            self._sweep_groups()
        self._sample_kv()

    def decode_tick(self, sessions: List[Session]) -> None:
        b = len(sessions)
        ctx = sum(s.seq_len + s.tokens_emitted for s in sessions) / b
        lat = self.service(self.cost.decode_latency(b, int(ctx)))
        self.decode_latencies.append(lat)
        self.clock.advance(lat)
        now = self.clock.now
        for s in sessions:
            s.generated.append(1)
            if s.stop_after(s.tokens_emitted):
                s.finish(now)
                self._on_finish(s)
        self.decoding = [s for s in self.decoding if not s.is_finished]
        if self.config.kv_free == "batch":
            self._sweep_groups()
        self._sample_kv()

    # -- chunked prefill -------------------------------------------------
    def supports_chunked_prefill(self) -> bool:
        return True

    def chunk_quantum(self) -> int:
        return self.config.kv_block_size or 16

    def begin_prefill_chunks(self, s: Session) -> None:
        """Charge the whole prompt's KV and a decode slot up front (the
        real engine's block reservation); chunks then advance without
        capacity risk.  A cached prefix skips straight past its tokens."""
        cached = self._cached_for(s)
        s.cached_tokens = cached
        if cached:
            self.prefix_hits += 1
            self.prefix_tokens_saved += cached
        s.prefilled_tokens = cached
        self.kv_live[s.req_id] = s.total_len - cached
        self._chunking[s.req_id] = s
        self._sample_kv()

    def prefill_chunk(self, s: Session, upto: int) -> None:
        n = upto - s.prefilled_tokens
        lat = self.service(self.cost.prefill_latency(max(n, 1), 1))
        # stall telemetry covers chunks that actually had decodes to
        # stall: with an empty decode batch the pipeline deliberately
        # sizes the chunk to the whole remaining prompt (nothing waits),
        # so recording it would fail the stall-budget bound for free
        if self.decoding:
            self.chunk_latencies.append(lat)
        self.clock.advance(lat)
        self.prefill_dispatches += 1
        s.prefilled_tokens = upto
        if upto < s.seq_len:
            return
        del self._chunking[s.req_id]
        now = self.clock.now
        if s.is_one_shot:
            s.finish(now)
            self.kv_live.pop(s.req_id, None)
            self._sample_kv()
            return
        installed = 0
        if self.config.prefix_cache and s.prefix_group is not None:
            installed = self._install_prefix(s)
        self.kv_live[s.req_id] = s.total_len - s.cached_tokens - installed
        s.start_decode(now)
        s.generated.append(1)        # first token comes from prefill
        if s.stop_after(1):
            s.finish(now)
            self._on_finish(s)
        else:
            self.decoding.append(s)
        if self.config.kv_free == "batch":
            self._groups.append({s.req_id: s})
            self._sweep_groups()
        self._sample_kv()

    def supports_fused_chunk_decode(self) -> bool:
        return True

    def chunk_decode_tick(self, s: Session, upto: int,
                          decoding: List[Session]) -> None:
        """Fused chunk+decode model: the chunk pass and the decode tick
        dispatch as one group, so the combined service time drops one
        per-dispatch overhead relative to running them back-to-back.
        Only NON-final chunks fuse (the pipeline guarantees it), so no
        decode-seeding bookkeeping belongs here."""
        n = upto - s.prefilled_tokens
        clat = self.service(self.cost.prefill_latency(max(n, 1), 1))
        self.chunk_latencies.append(clat)    # decoding is never empty here
        self.clock.advance(clat)
        self.prefill_dispatches += 1
        s.prefilled_tokens = upto
        b = len(decoding)
        ctx = sum(d.seq_len + d.tokens_emitted for d in decoding) / b
        lat = self.service(self.cost.decode_latency(b, int(ctx)))
        lat = max(lat - getattr(self.cost, "overhead", 0.0), 0.0)
        self.decode_latencies.append(lat)
        self.clock.advance(lat)
        now = self.clock.now
        for d in decoding:
            d.generated.append(1)
            if d.stop_after(d.tokens_emitted):
                d.finish(now)
                self._on_finish(d)
        self.decoding = [d for d in self.decoding if not d.is_finished]
        if self.config.kv_free == "batch":
            self._sweep_groups()
        self._sample_kv()

    def abort_chunked(self, s: Session) -> None:
        self._chunking.pop(s.req_id, None)
        self.kv_live.pop(s.req_id, None)
        self._sample_kv()

    # -- packed prefill --------------------------------------------------
    def supports_packed_prefill(self) -> bool:
        return True

    def prefill_pack(self, admissions: List[Session],
                     chunks: List[Tuple[Session, int]],
                     decoding: Optional[List[Session]] = None) -> None:
        """Packed-dispatch model: ONE service time covering every
        segment's fresh tokens (``packed_prefill_latency`` — a single
        launch over the flat pack, the same pricing the real engine's
        dispatch executes at), then exactly the per-session bookkeeping
        the sequential ``prefill_batch``/``prefill_chunk`` paths do.
        ``decoding`` fuses a decode tick behind the pack minus one
        dispatch overhead, like ``chunk_decode_tick``."""
        for s in admissions:
            s.cached_tokens = self._cached_for(s)
            if s.cached_tokens:
                self.prefix_hits += 1
                self.prefix_tokens_saved += s.cached_tokens
        flat = sum(s.seq_len - s.cached_tokens for s in admissions) + \
            sum(upto - s.prefilled_tokens for s, upto in chunks)
        nseg = len(admissions) + len(chunks)
        lat = self.service(self.cost.packed_prefill_latency(
            max(flat, 1), nseg))
        if self.decoding:
            self.chunk_latencies.append(lat)
        self.clock.advance(lat)
        self.prefill_dispatches += 1
        self.pack_dispatches += 1
        self.pack_segments += nseg
        now = self.clock.now
        group: Dict[int, Session] = {}

        def seed_decode(s: Session) -> None:
            installed = 0
            if self.config.prefix_cache and s.prefix_group is not None:
                installed = self._install_prefix(s)
            self.kv_live[s.req_id] = \
                s.total_len - s.cached_tokens - installed
            s.start_decode(now)
            s.generated.append(1)    # first token comes from prefill
            if s.stop_after(1):
                s.finish(now)
                self._on_finish(s)
            else:
                self.decoding.append(s)
            group[s.req_id] = s

        for s in admissions:
            if s.is_one_shot:
                s.finish(now)
                continue
            seed_decode(s)
        for s, upto in chunks:
            s.prefilled_tokens = upto
            if upto < s.seq_len:
                continue
            del self._chunking[s.req_id]
            if s.is_one_shot:
                s.finish(now)
                self.kv_live.pop(s.req_id, None)
                continue
            seed_decode(s)
        if decoding is not None:
            b = len(decoding)
            ctx = sum(d.seq_len + d.tokens_emitted for d in decoding) / b
            dlat = self.service(self.cost.decode_latency(b, int(ctx)))
            dlat = max(dlat - getattr(self.cost, "overhead", 0.0), 0.0)
            self.decode_latencies.append(dlat)
            self.clock.advance(dlat)
            tnow = self.clock.now
            for d in decoding:
                d.generated.append(1)
                if d.stop_after(d.tokens_emitted):
                    d.finish(tnow)
                    self._on_finish(d)
            self.decoding = [d for d in self.decoding
                             if not d.is_finished]
        if self.config.kv_free == "batch":
            if group:
                self._groups.append(group)
            self._sweep_groups()
        self._sample_kv()

    # -- cancellation ----------------------------------------------------
    def cancel_session(self, s: Session) -> None:
        """Mid-decode cancel under the virtual clock: drop the decode
        slot and the session's KV charge immediately (no time passes —
        cancellation is host bookkeeping, not device work)."""
        if s in self.decoding:
            self.decoding.remove(s)
        self.kv_live.pop(s.req_id, None)
        self._sample_kv()


@dataclass
class SimResult:
    responses: List[Response]
    duration: float
    offered: int                     # arrivals within the window
    # iteration-level telemetry (kv_timeline: single-replica runs only —
    # samples from independent replica clocks would not be comparable)
    kv_timeline: List[Tuple[float, int]] = field(default_factory=list)
    batch_log: List[Tuple[int, ...]] = field(default_factory=list)
    stats: PipelineStats = field(default_factory=PipelineStats)
    # prefix-sharing telemetry (SimConfig.prefix_cache runs)
    prefix_hits: int = 0
    prefix_tokens_saved: int = 0
    # decode-stall telemetry: per-session inter-token-latency samples
    # (gaps between consecutive emission timestamps — a co-scheduled
    # prefill's stall lands here), and the modelled latency of every
    # prefill chunk / decode tick executed
    itl_samples: List[float] = field(default_factory=list)
    chunk_latencies: List[float] = field(default_factory=list)
    decode_latencies: List[float] = field(default_factory=list)
    # prefill-dispatch telemetry (packed vs sequential A/B): device
    # dispatches the model made, how many were packed, and the total
    # segments those packs served
    prefill_dispatches: int = 0
    pack_dispatches: int = 0
    pack_segments: int = 0
    # time-to-first-token per finished session (arrival -> first
    # emission); the pack scheduler trades dispatch count against TTFT,
    # so A/B runs report both
    ttft_samples: List[float] = field(default_factory=list)
    # raw trace-recorder events (simulate(..., trace=True) runs only;
    # virtual-clock timestamps — render with repro_torch.obs.chrome_trace)
    trace: Optional[List[dict]] = None

    def itl_percentile(self, q: float) -> float:
        """Inter-token latency at quantile ``q`` (0 < q <= 1), e.g.
        q=0.99 for the P99 decode stall; 0.0 when nothing decoded."""
        if not self.itl_samples:
            return 0.0
        xs = sorted(self.itl_samples)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    def ttft_percentile(self, q: float) -> float:
        """Time-to-first-token at quantile ``q``; 0.0 when nothing
        emitted."""
        if not self.ttft_samples:
            return 0.0
        xs = sorted(self.ttft_samples)
        return xs[min(int(q * len(xs)), len(xs) - 1)]

    @property
    def throughput(self) -> float:
        """Responses completed WITHIN the arrival window (paper Fig 15/16
        y-axis): an overloaded server plateaus at its service capacity."""
        done = sum(1 for r in self.responses
                   if r.finish_time <= self.duration)
        return done / self.duration

    @property
    def unstable(self) -> bool:
        """Critical point (§6.3): stable iff serving throughput keeps up
        with request throughput."""
        return self.throughput < 0.95 * self.offered / self.duration

    def latency_stats(self) -> Tuple[float, float, float]:
        if not self.responses:
            return (math.inf, math.inf, math.inf)
        lats = [r.latency for r in self.responses]
        return (sum(lats) / len(lats), min(lats), max(lats))

    @property
    def peak_kv_tokens(self) -> int:
        return max((v for _, v in self.kv_timeline), default=0)

    @property
    def mean_kv_tokens(self) -> float:
        if not self.kv_timeline:
            return 0.0
        return sum(v for _, v in self.kv_timeline) / len(self.kv_timeline)


def virtual_replica(cost: CostModel,
                    config: Optional[SimConfig] = None
                    ) -> Tuple[VirtualBackend, VirtualClock]:
    """One fresh simulator replica: a `VirtualBackend` over its own
    `VirtualClock`, no straggler injection, private KV accounting.  The
    building block `TurboClient.simulated(...)` (and its
    ``replicas=N`` pool variant) assembles clients from."""
    config = config if config is not None else SimConfig()
    clock = VirtualClock()
    return VirtualBackend(cost, clock, lambda t: t, config, {}, []), clock


def simulate(workload: Workload, cost: CostModel,
             config: Optional[SimConfig] = None, *,
             trace: bool = False) -> SimResult:
    """Drive the shared ServingPipeline loop under a virtual clock:
    whenever a replica is the earliest free, it admits arrivals up to its
    clock and ticks (a planned prefill round or one decode step).

    ``trace=True`` attaches a `repro_torch.obs.TraceRecorder` per replica and
    returns the merged raw events in ``SimResult.trace`` — structurally
    identical to a wall-clock serving trace (same event names in the
    same per-request order), just on virtual timestamps."""
    config = config if config is not None else SimConfig()
    sessions = workload.generate_sessions()
    rng = random.Random(config.seed + 1)

    def service(base: float) -> float:
        if config.straggler_prob and rng.random() < config.straggler_prob:
            slow = base * config.straggler_slowdown
            if config.mitigate_stragglers:
                # detect at timeout, requeue on a healthy replica
                return base * config.straggler_timeout_factor + base
            return slow
        return base

    # KV accounting is per replica (each replica's cache is its own
    # device memory); the sampled timeline is only coherent against a
    # single clock, so it is recorded for single-replica runs only.
    kv_timeline: List[Tuple[float, int]] = []
    clocks = [VirtualClock() for _ in range(config.num_replicas)]
    pcfg = config.pipeline_config()
    pipelines = []
    for clock in clocks:
        backend = VirtualBackend(
            cost, clock, service, config, {},
            kv_timeline if config.num_replicas == 1 else [])
        obs = Observability.with_trace() if trace else None
        pipelines.append(ServingPipeline(backend, cost, pcfg, clock,
                                         obs=obs))

    ai = 0
    n = len(sessions)
    horizon = workload.duration * 3 + 1.0

    while True:
        r = min(range(config.num_replicas), key=lambda i: clocks[i].now)
        now = clocks[r].now
        if not math.isfinite(now) or now > horizon:
            break   # saturated or fully drained
        while ai < n and sessions[ai].arrival_time <= now:
            pipelines[r].submit(sessions[ai])
            ai += 1
        if pipelines[r].idle():
            if ai < n:
                # idle until the next arrival
                clocks[r].now = max(now, sessions[ai].arrival_time)
            else:
                clocks[r].now = math.inf   # retired: no work will come
            continue
        pipelines[r].tick()

    responses = []
    stats = PipelineStats()
    batch_log: List[Tuple[int, ...]] = []
    prefix_hits = prefix_saved = 0
    itl: List[float] = []
    ttfts: List[float] = []
    chunk_lats: List[float] = []
    decode_lats: List[float] = []
    disp = packs = segs = 0
    for p in pipelines:
        for s in p.finished:
            responses.append(Response(s.req_id, s.arrival_time,
                                      s.finish_time, s.batch_size,
                                      s.padded_len))
            itl.extend(s.inter_token_latencies())
            if s.token_times:
                ttfts.append(s.token_times[0] - s.arrival_time)
        batch_log.extend(p.batch_log)
        prefix_hits += p.backend.prefix_hits
        prefix_saved += p.backend.prefix_tokens_saved
        chunk_lats.extend(p.backend.chunk_latencies)
        decode_lats.extend(p.backend.decode_latencies)
        disp += p.backend.prefill_dispatches
        packs += p.backend.pack_dispatches
        segs += p.backend.pack_segments
        for k in vars(stats):
            setattr(stats, k, getattr(stats, k) + getattr(p.stats, k))
    responses.sort(key=lambda r: (r.finish_time, r.req_id))
    events: Optional[List[dict]] = None
    if trace:
        events = [ev for p in pipelines for ev in p.obs.trace.events]
        events.sort(key=lambda ev: ev["ts"])
    return SimResult(responses, workload.duration, n,
                     kv_timeline=sorted(kv_timeline), batch_log=batch_log,
                     stats=stats, prefix_hits=prefix_hits,
                     prefix_tokens_saved=prefix_saved, itl_samples=itl,
                     chunk_latencies=chunk_lats,
                     decode_latencies=decode_lats,
                     prefill_dispatches=disp, pack_dispatches=packs,
                     pack_segments=segs, ttft_samples=ttfts,
                     trace=events)


def throughput_curve(rates: Sequence[float], cost: CostModel,
                     config: SimConfig, duration: float = 20.0,
                     len_min: int = 2, len_max: int = 100,
                     seed: int = 0, gen_tokens: int = 0,
                     gen_min: Optional[int] = None
                     ) -> List[Dict[str, float]]:
    """Offered-load sweep -> (resp/sec, latency stats, stable?) per rate.
    The 'critical point' (paper Fig. 15) is the largest stable rate."""
    out = []
    for rate in rates:
        wl = Workload(rate=rate, duration=duration, len_min=len_min,
                      len_max=len_max, seed=seed, gen_tokens=gen_tokens,
                      gen_min=gen_min)
        res = simulate(wl, cost, config)
        avg, lo, hi = res.latency_stats()
        out.append({
            "rate": rate,
            "throughput": res.throughput,
            "avg_latency": avg, "min_latency": lo, "max_latency": hi,
            "stable": 0.0 if res.unstable else 1.0,
        })
    return out


def critical_point(rates: Sequence[float], cost: CostModel,
                   config: SimConfig, **kw) -> float:
    """Largest offered rate the system sustains (throughput == rate)."""
    best = 0.0
    for row in throughput_curve(rates, cost, config, **kw):
        if row["stable"]:
            best = max(best, row["rate"])
    return best
