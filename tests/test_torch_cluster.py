"""The port's serving tier against the JAX package's: `ReplicaPool`,
`PrefixAffinityRouter`, `HealthBoard`, the ``replicas=N`` and
``warmup="background"`` client knobs, and the serving CLI.

- The reference's own cluster cases (tests/test_cluster.py), ported onto
  the port's classes: router, health board, the ownership sanitizer,
  simulated pools (affinity, spill, scaling, failover, conservation,
  cancel, trace and metric namespacing, a closed pool).
- Cross-package parity over the virtual clock: the same submissions into
  ``TurboClient.simulated(replicas=3)`` of both packages give the same
  placements, makespan and pool counters, exactly (one cost model spelled
  out for both: the port's defaults are H100 peaks, the reference's v5e).
- Real pools at the smoke width on the CPU over bridged weights: streams
  equal the reference's pool token for token (greedy and seeded), prefix
  hits land on the owner, failover keeps every token, and routing equals
  the simulated pool's.  Two thread-pumped replicas over one shared
  engine serve what the sync pool serves.
- Background warm-up: a request served between warm rounds, its stream
  and the counters after the warm-up against the reference's.
- The counted collector hold and the device gate between threads.
- The CLI at the smoke width (``--device cpu --replicas 2``): both
  packages' deterministic lines equal.
"""
import threading
import time

import gc
import jax
import numpy as np
import pytest

from _hypothesis_compat import HAVE_HYPOTHESIS, given, settings, st
from repro.api import GenerationParams as JaxParams
from repro.api import TurboClient as JaxClient
from repro.cluster import ReplicaPool as JaxPool
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AnalyticCostModel as JaxCostModel
from repro.launch import serve as jax_serve
from repro.models import init_params as jax_init_params
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.cluster import (HealthBoard, PrefixAffinityRouter,
                                 ReplicaFailure, ReplicaLoad, ReplicaPool)
from repro_torch.configs import get_smoke_config
from repro_torch.core import AnalyticCostModel, SimConfig
from repro_torch.launch import serve as port_serve
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime import graphs
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
from repro_torch.runtime.sanitizer import (SanitizerError,
                                           check_pool_ownership)
from repro_torch.runtime.session import SessionState

ARCH = "internlm2-1.8b"
#: one cost model, spelled out in full for both packages
COST = dict(flops_per_token=1e6, bytes_per_token=1e3, weight_bytes=1e6,
            overhead=1e-4, peak_flops=197e12, hbm_bw=819e9)
CM = AnalyticCostModel(**COST)
JCM = JaxCostModel(**COST)
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(1, 2, 4))


def sim_pool(replicas=2, **kw):
    return TurboClient.simulated(cost_model=CM, replicas=replicas, **kw)


def cohort_prompt(group: int, i: int, prefix_len: int = 32):
    """Prompts within a group share a block-aligned prefix."""
    return [group + 1] * prefix_len + [100 + group, i + 1]


# ---------------------------------------------------------------------------
# Router, health board, ownership (the reference's unit cases)
# ---------------------------------------------------------------------------

def test_router_affinity_then_least_loaded_fallback():
    r = PrefixAffinityRouter(3, block_size=4, skew=2)
    even = {i: ReplicaLoad(depth=0) for i in range(3)}
    cold = r.route([9] * 9, even, [0, 1, 2])
    assert cold.reason == "least_loaded" and cold.matched_blocks == 0
    r.record([9] * 9, cold.replica)
    hot = r.route([9] * 8 + [7], even, [0, 1, 2])
    # 8 shared tokens = 2 indexed blocks (the 9th was capped at record)
    assert hot.replica == cold.replica
    assert hot.reason == "affinity" and hot.matched_blocks == 2


def test_router_skew_guard_spills_hot_prefix():
    r = PrefixAffinityRouter(2, block_size=4, skew=2)
    r.record([1] * 8, 0)
    loads = {0: ReplicaLoad(depth=5), 1: ReplicaLoad(depth=0)}
    d = r.route([1] * 8, loads, [0, 1])
    assert d.replica == 1 and d.reason == "least_loaded"
    loads = {0: ReplicaLoad(depth=2), 1: ReplicaLoad(depth=0)}
    assert r.route([1] * 8, loads, [0, 1]).reason == "affinity"


def test_router_none_capacities_rank_as_unbounded():
    sim = ReplicaLoad(depth=1, free_slots=None, free_kv=None)
    real = ReplicaLoad(depth=1, free_slots=4, free_kv=64)
    assert sim.sort_key(1) < real.sort_key(0)


def test_router_purge_drops_dead_owner():
    r = PrefixAffinityRouter(2, block_size=4)
    r.record([1] * 9, 0)
    r.donate([2] * 8, 1)
    assert r.purge(0) == 2
    owner, blocks = r.lookup([1] * 9, {0, 1})
    assert owner is None and blocks == 0
    assert r.lookup([2] * 8 + [3], {0, 1})[0] == 1


def test_router_random_policy_is_seeded_and_validated():
    picks = []
    for _ in range(2):
        r = PrefixAffinityRouter(3, policy="random", seed=11)
        loads = {i: ReplicaLoad(depth=0) for i in range(3)}
        picks.append([r.route([i] * 20, loads, [0, 1, 2]).replica
                      for i in range(12)])
    assert picks[0] == picks[1] and len(set(picks[0])) > 1
    with pytest.raises(ValueError, match="policy"):
        PrefixAffinityRouter(2, policy="hash")


def test_health_board_beat_and_kill():
    t = [0.0]
    hb = HealthBoard(2, clock=lambda: t[0])
    assert hb.beat(0, ticks=3, busy=True) == 0.0
    t[0] = 4.0
    assert hb.beat(0, ticks=3, busy=True) == 4.0    # no progress, busy
    assert hb.beat(1, ticks=0, busy=False) == 0.0   # idle is not stalled
    hb.mark_dead(0, "kill")
    assert hb.healthy_indices() == [1]
    assert hb.snapshot()[0]["reason"] == "kill"


def test_pool_ownership_invariant():
    assert check_pool_ownership({0: [1, 2], 1: [3]}, {0, 1}) == \
        {1: 0, 2: 0, 3: 1}
    with pytest.raises(SanitizerError, match="owned by replica 0 and"):
        check_pool_ownership({0: [7], 1: [7]}, {0, 1})
    with pytest.raises(SanitizerError, match="unhealthy replica 1"):
        check_pool_ownership({0: [], 1: [5]}, {0})


# ---------------------------------------------------------------------------
# Simulated pools (the reference's cases)
# ---------------------------------------------------------------------------

def test_affinity_lands_cohorts_on_one_replica():
    with sim_pool(replicas=3) as pool:
        handles = {g: [] for g in range(3)}
        for i in range(4):
            for g in range(3):
                handles[g].append(pool.submit(
                    cohort_prompt(g, i),
                    GenerationParams(max_new_tokens=4)))
        pool.drain()
        for g, hs in handles.items():
            assert len({h.replica for h in hs}) == 1, \
                f"cohort {g} split across replicas"
        assert {hs[0].replica for hs in handles.values()} == {0, 1, 2}
        m = pool.metrics()["counters"]
        assert m["pool.routed"] == 12
        assert m["pool.affinity_hits"] == 9   # all but each cohort head


def test_least_loaded_fallback_spreads_distinct_prompts():
    with sim_pool(replicas=4) as pool:
        hs = [pool.submit([50 + i] * 24, GenerationParams(max_new_tokens=2))
              for i in range(8)]
        assert sorted(h.replica for h in hs) == [0, 0, 1, 1, 2, 2, 3, 3]
        pool.drain()


def test_skewed_load_spills_hot_cohort():
    with sim_pool(replicas=2) as pool:
        hs = [pool.submit(cohort_prompt(0, i),
                          GenerationParams(max_new_tokens=4))
              for i in range(8)]
        owner = hs[0].replica
        assert [h for h in hs if h.replica != owner], \
            "hot cohort never spilled to the idle sibling"
        pool.drain()


def test_sim_4_replicas_at_least_3x_throughput():
    cfg = SimConfig(max_decode_slots=4)
    params = GenerationParams(max_new_tokens=32)
    prompts = [[60 + i] * 24 for i in range(16)]
    with TurboClient.simulated(cost_model=CM, sim_config=cfg) as single:
        for p in prompts:
            single.submit(p, params)
        single.drain()
        t1 = single.clock()
    with sim_pool(replicas=4, sim_config=cfg) as pool:
        for p in prompts:
            pool.submit(p, params)
        done = pool.drain()
        t4 = pool.virtual_makespan()
    assert len(done) == 16
    assert t4 <= t1 / 3.0, f"4 replicas {t1 / t4:.2f}x over 1"


def test_queued_sessions_fail_over_and_finish():
    with sim_pool(replicas=2) as pool:
        hs = [pool.submit(cohort_prompt(0, i),
                          GenerationParams(max_new_tokens=4))
              for i in range(4)]
        victim = hs[0].replica
        pool.kill_replica(victim)
        assert pool.healthy_replicas() == [1 - victim]
        for h in hs:
            assert h.replica != victim
            assert len(h.result(timeout=5)) == len(h.session.prompt) + 4
        m = pool.metrics()["counters"]
        assert m["pool.failovers"] == 1
        assert m["pool.failover_resubmitted"] >= 1
        assert m["pool.routed"] == 4 + m["pool.failover_resubmitted"]
        assert m["pool.failed_sessions"] == 0


def test_decode_sessions_surface_replica_failure():
    with sim_pool(replicas=2) as pool:
        h0 = pool.submit([70] * 24, GenerationParams(max_new_tokens=64))
        h1 = pool.submit([80] * 24, GenerationParams(max_new_tokens=64))
        assert h0.replica != h1.replica
        while h0.session.state is not SessionState.DECODE:
            pool.replica(h0.replica).pump(max_ticks=1)
        pool.kill_replica(h0.replica)
        with pytest.raises(ReplicaFailure) as ei:
            h0.result(timeout=5)
        assert ei.value.req_id == h0.req_id
        assert ei.value.replica != h1.replica
        assert len(h1.result(timeout=5)) == 24 + 64
        assert pool.metrics()["counters"]["pool.failed_sessions"] == 1


def test_kill_last_replica_fails_remaining_sessions():
    with sim_pool(replicas=2) as pool:
        h = pool.submit([90] * 24, GenerationParams(max_new_tokens=4))
        pool.kill_replica(0)
        pool.kill_replica(1)
        assert pool.healthy_replicas() == []
        with pytest.raises(ReplicaFailure):
            h.result(timeout=5)
        with pytest.raises(RuntimeError, match="no healthy replicas"):
            pool.submit([1] * 24, GenerationParams(max_new_tokens=2))


def test_cancel_through_the_pool():
    with sim_pool(replicas=2) as pool:
        h = pool.submit([95] * 24, GenerationParams(max_new_tokens=64))
        assert h.cancel() is True
        assert h.cancel() is False
        assert h.session.cancelled
        pool.drain()


@pytest.mark.skipif(not HAVE_HYPOTHESIS, reason="hypothesis not installed")
@settings(max_examples=15, deadline=None, database=None)
@given(n=st.integers(min_value=1, max_value=10),
       pre_ticks=st.integers(min_value=0, max_value=12),
       victim=st.integers(min_value=0, max_value=2))
def test_failover_conservation(n, pre_ticks, victim):
    """Every submitted session finishes or fails exactly once across a
    replica kill — nothing hangs, nothing double-finishes."""
    with sim_pool(replicas=3) as pool:
        hs = [pool.submit(cohort_prompt(i % 2, i),
                          GenerationParams(max_new_tokens=6))
              for i in range(n)]
        pool.pump(max_ticks=pre_ticks)
        pool.kill_replica(victim)
        done = pool.drain()
        outcomes = {}
        for h in hs:
            try:
                h.result(timeout=5)
                outcomes[h.req_id] = "finished"
            except ReplicaFailure:
                outcomes[h.req_id] = "failed"
        assert len(outcomes) == n
        finished = [s.req_id for s in done]
        assert sorted(finished) == sorted(set(finished))
        for h in hs:
            if outcomes[h.req_id] == "finished":
                assert h.session.is_finished
                assert h.replica != victim or pre_ticks > 0


def test_simulated_replicas_validation():
    with pytest.raises(ValueError, match="replicas"):
        TurboClient.simulated(replicas=0)
    with pytest.raises(ValueError, match="auto_pump"):
        TurboClient.simulated(replicas=2, auto_pump="thread")
    with pytest.raises(ValueError, match="replicas"):
        TurboClient.from_arch(ARCH, device="cpu", replicas=0)


def test_pool_trace_and_metrics_namespacing():
    with TurboClient.simulated(cost_model=CM, sim_config=SimConfig(),
                               replicas=2, trace=True) as pool:
        h = pool.submit(cohort_prompt(0, 0), GenerationParams(
            max_new_tokens=3))
        pool.submit(cohort_prompt(0, 1), GenerationParams(
            max_new_tokens=3))
        pool.kill_replica(1 - h.replica)    # idle sibling: no sessions
        pool.drain()
        m = pool.metrics()
        assert m["gauges"]["pool.replicas"] == 2
        assert m["gauges"]["pool.healthy"] == 1
        assert any(k.startswith("replica.0.pipeline.")
                   for k in m["counters"])
        events = pool.trace_events()
        assert {"route", "enqueue", "finish"} <= {e["name"] for e in events}
        routes = [e for e in events if e["name"] == "route"]
        assert all("replica" in e["args"] and "reason" in e["args"]
                   for e in routes)
        assert any(e["args"].get("replica") == h.replica
                   for e in events if e["name"] == "finish")


def test_pool_closed_rejects_submissions():
    pool = sim_pool(replicas=2)
    pool.close()
    with pytest.raises(RuntimeError, match="closed"):
        pool.submit([1] * 24, GenerationParams(max_new_tokens=2))


# ---------------------------------------------------------------------------
# Simulated pools: the port against the reference
# ---------------------------------------------------------------------------

def _sim_run(client_cls, params_cls, cost, kill_after):
    """Cohorts of three prefixes, distinct prompts and a long one into a
    3-replica simulated pool; one replica killed after ``kill_after``
    pool ticks (None: no kill).  Returns what the packages must agree
    on."""
    pool = client_cls.simulated(cost_model=cost, replicas=3,
                                sim_config=None)
    hs = []
    for i in range(15):
        prompt = cohort_prompt(i % 3, i) if i % 5 else [40 + i] * (20 + i)
        hs.append(pool.submit(prompt, params_cls(max_new_tokens=3 + i % 7)))
    placed = [h.replica for h in hs]
    failed = []
    if kill_after is not None:
        pool.pump(max_ticks=kill_after)
        pool.kill_replica(hs[0].replica)
    pool.drain()
    results = []
    for h in hs:
        try:
            results.append(h.result(timeout=5))
        except Exception as e:                   # the failure's kind
            failed.append(h.req_id)
            results.append(type(e).__name__)
    m = pool.metrics()
    out = {"placed": placed, "final": [h.replica for h in hs],
           "results": results, "failed": failed,
           "makespan": pool.virtual_makespan(),
           "pool_counters": {k: v for k, v in m["counters"].items()
                             if k.startswith("pool.")},
           "replica_counters": {k: v for k, v in m["counters"].items()
                                if k.startswith("replica.")},
           "health": pool.health()}
    pool.close()
    return out


@pytest.mark.parametrize("kill_after", [None, 0, 3, 9])
def test_simulated_pool_equals_reference(kill_after):
    from repro.api import GenerationParams as RefParams
    got = _sim_run(TurboClient, GenerationParams, CM, kill_after)
    want = _sim_run(JaxClient, RefParams, JCM, kill_after)
    assert got == want
    if kill_after is not None:
        assert got["pool_counters"]["pool.failovers"] == 1


# ---------------------------------------------------------------------------
# Real pools over bridged weights
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def engines():
    """One reference engine and one port engine over the same weights;
    every pool below shares them between its replicas, as the
    reference's own pool tests and CLI do."""
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jeng = JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER))
    peng = InferenceEngine(get_smoke_config(ARCH), tparams,
                           ladder=BucketLadder(**LADDER), device="cpu")
    return jeng, peng


def _pools(engines, n=2, auto_pump="sync", **backend_kw):
    jeng, peng = engines
    backend_kw.setdefault("max_slots", 4)
    backend_kw.setdefault("cap_new", 16)
    jpool = JaxPool([JaxClient(JaxContinuousEngine(jeng, **backend_kw),
                               cost_model=JCM) for _ in range(n)])
    pool = ReplicaPool([TurboClient(ContinuousEngine(peng, **backend_kw),
                                    cost_model=CM, auto_pump=auto_pump)
                        for _ in range(n)])
    return jpool, pool


def _mixed_work():
    """Two cohorts of three (a 32-token shared prefix, two blocks) and
    two cold prompts; every other request seeded-sampled."""
    rng = np.random.default_rng(5)
    heads, rest = [], []
    for g in range(2):
        pre = [int(t) for t in rng.integers(1, 250, 32)]
        for i in range(3):
            tail = [int(t) for t in rng.integers(1, 250, 2 + i)]
            (heads if i == 0 else rest).append(pre + tail)
    rest += [[int(t) for t in rng.integers(1, 250, n)] for n in (9, 27)]
    params = [dict(max_new_tokens=4 + i % 5,
                   temperature=0.8 if i % 2 else 0.0,
                   top_k=20 if i % 2 else 0,
                   top_p=0.9 if i % 2 else 1.0, seed=50 + i)
              for i in range(len(heads) + len(rest))]
    return heads, rest, params


def _serve_staged(pool, params_cls, heads, rest, params):
    """Cohort heads first and drained (their prefixes then sit in the
    owner's cache), then the rest."""
    hs = [pool.submit(p, params_cls(**g)) for p, g in zip(heads, params)]
    pool.drain()
    hs += [pool.submit(p, params_cls(**g))
           for p, g in zip(rest, params[len(heads):])]
    pool.drain()
    return hs, [h.result(timeout=60) for h in hs]


def test_real_pool_streams_equal_reference(engines):
    """Greedy and seeded streams, placements, per-replica prefix hits and
    the pool's counters equal the reference's real pool; the cohorts'
    members land on their head's replica and hit its cache; routing
    equals the simulated pool's on the same submissions."""
    heads, rest, params = _mixed_work()
    jpool, pool = _pools(engines, prefix_cache=True)
    with jpool, pool:
        jhs, want = _serve_staged(jpool, JaxParams, heads, rest, params)
        hs, got = _serve_staged(pool, GenerationParams, heads, rest, params)
        assert got == want
        assert [h.replica for h in hs] == [h.replica for h in jhs]
        hits = [pool.replica(i).backend.prefix_stats() for i in range(2)]
        jhits = [jpool.replica(i).backend.prefix_stats() for i in range(2)]
        assert hits == jhits

        def counters(p):
            return {k: v for k, v in p.metrics()["counters"].items()
                    if k.startswith("pool.")}
        assert counters(pool) == counters(jpool)
        assert pool._router.index_size == jpool._router.index_size > 0
        # members of each cohort sit with their head, and its cache hit
        for g in range(2):
            owner = hs[g].replica
            members = [hs[2 + 2 * g], hs[3 + 2 * g]]
            assert all(h.replica == owner for h in members)
            assert all(h.session.cached_tokens >= 32 for h in members)
        for i in range(2):
            mine = [h for h in hs if h.replica == i]
            assert hits[i]["hits"] == sum(
                1 for h in mine if h.session.cached_tokens)
    with sim_pool(replicas=2) as sp:
        sim_hs, _ = _serve_staged(sp, GenerationParams, heads, rest, params)
        assert [h.replica for h in sim_hs] == [h.replica for h in hs]


def test_real_failover_token_identity(engines):
    """A killed replica's queued sessions finish on the sibling with the
    tokens an unfailed run gives (greedy and seeded), and with the
    reference's pool's tokens."""
    jeng, peng = engines
    prompts = [[3 + i] * (20 + i) for i in range(4)]
    params = [dict(max_new_tokens=6, temperature=0.7 if i % 2 else 0.0,
                   top_k=10 if i % 2 else 0, seed=9 + i)
              for i in range(4)]
    with TurboClient(ContinuousEngine(peng, max_slots=4, cap_new=16),
                     cost_model=CM) as baseline:
        alone = [baseline.submit(p, GenerationParams(**g)).result()
                 for p, g in zip(prompts, params)]
    jpool, pool = _pools(engines)
    with jpool, pool:
        out = {}
        for name, p_, cls in (("ref", jpool, JaxParams),
                              ("port", pool, GenerationParams)):
            hs = [p_.submit(p, cls(**g)) for p, g in zip(prompts, params)]
            p_.kill_replica(hs[0].replica)
            out[name] = [h.result(timeout=60) for h in hs]
            assert all(h.replica == p_.healthy_replicas()[0] for h in hs)
            c = p_.metrics()["counters"]
            assert c["pool.failovers"] == 1 and \
                c["pool.failed_sessions"] == 0 and \
                c["pool.routed"] == len(prompts) + \
                c["pool.failover_resubmitted"]
    assert out["port"] == alone == out["ref"]


def test_shared_engine_under_two_pump_threads(engines):
    """Two thread-pumped replicas over ONE InferenceEngine (the
    reference CLI's pool): the engine's lock runs each device call from
    its cells' input write to the read of their outputs alone, so the
    streams equal the sync pool's."""
    heads, rest, params = _mixed_work()
    _, sync_pool = _pools(engines, prefix_cache=True)
    with sync_pool:
        _, want = _serve_staged(sync_pool, GenerationParams, heads, rest,
                                params)
    _, pool = _pools(engines, prefix_cache=True, auto_pump="thread")
    with pool:
        hs = [pool.submit(p, GenerationParams(**g))
              for p, g in zip(heads, params)]
        [h.result(timeout=60) for h in hs]
        hs += [pool.submit(p, GenerationParams(**g))
               for p, g in zip(rest, params[len(heads):])]
        got = [h.result(timeout=60) for h in hs]
        assert pool._watchdog is not None
    assert got == want


# ---------------------------------------------------------------------------
# Background warm-up
# ---------------------------------------------------------------------------

def _warm_engine(pkg):
    if pkg == "ref":
        cfg = jax_smoke_config(ARCH)
        return JaxInferenceEngine(cfg, jax_init_params(cfg,
                                                       jax.random.key(0)),
                                  ladder=JaxLadder(seq_buckets=(16, 32),
                                                   batch_buckets=(1, 2)))
    cfg = get_smoke_config(ARCH)
    cfg_j = jax_smoke_config(ARCH)
    tparams = params_from_numpy(
        jax.tree.map(np.asarray, jax_init_params(cfg_j, jax.random.key(0))),
        device="cpu")
    return InferenceEngine(cfg, tparams, ladder=BucketLadder(
        seq_buckets=(16, 32), batch_buckets=(1, 2)), device="cpu")


def _served_mid_warmup(pkg, at_round=2):
    """A background-warming client whose request is submitted from the
    warm-up thread at round ``at_round`` (deterministic, in both
    packages), so the round boundary's drain serves it between warm
    rounds.  Returns the client, the request's result and its stats."""
    ce_cls = JaxContinuousEngine if pkg == "ref" else ContinuousEngine
    client_cls = JaxClient if pkg == "ref" else TurboClient
    params_cls = JaxParams if pkg == "ref" else GenerationParams
    holder = {}

    class Hooked(ce_cls):
        def warmup_aot(self, progress=None):
            def hooked(rounds):
                if rounds == at_round:
                    holder["handle"] = holder["client"].submit(
                        [5, 6, 7, 8, 9], params_cls(max_new_tokens=4))
                    holder["submitted_in"] = threading.current_thread().name
                progress(rounds)
                if rounds == at_round:
                    holder["done_at_boundary"] = holder["handle"].done
            return super().warmup_aot(progress=hooked)

    backend = Hooked(_warm_engine(pkg), max_slots=2, cap_new=8)
    # the hook needs the client before its constructor starts the
    # warm-up thread
    client = client_cls.__new__(client_cls)
    holder["client"] = client
    client.__init__(backend, cost_model=JCM if pkg == "ref" else CM,
                    warmup="background")
    stats = client.wait_warmup(timeout=300)
    return client, holder, stats


def test_background_warmup_serves_between_rounds_like_reference():
    out = {}
    for pkg in ("ref", "port"):
        client, holder, stats = _served_mid_warmup(pkg)
        ce = client.backend
        out[pkg] = dict(
            result=holder["handle"].result(timeout=60),
            done_at_boundary=holder["done_at_boundary"],
            thread=holder["submitted_in"],
            stats={k: stats[k] for k in ("done", "rounds",
                                         "rounds_completed", "mode")},
            error=stats.get("error"),
            counters={k: getattr(ce, k) for k in
                      ("prefill_tokens", "decode_ticks", "cow_blocks")},
            dispatches={k: getattr(ce, k) for k in
                        ("prefill_dispatches", "pack_dispatches")},
            finished=[s.req_id for s in client.pipeline.finished],
            pipeline=dict(vars(client.pipeline.stats)))
        client.close()
    ref, port = out["ref"], out["port"]
    assert port["error"] is None and ref["error"] is None
    assert port["done_at_boundary"] and ref["done_at_boundary"]
    assert port["thread"] == "turbo-client-warmup"
    assert port["stats"]["done"] and \
        port["stats"]["rounds_completed"] == port["stats"]["rounds"]
    for key in ("result", "stats", "counters", "finished", "pipeline"):
        assert port[key] == ref[key], key
    # the warm-up's restore drops the served request's prefill tokens and
    # decode ticks in both packages; the port also restores its dispatch
    # counters (ROADMAP.md §3), which the reference lets the warm-up's
    # own rounds and the served request's add to
    assert port["counters"] == {"prefill_tokens": 0, "decode_ticks": 0,
                                "cow_blocks": 0}
    assert port["dispatches"] == {"prefill_dispatches": 0,
                                  "pack_dispatches": 0}
    assert ref["dispatches"]["prefill_dispatches"] > 0
    # the stream equals the request served by a cold client
    with TurboClient(ContinuousEngine(_warm_engine("port"), max_slots=2,
                                      cap_new=8), cost_model=CM) as cold:
        assert cold.submit([5, 6, 7, 8, 9], GenerationParams(
            max_new_tokens=4)).result() == port["result"]


def test_background_warmup_reports_progress_with_a_pump_thread():
    client = TurboClient(ContinuousEngine(_warm_engine("port"), max_slots=2,
                                          cap_new=8),
                         cost_model=CM, warmup="background",
                         auto_pump="thread")
    try:
        assert client.warmup_stats["mode"] == "background"
        h = client.submit([1, 2, 3], GenerationParams(max_new_tokens=2))
        assert len(h.result(timeout=120)) == 5
        stats = client.wait_warmup(timeout=300)
        assert stats["done"] is True and stats.get("error") is None
        assert stats["rounds_completed"] == stats["rounds"] > 0
        assert stats["compile_count"] == 0            # the CPU captures none
    finally:
        client.close()


def test_background_warmup_aborts_on_close():
    client = TurboClient(ContinuousEngine(_warm_engine("port"), max_slots=2,
                                          cap_new=8),
                         cost_model=CM, warmup="background")
    client.close()
    deadline = time.monotonic() + 60
    while not client.warmup_stats.get("done"):
        assert time.monotonic() < deadline
        time.sleep(0.01)
    assert client.warmup_stats.get("aborted") or \
        client.warmup_stats.get("rounds") is not None


# ---------------------------------------------------------------------------
# The collector hold and the device gate across threads
# ---------------------------------------------------------------------------

def test_collector_hold_is_released_by_the_last_of_two_threads():
    """Two threads hold the collector off; the first to leave leaves it
    off while the other still holds it, the last turns it back on."""
    gc.enable()
    a_in, b_in, a_out, b_go = (threading.Event() for _ in range(4))
    seen = {}

    def a():
        with graphs.collector_held():
            a_in.set()
            b_in.wait(5)
        a_out.set()

    def b():
        a_in.wait(5)
        with graphs.collector_held():
            b_in.set()
            a_out.wait(5)
            seen["after_a_left"] = gc.isenabled()
            b_go.wait(5)

    ta, tb = threading.Thread(target=a), threading.Thread(target=b)
    ta.start(), tb.start()
    a_out.wait(5)
    time.sleep(0.05)
    seen["main_while_b_holds"] = gc.isenabled()
    b_go.set()
    ta.join(5), tb.join(5)
    assert seen == {"after_a_left": False, "main_while_b_holds": False}
    assert gc.isenabled()
    # a collector the caller had off stays off
    gc.disable()
    try:
        with graphs.collector_held():
            pass
        assert not gc.isenabled()
    finally:
        gc.enable()


def test_device_gate_capture_waits_for_device_calls():
    """A capture waits until every other thread has left its device
    call, no new device call starts while it waits or runs, and a
    thread inside a device call can capture (its own hold lets go)."""
    gate = graphs.DeviceGate()
    log, in_call, release = [], threading.Event(), threading.Event()

    def ticker():
        with gate.shared():
            log.append("tick in")
            in_call.set()
            release.wait(5)
            log.append("tick out")

    def capturer():
        in_call.wait(5)
        with gate.shared():            # a device call that captures
            with gate.exclusive():
                log.append("capture")

    def late_call():
        with gate.shared():
            log.append("late call")

    t1, t2 = threading.Thread(target=ticker), threading.Thread(
        target=capturer)
    late = threading.Thread(target=late_call)
    t1.start(), t2.start()
    deadline = time.monotonic() + 5
    while gate._waiting != 1:          # the capture waits for the tick
        assert time.monotonic() < deadline
        time.sleep(0.001)
    late.start()                       # a new device call waits too
    time.sleep(0.05)
    assert log == ["tick in"]
    release.set()
    for t in (t1, t2, late):
        t.join(5)
    assert log == ["tick in", "tick out", "capture", "late call"]
    assert gate.captures_waited == 1 and gate._shared == 0


# ---------------------------------------------------------------------------
# The CLI
# ---------------------------------------------------------------------------

#: lines of the CLI that hold no wall-clock reading
DETERMINISTIC = ("replica pool:", "cohort", "killed replica",
                 "finished /", "lost mid-decode")


def test_cli_pool_phase_equals_reference(monkeypatch, capsys):
    args = ["serve", "--replicas", "2", "--num-requests", "6",
            "--gen-requests", "7", "--max-new-tokens", "6"]
    lines = {}
    for name, main, extra in (("ref", jax_serve.main, []),
                              ("port", port_serve.main,
                               ["--device", "cpu"])):
        monkeypatch.setattr("sys.argv", args + extra)
        main()
        out = capsys.readouterr().out.splitlines()
        lines[name] = [ln.strip() for ln in out
                       if any(k in ln for k in DETERMINISTIC)]
    assert lines["port"] == lines["ref"]
    assert any("7 finished / 0 failed" in ln for ln in lines["port"])
    assert any("failovers=1" in ln for ln in lines["port"])


def test_locks_and_counters_hold_under_thread_stress():
    """More threads than cores with a short switch interval: the client's
    FIFO lock loses no update (timed-out waits included), the device gate
    never lets a device call overlap a capture, and the launch counters
    lose no count."""
    import sys

    from repro_torch.api.client import _FairRLock
    from repro_torch.kernels import cuda_lib
    cv = threading.Condition(_FairRLock())
    gate = graphs.DeviceGate()
    state = {"n": 0, "timeouts": 0, "shared": 0, "writer": 0, "bad": 0}
    n_threads, rounds = 24, 150
    cuda_lib.reset_launches()

    def worker(i):
        for k in range(rounds):
            if k % 10 == 0 and not cv.acquire(timeout=1e-4):
                with cv:
                    state["timeouts"] += 1
            elif k % 10 == 0:
                cv.release()
            with cv:
                n = state["n"]
                time.sleep(0)
                state["n"] = n + 1
                if k % 7 == 0:
                    cv.wait(0)             # drops every recursion level
            if (i + k) % 13 == 0:
                with gate.shared(), gate.exclusive():
                    with cv:
                        state["writer"] += 1
                        state["bad"] += state["shared"] > 0
                    time.sleep(0)
                    with cv:
                        state["writer"] -= 1
            else:
                with gate.shared():
                    with cv:
                        state["shared"] += 1
                        state["bad"] += state["writer"] > 0
                    time.sleep(0)
                    with cv:
                        state["shared"] -= 1
            cuda_lib.add_launches({("stress", "x"): 1})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert state["n"] == n_threads * rounds
    assert state["bad"] == 0 and state["shared"] == state["writer"] == 0
    assert cuda_lib.LAUNCHES["stress"] == n_threads * rounds
    assert cuda_lib.LAUNCH_SHAPES[("stress", "x")] == n_threads * rounds
    assert gate._shared == 0 and gate._writer is None
    cuda_lib.reset_launches()
