"""The port's one-shot serving system against the JAX package's.

The schedulers, the policy switch, the request generator and
`ServingSystem` are copies; here they run side by side on the same
inputs.  Plans must be identical (the same batches, the same summed
cost, computed by the same float operations in the same order), the
generator must draw the same requests from a seed, and a ServingSystem
on a virtual clock, executing through each package's own
`InferenceEngine.execute_requests` on bridged smoke weights, must give
the same responses: classes, batch sizes, padded lengths and finish
times.
"""
import jax
import numpy as np
import pytest

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import pipeline as jpipeline
from repro.core import scheduler as jscheduler
from repro.core.cost_model import BucketedCostModel as JaxBucketed
from repro.core.cost_model import TableCostModel as JaxTable
from repro.core.serving import Request as JaxRequest
from repro.core.serving import ServingConfig as JaxServingConfig
from repro.core.serving import ServingSystem as JaxServingSystem
from repro.data.pipeline import LengthDistribution as JaxLengths
from repro.data.pipeline import RequestGenerator as JaxGenerator
from repro.models import init_params as jax_init_params
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core import pipeline, scheduler
from repro_torch.core.cost_model import BucketedCostModel, TableCostModel
from repro_torch.core.serving import Request, ServingConfig, ServingSystem
from repro_torch.data import LengthDistribution, RequestGenerator
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import InferenceEngine

ARCH = "internlm2-1.8b"
SEQ_BUCKETS = (32, 64)
LADDER = dict(seq_buckets=SEQ_BUCKETS, batch_buckets=(1, 2, 4, 8))


def _table():
    """A warm-up-shaped cost table: a fixed cost per pass plus a part that
    grows with the padded tokens, sub-linearly in the batch."""
    return {(ln, b): 2e-3 + 4e-6 * ln * b ** 0.7
            for ln in SEQ_BUCKETS for b in (1, 2, 4, 8)}


def _plan(mod, pipe, policy, lengths, cost, max_batch):
    if policy == "brute_force":
        return mod.brute_force_schedule(lengths, cost)
    return pipe.plan_for_policy(policy, lengths, cost, max_batch)


@pytest.mark.parametrize("policy", ["dp", "naive", "nobatch",
                                    "brute_force"])
@pytest.mark.parametrize("seed,max_batch", [(0, None), (1, 3), (2, 4)])
def test_schedulers_plan_as_the_reference(policy, seed, max_batch):
    rng = np.random.default_rng(seed)
    lengths = [int(n) for n in rng.integers(5, 64, 9)]
    ours = BucketedCostModel(TableCostModel(_table()), buckets=SEQ_BUCKETS)
    theirs = JaxBucketed(JaxTable(_table()), buckets=SEQ_BUCKETS)
    got = _plan(scheduler, pipeline, policy, lengths, ours, max_batch)
    want = _plan(jscheduler, jpipeline, policy, lengths, theirs, max_batch)
    assert got.batches == want.batches
    assert got.total_cost == want.total_cost
    assert got.num_batches == want.num_batches
    if policy == "dp" and max_batch is None:
        best = scheduler.brute_force_schedule(lengths, ours)
        assert got.total_cost == pytest.approx(best.total_cost)


@pytest.mark.parametrize("kind,lo,hi", [("uniform", 5, 500),
                                        ("bimodal", 5, 200),
                                        ("fixed", 5, 64)])
def test_request_generator_draws_the_reference_requests(kind, lo, hi):
    ours = RequestGenerator(rate=200.0, lengths=LengthDistribution(kind, lo,
                                                                   hi),
                            vocab_size=92544, seed=3).generate(0.2)
    theirs = JaxGenerator(rate=200.0, lengths=JaxLengths(kind, lo, hi),
                          vocab_size=92544, seed=3).generate(0.2)
    assert len(ours) == len(theirs) > 10
    assert [(r.req_id, r.seq_len, r.arrival_time, r.payload)
            for r in ours] == [(r.req_id, r.seq_len, r.arrival_time,
                                r.payload) for r in theirs]


@pytest.fixture(scope="module")
def engines():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jeng = JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER))
    teng = InferenceEngine(get_smoke_config(ARCH), tparams,
                           ladder=BucketLadder(**LADDER), device="cpu")
    return jeng, teng


class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _serve(system_cls, config_cls, request_cls, cost, execute, policy,
           requests, **config_kw):
    """Replay ``requests`` at their arrival times on a virtual clock that
    each executed batch advances by its cost-model latency."""
    clock = _Clock()

    def timed(batch, padded_len):
        out = execute(batch, padded_len)
        clock.t += cost.latency(padded_len, len(batch))
        return out
    system = system_cls(execute=timed, cost_model=cost, clock=clock,
                        config=config_cls(policy=policy, max_batch_size=8,
                                          **config_kw))
    i = 0
    while i < len(requests) or not system.pipeline.idle():
        while i < len(requests) and requests[i].arrival_time <= clock.t:
            r = requests[i]
            system.submit(request_cls(r.req_id, r.seq_len, r.arrival_time,
                                      r.payload))
            i += 1
        if system.pipeline.idle():
            if i == len(requests):             # the last ones hit the cache
                break
            clock.t = requests[i].arrival_time
            continue
        system.step()
    responses = sorted((r.req_id, r.result, r.batch_size, r.padded_len,
                        r.finish_time, r.cached) for r in system.responses)
    return responses, system.cache.hits, system.cache.misses


@pytest.mark.parametrize("policy", ["dp", "naive", "nobatch"])
def test_serving_system_responds_as_the_reference(engines, policy):
    jeng, teng = engines
    requests = RequestGenerator(rate=400.0,
                                lengths=LengthDistribution("uniform", 5, 60),
                                vocab_size=256, seed=1).generate(0.05)
    assert len(requests) >= 12
    got, _, _ = _serve(ServingSystem, ServingConfig, Request,
                       BucketedCostModel(TableCostModel(_table()),
                                         buckets=SEQ_BUCKETS),
                       teng.execute_requests, policy, requests)
    want, _, _ = _serve(JaxServingSystem, JaxServingConfig, JaxRequest,
                        JaxBucketed(JaxTable(_table()), buckets=SEQ_BUCKETS),
                        jeng.execute_requests, policy, requests)
    assert got == want
    assert len(got) == len(requests)
    if policy != "nobatch":
        assert max(r[2] for r in got) > 1              # batching happened


@pytest.mark.parametrize("capacity", [4096, 2])
def test_response_cache_hits_as_the_reference(engines, capacity):
    """With the cache on, repeats of earlier payloads that arrive after
    those finished are answered from the cache (up to its capacity, LRU)
    with the same results, hits and misses as the reference's."""
    jeng, teng = engines
    first = RequestGenerator(rate=400.0,
                             lengths=LengthDistribution("uniform", 5, 60),
                             vocab_size=256, seed=2).generate(0.03)
    later = first[-1].arrival_time + 1.0
    repeats = [Request(len(first) + k, r.seq_len, later + 1e-3 * k,
                       r.payload) for k, r in enumerate(first[:5])]
    requests = first + repeats
    got = _serve(ServingSystem, ServingConfig, Request,
                 BucketedCostModel(TableCostModel(_table()),
                                   buckets=SEQ_BUCKETS),
                 teng.execute_requests, "dp", requests, enable_cache=True,
                 cache_capacity=capacity)
    want = _serve(JaxServingSystem, JaxServingConfig, JaxRequest,
                  JaxBucketed(JaxTable(_table()), buckets=SEQ_BUCKETS),
                  jeng.execute_requests, "dp", requests, enable_cache=True,
                  cache_capacity=capacity)
    assert got == want
    responses, hits, _ = got
    assert len(responses) == len(requests)
    assert hits == sum(r[5] for r in responses)
    if capacity >= len(requests):
        assert hits == len(repeats)
        by_id = {r[0]: r[1] for r in responses}
        assert all(by_id[q.req_id] == by_id[q.req_id - len(first)]
                   for q in repeats)
