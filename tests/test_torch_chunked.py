"""The port's chunked prefill against the JAX package's.

A prompt longer than one chunk, admitted while others decode, becomes a
resumable PREFILL: its chunks run through `prefill_suffix` at the
previous chunk's seam (per group) or ride the packed dispatch as
segments with their own prefix as prefix keys (packed, beside queued
admissions).  Here both packages serve the same workloads on bridged
weights on the CPU in f32, with chunking on, with the prefix cache too,
packed and per group: streams must equal token for token (greedy and
seeded-sampled), and the chunk, pack and veto counters must equal.  The
chunk-size helper is held to the reference's on the same cost model.
Last, the mix of prefix hits, chunks and packs on which the reference's
admission raises (its property test's replayed example) is served by the
port, whose planner vetoes the batch instead.
"""
import pytest

from repro.api import TurboClient as JaxClient
from repro.core import AnalyticCostModel as JaxCostModel
from repro.core.cost_model import \
    chunk_tokens_for_budget as jax_chunk_tokens
from repro.core.cost_model import prefix_fresh_blocks as jax_fresh_blocks
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.core.cost_model import (chunk_tokens_for_budget,
                                         prefix_fresh_blocks)
from repro_torch.runtime.engine import ContinuousEngine
from repro_torch.runtime.session import SessionState
from tests.test_torch_prefix import (COST, _engine, _jax_engine, _serve,
                                     _workload, assert_drained, counters,
                                     serve_both, weights)

__all__ = ["weights"]          # the module-scoped fixture, shared

LONG = [(i * 7) % 50 + 2 for i in range(40)]


@pytest.mark.parametrize("factor", [0.5, 1.0, 4.0, 32.0])
def test_chunk_tokens_for_budget_matches_reference(factor):
    jcm, cm = JaxCostModel(**COST), AnalyticCostModel(**COST)
    for ctx in (16, 80, 400):
        budget = factor * cm.decode_latency(4, ctx)
        assert budget == factor * jcm.decode_latency(4, ctx)
        for quantum, cap in ((16, 4096), (16, 40), (64, 1024)):
            got = chunk_tokens_for_budget(cm, budget, quantum, cap)
            assert got == jax_chunk_tokens(jcm, budget, quantum, cap)
            assert got % quantum == 0 and got >= quantum
    for total, cached in ((40, 0), (40, 16), (40, 20), (33, 32)):
        assert prefix_fresh_blocks(total, cached, 16) == \
            jax_fresh_blocks(total, cached, 16)


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
@pytest.mark.parametrize("prefix_cache", [False, True],
                         ids=["chunked", "chunked_prefix"])
@pytest.mark.parametrize("seed", [5, 6])
def test_chunked_client_streams_match_reference(weights, seed, prefix_cache,
                                                packed):
    """Greedy and seeded-sampled streams with ``chunked_prefill=True``
    (and the prefix cache on or off) equal the reference client's token
    for token; chunked prefills, chunk ticks, pack dispatches, the
    ``pack_wait`` veto and every prefix counter equal the reference's."""
    work = _workload(seed, n=10)
    jclient, client, want, got, handles = serve_both(
        weights, work, packed=packed, chunked=True,
        prefix_cache=prefix_cache)
    assert got == want
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    assert counters(client) == counters(jclient)
    assert client.pipeline.stats.chunked_prefills > 0
    ce = client.backend
    if packed:
        # a pack carried a chunk segment: more segments than admissions
        assert ce.pack_segments > client.pipeline.stats.admitted - \
            client.pipeline.stats.chunked_prefills
    if prefix_cache:
        assert_drained(ce)
    else:
        assert ce.block_table.used_blocks == 0 and not ce._chunk_slots


def _chunked_client(tparams, *, packed=True, prefix_cache=False,
                    fused=True, **kw):
    ce = ContinuousEngine(_engine(tparams), max_slots=4, cap_new=16,
                          packed_prefill=packed, prefix_cache=prefix_cache,
                          **kw)
    return TurboClient(ce, cost_model=AnalyticCostModel(**COST),
                       config=PipelineConfig(
                           policy="dp", max_batch_size=4,
                           chunked_prefill=True, prefill_chunk_tokens=16,
                           fused_chunk_decode=fused))


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
def test_chunked_long_prompt_equals_its_generation_alone(weights, packed):
    """The long prompt, chunked mid-decode, splices only after its final
    chunk and generates what it generates alone; the short one keeps
    emitting between chunks; fused and unfused chunk turns give the same
    tokens."""
    _, _, tparams = weights
    work = [([1, 2, 3], dict(max_new_tokens=10)),
            (LONG, dict(max_new_tokens=6)), ([9, 8, 7], dict(max_new_tokens=8))]
    results = {}
    for fused in (True, False):
        client = _chunked_client(tparams, packed=packed, fused=fused)
        handles, results[fused] = _serve(client, GenerationParams, work,
                                         first=1, ticks=2)
        stats = client.pipeline.stats
        assert stats.chunked_prefills == 1 and stats.chunk_ticks >= 2
        long_s = handles[1].session
        assert long_s.prefilled_tokens == long_s.seq_len
        assert handles[0].session.tokens_emitted == 10
    assert results[True] == results[False]
    eng = client.backend.engine
    assert results[True][1] == eng.generate([LONG], max_new_tokens=6)[0]


def test_chunked_composes_with_a_warm_prefix(weights):
    """Over a warm cache the resumable prefill starts after the cached
    prefix (its tail copied) and still generates the cold stream."""
    _, _, tparams = weights
    client = _chunked_client(tparams, prefix_cache=True)
    ce = client.backend
    client.submit(LONG, GenerationParams(max_new_tokens=2)).result()
    short = client.submit([1, 2, 3], GenerationParams(max_new_tokens=10))
    client.pump(max_ticks=2)
    hit = client.submit(list(LONG), GenerationParams(max_new_tokens=6))
    assert hit.result() == ce.engine.generate([LONG], max_new_tokens=6)[0]
    short.result()
    assert hit.session.cached_tokens > 0 and ce.cow_blocks > 0
    assert_drained(ce)


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
def test_cancel_mid_chunked_prefill_frees_everything(weights, packed):
    _, _, tparams = weights
    client = _chunked_client(tparams, packed=packed, prefix_cache=True)
    ce = client.backend
    short = client.submit([1, 2, 3], GenerationParams(max_new_tokens=12))
    client.pump(max_ticks=2)
    long_h = client.submit(LONG, GenerationParams(max_new_tokens=6))
    for _ in range(20):
        client.pump(max_ticks=1)
        if long_h.session.state is SessionState.PREFILL and \
                0 < long_h.session.prefilled_tokens < len(LONG):
            break
    assert long_h.session in client.pipeline.chunking
    assert long_h.cancel()
    assert long_h.session.req_id not in ce._chunk_slots
    assert short.result() == ce.engine.generate([[1, 2, 3]],
                                                max_new_tokens=12)[0]
    assert_drained(ce)


# ---------------------------------------------------------------------------
# The reference's admission fault, driven against the port
# ---------------------------------------------------------------------------

def _fault_mix():
    """The example the reference's property test replays: two identical
    2-token prompts and two long ones, all greedy."""
    specs = [("short", 2, 2), ("short", 2, 2), ("long", 2, 2),
             ("long", 7, 8)]
    built = []
    for kind, n, m in specs:
        if kind == "short":
            prompt = [(n * 3 + i) % 50 + 1 for i in range(n)]
        else:
            prompt = [(i * 5 + n) % 50 + 1 for i in range(34 + n)]
        built.append((prompt, dict(max_new_tokens=m)))
    return built


@pytest.mark.parametrize("packed", [False, True],
                         ids=["per_group", "packed"])
def test_admission_fault_mix_is_vetoed_not_raised(weights, packed):
    """Prefix hits, chunks and packs on the lazily sized pool (8 usable
    blocks): the first short prompt donates its 2-token tail, so the
    second's match pins that cached block AND takes a fresh one for its
    copy.  The reference's planner charges one block for it and its
    engine raises "needs 8 fresh KV blocks ... pool has 7 free" on the
    per-group path; the port's planner charges both, vetoes the long
    prompt for capacity, and serves every request as it runs alone."""
    jcfg, jparams, tparams = weights
    work = _fault_mix()
    opts = dict(max_slots=4, cap_new=16, prefix_cache=True,
                packed_prefill=packed)
    pipe = dict(policy="dp", max_batch_size=4, chunked_prefill=True,
                prefill_chunk_tokens=16)
    if not packed:
        jclient = JaxClient(JaxContinuousEngine(_jax_engine(jcfg, jparams),
                                                **opts),
                            cost_model=JaxCostModel(**COST),
                            config=JaxPipelineConfig(**pipe), warmup=False)
        with pytest.raises((RuntimeError, ValueError),
                           match="planner should have vetoed"):
            _serve(jclient, JaxParams, work, first=1, ticks=2)
    client = TurboClient(ContinuousEngine(_engine(tparams), **opts),
                         cost_model=AnalyticCostModel(**COST),
                         config=PipelineConfig(**pipe))
    handles, got = _serve(client, GenerationParams, work, first=1, ticks=2)
    ce = client.backend
    assert all(h.session.error is None for h in handles)
    vetoes = client.pipeline.obs.metrics.counter("pipeline.veto.capacity")
    assert vetoes.value > 0
    for (prompt, g), res in zip(work, got):
        assert res == ce.engine.generate([prompt], **g)[0]
    assert ce.prefix_stats()["hits"] > 0
    assert_drained(ce)
