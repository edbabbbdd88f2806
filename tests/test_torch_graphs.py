"""The port's decode-tick cells and ``sync_every`` against the JAX
package's, on the CPU.

The reference runs each decode tick as one compiled cell per ``sampling``
flag, counted in ``compile_count`` and warmed by ``warmup_aot``, and syncs
the host every ``sync_every`` ticks.  The port replays one CUDA graph of
its in-place tick per cell on the card; on the CPU it runs the same
in-place tick eagerly, so these tests hold the code the card captures:

- ``ContinuousEngine.__init__`` takes the reference's parameters in the
  reference's order, ``sync_every`` among them;
- with ``sync_every`` 1 and 3, greedy and seeded-sampled client streams
  and the pipeline's counters equal the reference's, and a session that a
  deferred sync finishes behind a prefill is still collected (the port's
  mirror of the reference's test of it);
- the in-place tick is bit-equal to ``decode_step_batch`` tick by tick,
  over admissions, finishes, block appends, copy-on-write and a cancel,
  on both layouts and both variants, and every write between ticks keeps
  the state's tensors (the graph's key) in place;
- ``warmup_aot`` returns the reference's keys and leaves the serving
  counters as it found them; ``engine.compile_count`` is published and a
  rise in it becomes the pipeline's ``compile`` trace event; on the CPU
  no graph is captured and the count says so;
- both capture methods hold Python's cyclic collector off while they
  capture (a collection there may destroy another graph and invalidate
  the capture), with torch.cuda's capture calls stood in for on the CPU.
"""
import contextlib
import dataclasses
import gc
import inspect
import weakref

import jax
import numpy as np
import pytest
import torch

from repro.api import TurboClient as JaxClient
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AnalyticCostModel as JaxCostModel
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import init_params as jax_init_params
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.core.pipeline import ServingPipeline
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import (ContinuousEngine, GenState,
                                        InferenceEngine)
from repro_torch.runtime import graphs
from repro_torch.runtime.graphs import CONTROL, signature
from repro_torch.runtime.session import Session

ARCH = "internlm2-1.8b"
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(1, 2, 4))
#: one cost model, spelled out in full for both packages, so both
#: pipelines make the same scheduling decisions
COST = dict(flops_per_token=1e6, bytes_per_token=1e3, weight_bytes=1e6,
            overhead=1e-4, peak_flops=197e12, hbm_bw=819e9)
#: the engine counters a warm-up must leave as it found them
SERVING_COUNTERS = ("prefill_tokens", "prefill_dispatches", "decode_ticks",
                    "cow_blocks", "pack_dispatches", "pack_segments")


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


def _engine(tparams, ladder=LADDER):
    return InferenceEngine(get_smoke_config(ARCH), tparams,
                           ladder=BucketLadder(**ladder), device="cpu")


def _workload(seed, n=8, sampled_every=3, top=64):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(2, 40))
        sampled = bool(sampled_every) and i % sampled_every == 1
        out.append(([int(t) for t in rng.integers(1, 256, plen)], dict(
            max_new_tokens=int(rng.integers(3, min(20, top - plen))),
            temperature=0.9 if sampled else 0.0,
            top_k=20 if sampled else 0, top_p=0.9 if sampled else 1.0,
            seed=100 + i)))
    return out


def _serve(client, make_params, work, first=3, ticks=3):
    handles = [client.submit(p, make_params(**g)) for p, g in work[:first]]
    client.pump(max_ticks=ticks)
    handles += [client.submit(p, make_params(**g)) for p, g in work[first:]]
    return handles, [h.result() for h in handles]


def _counters(client):
    ce, pipe = client.backend, client.pipeline
    return {"decode_ticks": ce.decode_ticks,
            "prefill_dispatches": ce.prefill_dispatches,
            "pack_dispatches": ce.pack_dispatches,
            "prefill_tokens": ce.prefill_tokens,
            "stats": pipe.stats.__dict__, "batches": pipe.batch_log}


# ---------------------------------------------------------------------------
# sync_every
# ---------------------------------------------------------------------------

def test_continuous_engine_takes_the_reference_parameters_in_order():
    """A positional call in the reference's order binds the same
    parameters: ``sync_every`` sits between ``cap_new`` and ``clock``."""
    def params(cls):
        return [(p.name, p.kind, p.default) for p in
                inspect.signature(cls.__init__).parameters.values()]
    assert params(ContinuousEngine) == params(JaxContinuousEngine)
    names = [p[0] for p in params(ContinuousEngine)]
    assert names.index("sync_every") == names.index("cap_new") + 1
    assert names.index("clock") == names.index("sync_every") + 1


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("sync_every", [1, 3])
def test_sync_every_streams_and_counters_match_reference(weights, sync_every,
                                                         sampled):
    """Streams, engine counters and the pipeline's scheduling counters
    equal the reference client's at the same ``sync_every``: a deferred
    sync delays when a finish is seen, in both packages alike."""
    jcfg, jparams, tparams = weights
    work = _workload(5, sampled_every=3 if sampled else 0)
    opts = dict(max_slots=4, cap_new=24, sync_every=sync_every)
    pipe = dict(policy="dp", max_batch_size=4)
    jclient = JaxClient(
        JaxContinuousEngine(JaxInferenceEngine(
            jcfg, jparams, ladder=JaxLadder(**LADDER)), **opts),
        cost_model=JaxCostModel(**COST), config=JaxPipelineConfig(**pipe),
        warmup=False)
    _, want = _serve(jclient, JaxParams, work)
    client = TurboClient(ContinuousEngine(_engine(tparams), **opts),
                         cost_model=AnalyticCostModel(**COST),
                         config=PipelineConfig(**pipe))
    handles, got = _serve(client, GenerationParams, work)
    assert got == want
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    assert _counters(client) == _counters(jclient)
    ce = client.backend
    assert ce.block_table.used_blocks == 0
    assert ce.engine.kv_slab.live_bytes == 0


def test_deferred_sync_does_not_lose_responses(weights):
    """The port's mirror of the reference's regression test: with
    ``sync_every`` 4 a session finished on the device is first seen by
    the sync that trails the NEXT prefill; the pipeline still collects
    it, and its result equals ``generate`` alone."""
    _, _, tparams = weights
    engine = _engine(tparams)
    ce = ContinuousEngine(engine, max_slots=4, cap_new=16, sync_every=4)
    pipe = ServingPipeline(ce, AnalyticCostModel(**COST),
                           PipelineConfig(policy="dp"))
    a = Session(0, 3, 0.0, prompt=[1, 2, 3], max_new_tokens=2)
    pipe.submit(a)
    finished = pipe.tick()               # prefill A
    finished += pipe.tick()              # decode: A done, not synced
    assert not a.is_finished
    b = Session(1, 2, 0.0, prompt=[9, 7], max_new_tokens=6)
    pipe.submit(b)
    finished += pipe.tick()              # prefill B; its sync finishes A
    assert a.is_finished
    finished += pipe.drain()
    assert sorted(s.req_id for s in finished) == [0, 1]
    assert a.result == engine.generate([[1, 2, 3]], max_new_tokens=2)[0]
    assert b.result == engine.generate([[9, 7]], max_new_tokens=6)[0]
    assert engine.kv_slab.live_bytes == 0


# ---------------------------------------------------------------------------
# The in-place tick the card captures
# ---------------------------------------------------------------------------

def _clone(state: GenState) -> GenState:
    return GenState(
        cache={k: v.clone() for k, v in state.cache.items()},
        **{n: getattr(state, n).clone() for n in CONTROL},
        sampling=state.sampling)


SYS = [(7 * i) % 200 + 3 for i in range(20)]   # a block and 4 tokens


def _tick_workload(rng, sampled: bool, layout: str):
    """Ten requests in two waves: prompts sharing SYS (the prefix cache
    copies its donated tail on the first decode write), cold ones, and on
    the contiguous layout a late long prompt that grows the slot cache."""
    out = []
    for i in range(10):
        if layout == "paged" and i % 3 == 0:
            prompt = SYS + [int(t) for t in rng.integers(1, 256, 1 + i)]
        else:
            prompt = [int(t) for t in rng.integers(1, 256,
                                                   int(rng.integers(2, 14)))]
        budget = int(rng.integers(14, 25))
        if layout == "contiguous" and i < 4:
            budget = min(budget, 32 - len(prompt))   # the first slot cache
        if layout == "contiguous" and i == 7:
            prompt = [int(t) for t in rng.integers(1, 256, 30)]
        out.append((prompt, GenerationParams(
            max_new_tokens=budget,
            temperature=0.9 if sampled and i % 2 else 0.0,
            top_k=20, top_p=0.9, seed=300 + i)))
    return out


@pytest.mark.parametrize("sampled", [False, True],
                         ids=["greedy", "sampled"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_inplace_tick_is_bit_equal_to_decode_step_batch(weights, layout,
                                                        sampled):
    """Every tick of a serving run, with admissions, finishes, block
    appends, copy-on-write, a cancel (and on the contiguous layout a grow)
    between ticks: the engine's in-place tick leaves the state bit-equal
    to ``decode_step_batch`` on a copy of it, writes into the tensors it
    read, and nothing between two ticks replaces a state tensor except
    the contiguous grow."""
    _, _, tparams = weights
    kw = dict(prefix_cache=True) if layout == "paged" \
        else dict(kv_layout="contiguous", max_len=32)
    ce = ContinuousEngine(_engine(tparams), max_slots=4, cap_new=24, **kw)
    client = TurboClient(ce, cost_model=AnalyticCostModel(**COST),
                         config=PipelineConfig(policy="dp",
                                               max_batch_size=4))
    eng = ce.engine
    real = ce._run_tick
    seen = []                  # (sampling, max_len) of every tick
    last = {}

    def checked():
        st = ce.state
        sig = signature(st)
        if last and last["max_len"] == ce.max_len:
            assert sig == last["sig"], "a write between ticks moved a tensor"
        want = eng.decode_step_batch(_clone(st))
        real()
        assert signature(st) == sig, "the tick did not write in place"
        for key in ("len", "k", "v"):
            assert torch.equal(st.cache[key], want.cache[key]), key
        for name in ("cur", "emitted", "counts", "done"):
            assert torch.equal(getattr(st, name), getattr(want, name)), name
        seen.append((st.sampling, ce.max_len))
        last.update(sig=sig, max_len=ce.max_len)

    ce._run_tick = checked
    rng = np.random.default_rng(7 if sampled else 8)
    work = _tick_workload(rng, sampled, layout)
    handles = [client.submit(p, g) for p, g in work[:4]]
    client.pump(max_ticks=4)
    handles[1].cancel()                          # mid-decode
    handles += [client.submit(p, g) for p, g in work[4:]]
    kept = [i for i in range(len(work)) if i != 1]
    results = [handles[i].result() for i in kept]
    assert len(seen) >= 40
    assert any(s for s, _ in seen) == sampled
    assert [len(r) for r in results] == \
        [len(work[i][0]) + work[i][1].max_new_tokens for i in kept]
    if layout == "paged":
        assert ce.cow_blocks > 0
    else:
        assert seen[0][1] == 32 and seen[-1][1] == 64   # grew mid-serve
    assert eng.compile_count == 0 and len(ce.tick_cells) == 0
    assert eng.kv_slab.live_bytes == 0


# ---------------------------------------------------------------------------
# warmup_aot and compile_count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_warmup_aot_returns_reference_keys_and_keeps_counters(weights,
                                                              layout):
    """After some serving, a warm-up returns what the reference's does
    (``compile_count``, ``warmup_seconds``, ``rounds``: as many rounds as
    the reference's warm-up after the same serving), leaves every
    serving counter as it was and the sampling flag off; the streams
    after it equal ``generate`` alone.  On the CPU it captures nothing."""
    jcfg, jparams, tparams = weights
    opts = dict(max_slots=4, cap_new=24, kv_layout=layout)
    pipe = dict(policy="dp", max_batch_size=4)
    ce = ContinuousEngine(_engine(tparams), **opts)
    client = TurboClient(ce, cost_model=AnalyticCostModel(**COST),
                         config=PipelineConfig(**pipe))
    jce = JaxContinuousEngine(JaxInferenceEngine(
        jcfg, jparams, ladder=JaxLadder(**LADDER)), **opts)
    jclient = JaxClient(jce, cost_model=JaxCostModel(**COST),
                        config=JaxPipelineConfig(**pipe), warmup=False)
    work = _workload(9, n=5)
    _serve(jclient, JaxParams, work)
    _serve(client, GenerationParams, work)
    before = {k: getattr(ce, k) for k in SERVING_COUNTERS}
    assert before["decode_ticks"] > 0
    stats = ce.warmup_aot()
    assert set(stats) == {"compile_count", "warmup_seconds", "rounds"}
    assert stats["compile_count"] == 0
    assert stats["rounds"] == jce.warmup_aot()["rounds"] > 2
    assert stats["warmup_seconds"] > 0 and ce.warmup_stats == stats
    assert {k: getattr(ce, k) for k in SERVING_COUNTERS} == before
    assert not ce.state.sampling and bool(ce.state.done.all())
    greedy = [(p, dict(g, temperature=0.0)) for p, g in _workload(10, n=3)]
    _, got = _serve(client, GenerationParams, greedy, first=3)
    for (prompt, g), res in zip(greedy, got):
        assert res == ce.engine.generate(
            [prompt], max_new_tokens=g["max_new_tokens"])[0]


def test_compile_count_gauge_and_trace_event(weights):
    """``observe_metrics`` publishes ``engine.compile_count``, and the
    pipeline turns a rise in it into one ``compile`` trace event.  A stub
    tick counts one cell on its first call, as a capture on the card
    does."""
    _, _, tparams = weights
    ce = ContinuousEngine(_engine(tparams), max_slots=4, cap_new=24)
    client = TurboClient(ce, cost_model=AnalyticCostModel(**COST),
                         trace=True)
    real = ce._run_tick

    def first_hit_capture():
        if ce.decode_ticks == 0:
            ce.engine.compile_count += 1
        real()

    ce._run_tick = first_hit_capture
    _serve(client, GenerationParams, _workload(11, n=4))
    assert client.metrics()["gauges"]["engine.compile_count"] == 1
    compiles = [e for e in client.trace_events() if e["name"] == "compile"]
    assert len(compiles) == 1 and compiles[0]["args"] == {"n": 1}


def test_no_graph_on_the_cpu(weights):
    """The device decides: on the CPU every tick runs eagerly, no cell is
    captured by serving or by ``warmup_aot``, and the published count
    reads 0."""
    _, _, tparams = weights
    ce = ContinuousEngine(_engine(tparams), max_slots=4, cap_new=24)
    client = TurboClient(ce, cost_model=AnalyticCostModel(**COST),
                         warmup=True)
    assert client.warmup_stats["compile_count"] == 0
    _serve(client, GenerationParams, _workload(12, n=4))
    assert ce.decode_ticks > 0
    assert ce.engine.compile_count == 0
    assert len(ce.tick_cells) == 0 and ce.tick_cells.captures == 0
    assert ce.tick_cells.warm_ticks == 0
    cells = ce.engine.prefill_cells
    assert len(cells) == 0 and cells.captures == 0 and cells.keys()
    assert client.metrics()["gauges"]["engine.compile_count"] == 0


# ---------------------------------------------------------------------------
# Captures hold Python's cyclic collector off
# ---------------------------------------------------------------------------


class _Stream:
    def wait_stream(self, other) -> None:
        pass


@dataclasses.dataclass
class _State:
    """What a tick capture reads of a GenState."""
    cache: dict
    cur: torch.Tensor
    emitted: torch.Tensor
    counts: torch.Tensor
    done: torch.Tensor


@pytest.fixture
def fake_capture(monkeypatch):
    """torch.cuda's capture calls replaced by stand-ins that run on the
    CPU; returns the list of ``gc.isenabled()`` seen inside each
    capture."""
    seen = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None):
        seen.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", object)
    monkeypatch.setattr(torch.cuda, "Stream", lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: _Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: (0, 0))
    monkeypatch.setattr(graphs, "reserve_tickets", lambda dev, n: None)
    return seen


def _capture_both(fail: bool):
    """A cell capture and a tick capture whose captured call raises where
    ``fail``."""
    calls = []

    def body(ins, outs):
        calls.append(1)
        if fail and len(calls) % 2 == 0:     # the captured call
            raise RuntimeError("capture failed")

    arena = graphs.CellArena(torch.device("cpu"))
    table = graphs.CellTable(arena, lambda: ())
    cell = graphs.Cell("key", {}, {})
    state = _State({"k": torch.zeros((1, 1, 1, 2, 4)),
                    "len": torch.zeros(2)}, torch.zeros(2),
                   torch.zeros(2), torch.zeros(2), torch.zeros(2))
    ticks = graphs.TickCells(lambda st: body(None, None))
    for capture in (lambda: table._capture(cell, body),
                    lambda: ticks._capture(state, ("tick",))):
        if fail:
            with pytest.raises(RuntimeError, match="capture failed"):
                capture()
        else:
            capture()


@pytest.mark.parametrize("fail", [False, True], ids=["ok", "raises"])
def test_captures_hold_the_collector_off(fake_capture, fail):
    """Both capture methods run their capture with the collector off and
    turn it back on after it, also when the capture raises; a collector
    the caller had off stays off."""
    assert gc.isenabled()
    _capture_both(fail)
    assert fake_capture == [False, False]
    assert gc.isenabled()
    gc.disable()
    try:
        _capture_both(fail)
        assert not gc.isenabled()
    finally:
        gc.enable()
    assert fake_capture == [False] * 4


def test_no_collection_runs_inside_collector_held():
    """A cycle that becomes garbage inside the block survives every
    allocation there, with the collector's thresholds at 1, and is
    collected after the block."""
    class Node:
        pass

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        with graphs.collector_held():
            node = Node()
            node.self = node
            ref = weakref.ref(node)
            del node
            held = [[] for _ in range(200)]     # each one may collect
            assert ref() is not None and len(held) == 200
    finally:
        gc.set_threshold(*thresholds)
    gc.collect()
    assert ref() is None


def test_cell_arena_reserve_keeps_one_buffer_under_growing_views():
    """Views of a reserved buffer up to its size share it; without the
    reservation each larger view leaves the smaller buffer held (by the
    cells captured on it)."""
    from repro_torch.runtime.graphs import CellArena
    sizes = [(4, 8), (4, 16), (4, 64), (4, 128)]
    reserved, grown = CellArena(torch.device("cpu")), \
        CellArena(torch.device("cpu"))
    reserved.reserve("out:k", 4 * 128, torch.float32)
    views = [reserved.view("out:k", s, torch.float32) for s in sizes]
    for s in sizes:
        grown.view("out:k", s, torch.float32)
    assert reserved.buffer_bytes() == 4 * 128 * 4
    assert {v.data_ptr() for v in views} == {views[0].data_ptr()}
    assert grown.buffer_bytes() > 4 * 128 * 4
