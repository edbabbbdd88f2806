"""The port's allocator (paper Algorithm 1), its two baselines and its
usage records, held against the JAX package's on the CPU.

- The planner, the caching and GSOC baselines and ``validate_plan`` give
  exactly the reference's plans, counters and verdicts on the same
  Hypothesis streams of record lists (several plans on one warm
  allocator each).
- ``records_for_fn`` on the reference test's MLP gives the reference's
  records, and ``dedup_repeated_structure`` the reference's cut.
- Port only: the records of the smoke config's classify forward
  (``forward_hidden(attn="naive")`` then ``logits_at``), traced on the
  CPU, come from the card's graph (one node per kernel call), hold no
  view, parameter or input, stretch a base over its views' reads, repeat
  layer by layer, and plan within the reference's footprint bound.
"""
import dataclasses
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypothesis_compat import given, settings, st

from repro.core import allocator as jalloc
from repro.core import allocator_baselines as jbase
from repro.core import usage_records as jrec
from repro_torch.configs import get_smoke_config
from repro_torch.core import (CachingAllocator, GSOCAllocator,
                              SequenceAwareAllocator, TensorUsageRecord,
                              dedup_repeated_structure, find_gap_from_chunk,
                              peak_live_bytes, records_for_fn,
                              validate_plan)
from repro_torch.core import allocator as talloc
from repro_torch.core.usage_records import graph_lifetimes, trace
from repro_torch.kernels import ops, traced
from repro_torch.models import init_params
from repro_torch.models.transformer import forward_hidden, logits_at

ARCH = "internlm2-1.8b"

raw_records = st.lists(
    st.tuples(st.integers(0, 30),           # first_op
              st.integers(0, 30),           # duration
              st.integers(1, 4 << 20)),     # size
    min_size=1, max_size=40)
streams = st.lists(raw_records, min_size=2, max_size=5)


def _pair(raw):
    """The same records as the reference's and the port's type."""
    return ([jalloc.TensorUsageRecord(f"t{i}", fo, fo + d, size)
             for i, (fo, d, size) in enumerate(raw)],
            [TensorUsageRecord(f"t{i}", fo, fo + d, size)
             for i, (fo, d, size) in enumerate(raw)])


def _as_tuples(records):
    return [(r.tensor_id, r.first_op, r.last_op, r.size) for r in records]


def _plan_state(alloc, plan):
    return {"assignments": dict(plan.assignments),
            "chunks": [(c.chunk_id, c.size,
                        [(p.record.tensor_id, p.offset) for p in c.placed])
                       for c in plan.chunks],
            "plan_footprint": plan.footprint,
            "footprint": alloc.footprint,
            "counters": (alloc.allocated_bytes, alloc.freed_bytes,
                         alloc.alloc_events, alloc.free_events),
            "idle": dict(alloc._idle_counts)}


# ---------------------------------------------------------------------------
# Algorithm 1 and the baselines: exact parity on the same streams
# ---------------------------------------------------------------------------

def test_constants_equal_the_reference():
    assert talloc.DEFAULT_CHUNK_SIZE == jalloc.DEFAULT_CHUNK_SIZE
    assert talloc.K_SCALE == jalloc.K_SCALE
    assert talloc.INVALID == jalloc.INVALID


@settings(max_examples=80, deadline=None)
@given(streams, st.integers(0, 3), st.sampled_from([1 << 20, 2 << 20]))
def test_planner_stream_equals_the_reference(stream, max_idle, chunk):
    ref = jalloc.SequenceAwareAllocator(default_chunk_size=chunk,
                                        max_idle_inferences=max_idle)
    port = SequenceAwareAllocator(default_chunk_size=chunk,
                                  max_idle_inferences=max_idle)
    for raw in stream:
        jr, tr = _pair(raw)
        want = _plan_state(ref, ref.plan(jr))
        got = _plan_state(port, port.plan(tr))
        assert got == want
        validate_plan(tr, port.plan(tr))
        ref.plan(jr)


@settings(max_examples=60, deadline=None)
@given(raw_records, st.integers(0, 40), st.integers(0, 30),
       st.integers(1, 4 << 20), st.integers(1 << 10, 4 << 20))
def test_find_gap_equals_the_reference(raw, first, dur, size, chunk_size):
    jr, tr = _pair(raw)
    jc, tc = jalloc.Chunk(0, chunk_size), talloc.Chunk(0, chunk_size)
    offset = 0
    for a, b in zip(jr, tr):                 # a packed chunk, then gaps
        jc.insert(a, offset)
        tc.insert(b, offset)
        offset += a.size + a.size % 7
    jt = jalloc.TensorUsageRecord("x", first, first + dur, size)
    tt = TensorUsageRecord("x", first, first + dur, size)
    assert find_gap_from_chunk(tt, tc) == jalloc.find_gap_from_chunk(jt, jc)


@settings(max_examples=60, deadline=None)
@given(streams, st.sampled_from([512, 4096]))
def test_caching_baseline_equals_the_reference(stream, round_to):
    ref = jbase.CachingAllocator(round_to=round_to)
    port = CachingAllocator(round_to=round_to)
    for raw in stream:
        jr, tr = _pair(raw)
        assert port.run_inference(tr) == ref.run_inference(jr)
        assert (port.footprint, port.allocated_bytes, port.freed_bytes,
                port.alloc_events, port.free_events, port._free_blocks) == \
            (ref.footprint, ref.allocated_bytes, ref.freed_bytes,
             ref.alloc_events, ref.free_events, ref._free_blocks)


@settings(max_examples=60, deadline=None)
@given(streams, st.booleans())
def test_gsoc_baseline_equals_the_reference(stream, cache_arena):
    ref = jbase.GSOCAllocator(cache_arena=cache_arena)
    port = GSOCAllocator(cache_arena=cache_arena)
    for raw in stream:
        jr, tr = _pair(raw)
        assert GSOCAllocator.plan_offsets(tr) == \
            jbase.GSOCAllocator.plan_offsets(jr)
        assert port.run_inference(tr) == ref.run_inference(jr)
        assert (port.footprint, port.allocated_bytes, port.freed_bytes,
                port.alloc_events, port.free_events) == \
            (ref.footprint, ref.allocated_bytes, ref.freed_bytes,
             ref.alloc_events, ref.free_events)


def _verdict(validate, records, plan):
    try:
        validate(records, plan)
    except AssertionError as e:
        return str(e)
    return None


@settings(max_examples=60, deadline=None)
@given(raw_records, st.data())
def test_validate_plan_raises_on_the_same_corrupted_plans(raw, data):
    jr, tr = _pair(raw)
    jp = jalloc.SequenceAwareAllocator().plan(jr)
    tp = SequenceAwareAllocator().plan(tr)
    assert _verdict(validate_plan, tr, tp) is None
    # move one tensor to another offset (past its chunk's end, below 0,
    # or onto a neighbour)
    victim = data.draw(st.sampled_from([r.tensor_id for r in tr]))
    cid, _ = tp.assignments[victim]
    size = next(c.size for c in tp.chunks if c.chunk_id == cid)
    offset = data.draw(st.integers(-1, size))
    jp.assignments[victim] = (cid, offset)
    tp.assignments[victim] = (cid, offset)
    assert _verdict(validate_plan, tr, tp) == \
        _verdict(jalloc.validate_plan, jr, jp)


def test_validate_plan_catches_an_overlap_like_the_reference():
    raw = [(0, 5, 1000), (2, 5, 1000)]
    jr, tr = _pair(raw)
    jp = jalloc.SequenceAwareAllocator().plan(jr)
    tp = SequenceAwareAllocator().plan(tr)
    jp.assignments["t1"] = tp.assignments["t1"] = tp.assignments["t0"]
    got = _verdict(validate_plan, tr, tp)
    assert got is not None and got.startswith("overlap in chunk")
    assert got == _verdict(jalloc.validate_plan, jr, jp)


@settings(max_examples=60, deadline=None)
@given(raw_records, st.integers(1, 30))
def test_dedup_equals_the_reference(raw, layers):
    jr, tr = _pair(raw)
    assert _as_tuples(dedup_repeated_structure(tr, layers)) == \
        _as_tuples(jrec.dedup_repeated_structure(jr, layers))


# ---------------------------------------------------------------------------
# records: the reference test's MLP
# ---------------------------------------------------------------------------

def _mlp_inputs():
    rng = np.random.default_rng(0)
    return (rng.standard_normal((32, 256)).astype(np.float32),
            rng.standard_normal((256, 512)).astype(np.float32),
            rng.standard_normal((512, 64)).astype(np.float32))


def test_mlp_records_equal_the_reference():
    """`tests/test_allocator.py`'s MLP: one op per jaxpr equation, so the
    records agree in ids, sizes and lifetimes, an output to n_ops."""
    def jmlp(x, w1, w2):
        h = jnp.tanh(x @ w1)
        return (h * h) @ w2

    def tmlp(x, w1, w2):
        h = torch.tanh(x @ w1)
        return (h * h) @ w2

    arrays = _mlp_inputs()
    want = jrec.records_for_fn(jmlp, *map(jnp.asarray, arrays), min_size=1)
    got = records_for_fn(tmlp, *map(torch.from_numpy, arrays), min_size=1)
    assert _as_tuples(got) == _as_tuples(want)
    assert got[-1].last_op == 4                       # the graph output
    for layers in (1, 2, 3):
        assert _as_tuples(dedup_repeated_structure(got, layers)) == \
            _as_tuples(jrec.dedup_repeated_structure(want, layers))
    for min_size in (8192, 65536, 65537):
        assert _as_tuples(records_for_fn(
            tmlp, *map(torch.from_numpy, arrays), min_size=min_size)) == \
            _as_tuples(jrec.records_for_fn(
                jmlp, *map(jnp.asarray, arrays), min_size=min_size))
    plan = SequenceAwareAllocator().plan(got)
    validate_plan(got, plan)


# ---------------------------------------------------------------------------
# records: views, in-place writes, outputs
# ---------------------------------------------------------------------------

def _ops_of(gm):
    return graph_lifetimes(gm)["nodes"]


def test_a_view_gets_no_record_and_its_read_extends_the_base():
    def f(x):
        a = x * 2           # 0: fresh
        b = a.t()           # 1: a view of a
        c = x + 1           # 2: fresh
        d = b @ c           # 3: reads the view: a lives to here
        return d.view(-1)   # 4: the output is a view of d

    x = torch.ones(16, 16)
    recs = records_for_fn(f, x, min_size=1)
    assert _as_tuples(recs) == [("t0", 0, 3, 1024), ("t1", 2, 3, 1024),
                                ("t2", 3, 5, 1024)]


def test_an_in_place_write_extends_its_target():
    def f(x, y):
        a = x * 2           # 0
        b = y + 1           # 1
        a.add_(1)           # 2: writes a in place
        c = b * 3           # 3
        a[0].copy_(c[0])    # 4 select a, 5 select c, 6 copy_ into a
        return c

    x = torch.ones(8, 32)
    recs = records_for_fn(f, x, x.clone(), min_size=1)
    assert _as_tuples(recs) == [("t0", 0, 6, 1024), ("t1", 1, 3, 1024),
                                ("t2", 3, 7, 1024)]


def test_inputs_and_closed_over_weights_get_no_record():
    w = torch.ones(32, 32)

    def f(x):
        wt = w.t()                   # a view of a constant
        return (x @ wt).reshape(-1)  # mm, then a view

    recs = records_for_fn(f, torch.ones(4, 32), min_size=1)
    assert _as_tuples(recs) == [("t0", 1, 3, 512)]


def _brute_peak(records):
    ops_ = sorted({r.first_op for r in records} |
                  {r.last_op for r in records})
    return max((sum(r.size for r in records
                    if r.first_op <= t <= r.last_op) for t in ops_),
               default=0)


@pytest.mark.parametrize("raw,peak", [
    ([], 0),
    ([(0, 0, 5)], 5),
    ([(0, 1, 5), (1, 2, 7)], 12),          # meet at op 1
    ([(0, 1, 5), (2, 3, 7)], 7),           # disjoint
    ([(0, 9, 1), (3, 4, 10), (5, 6, 20), (4, 5, 100)], 121),
])
def test_peak_live_bytes_by_hand(raw, peak):
    recs = [TensorUsageRecord(f"t{i}", a, b, s)
            for i, (a, b, s) in enumerate(raw)]
    assert peak_live_bytes(recs) == _brute_peak(recs) == peak


@settings(max_examples=60, deadline=None)
@given(raw_records)
def test_peak_live_bytes_equals_a_brute_force_count(raw):
    _, tr = _pair(raw)
    assert peak_live_bytes(tr) == _brute_peak(tr)


# ---------------------------------------------------------------------------
# the kernel wrappers as one node each
# ---------------------------------------------------------------------------

def _wrapper_cases():
    g = torch.Generator().manual_seed(0)

    def r(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    x, gamma = r(6, 64), r(64)
    q, kv = r(2, 4, 8, 128), r(2, 2, 8, 128)
    seg = torch.zeros(70, dtype=torch.int32)
    pos = torch.arange(70, dtype=torch.int32)
    pool = r(5, 4, 2, 128)
    tables = torch.ones(2, 2, dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    rows = torch.ones(2)
    return {
        "softmax": ("fused_softmax", (r(6, 40), lens.repeat(3)), {}),
        "rmsnorm": ("fused_rmsnorm", (x, gamma), {}),
        "rmsnorm_residual": ("fused_rmsnorm", (x, gamma, None, r(6, 64)),
                             {"return_residual": True}),
        "layernorm": ("fused_layernorm", (x, gamma, r(64)), {}),
        "layernorm_residual": ("fused_layernorm",
                               (x, gamma, r(64), r(64), r(6, 64)),
                               {"return_residual": True}),
        "sample": ("fused_sample", (r(2, 100), rows,
                                    torch.zeros(2, dtype=torch.int32), rows,
                                    r(2, 16)), {}),
        "flash": ("flash_attention", (q, kv, kv), {"causal": True}),
        "flash_bf16": ("flash_attention",
                       (q.bfloat16(), kv.bfloat16(), kv.bfloat16(), lens),
                       {"causal": False}),
        "packed": ("flash_attention_packed",
                   (r(1, 4, 70, 128), r(1, 2, 70, 128), r(1, 2, 70, 128),
                    seg, seg, pos, pos), {}),
        "packed_plan": ("flash_attention_packed_plan", (seg, seg, pos, pos),
                        {}),
        "decode": ("flash_decode", (q[:, :, 0].contiguous(), kv, kv, lens),
                   {}),
        "decode_paged": ("flash_decode_paged",
                         (q[:, :, 0].contiguous(), pool, pool, tables, lens),
                         {}),
    }


@pytest.mark.parametrize("case", sorted(_wrapper_cases()))
def test_traced_wrapper_is_one_node_shaped_as_the_wrapper(case):
    """Each wrapper traces to one custom-operator node that reads every
    tensor input, with the outputs' shapes and dtypes of the wrapper's
    own call (the plain version here, the kernel on the card)."""
    name, args, kwargs = _wrapper_cases()[case]
    want = getattr(ops, name)(*args, **kwargs)
    gm = trace(lambda *a: getattr(ops, name)(*a, **kwargs), *args)
    nodes = _ops_of(gm)
    assert len(nodes) == 1 and nodes[0].target.namespace == "repro_torch"
    assert len(nodes[0].all_input_nodes) == \
        len({id(a) for a in args if isinstance(a, torch.Tensor)})
    got = nodes[0].meta["val"]
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert [(tuple(t.shape), t.dtype) for t in got] == \
        [(tuple(t.shape), t.dtype) for t in want]
    assert getattr(ops, name) is traced._PLAIN[name]     # restored


def test_traced_kernels_restores_the_wrappers_after_an_error():
    with pytest.raises(RuntimeError, match="inside"):
        with traced.traced_kernels():
            assert ops.fused_softmax is not traced._PLAIN["fused_softmax"]
            raise RuntimeError("inside")
    assert all(getattr(ops, n) is traced._PLAIN[n] for n in traced.WRAPPERS)


def test_only_the_tracing_thread_takes_the_operators(monkeypatch):
    """While one thread traces, a forward on another thread (a serving
    thread) calls the wrappers themselves; the tracing thread's own eager
    calls go through the operators and give the same values."""
    cfg = get_smoke_config(ARCH)
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.ones((1, 9), dtype=torch.int32)
    want, _ = forward_hidden(cfg, params, tokens, attn="naive")
    table = traced.operators()
    calls = []
    for name, op in list(table.items()):
        monkeypatch.setitem(table, name, lambda *a, _op=op, _n=name:
                            calls.append(_n) or _op(*a))
    other = {}
    with traced.traced_kernels():
        t = threading.Thread(target=lambda: other.update(
            h=forward_hidden(cfg, params, tokens, attn="naive")[0]))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and calls == []
        mine, _ = forward_hidden(cfg, params, tokens, attn="naive")
    assert sorted(calls) == sorted(
        ["fused_norm"] * (cfg.num_layers + 1) +
        ["fused_norm_residual", "fused_softmax"] * cfg.num_layers)
    assert torch.equal(other["h"], want) and torch.equal(mine, want)
    assert all(getattr(ops, n) is traced._PLAIN[n] for n in traced.WRAPPERS)


# ---------------------------------------------------------------------------
# records of the smoke config's classify forward
# ---------------------------------------------------------------------------

def _classify_fn(cfg, params):
    def fwd(tokens, last):
        h, _ = forward_hidden(cfg, params, tokens, attn="naive")
        return logits_at(cfg, params, h, last)
    return fwd


def _classify_trace(cfg, seq=37):
    params = init_params(cfg, seed=0, device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(0, cfg.vocab_size, (1, seq),
                                          dtype=np.int32))
    last = torch.tensor([seq - 1], dtype=torch.int32)
    fwd = _classify_fn(cfg, params)
    return trace(fwd, tokens, last), fwd, (tokens, last)


@pytest.fixture(scope="module")
def smoke():
    cfg = get_smoke_config(ARCH)
    gm, fwd, args = _classify_trace(cfg)
    return cfg, gm, fwd, args


#: the plain norm's and softmax's own ops: none may be in the graph
PLAIN_OPS = {"aten.mean.dim", "aten.rsqrt.default", "aten.exp.default",
             "aten.max.dim", "aten.amax.default", "aten.sum.dim_IntList",
             "aten.where.self", "aten.clamp.default"}


def test_classify_graph_has_one_node_per_kernel_call(smoke):
    cfg, gm, _, _ = smoke
    targets = [str(n.target) for n in _ops_of(gm)]
    norms = [t for t in targets if t.startswith("repro_torch.fused_norm")]
    assert len(norms) == 2 * cfg.num_layers + 1
    assert targets.count("repro_torch.fused_norm_residual.default") == \
        cfg.num_layers
    assert targets.count("repro_torch.fused_softmax.default") == \
        cfg.num_layers
    assert not PLAIN_OPS & set(targets)
    assert not any("flash" in t for t in targets)


def test_classify_records_hold_no_view_parameter_or_input(smoke):
    _, gm, _, _ = smoke
    inputs = {n.meta["val"].untyped_storage()._cdata
              for n in gm.graph.nodes
              if n.op in ("placeholder", "get_attr")}
    lt = graph_lifetimes(gm)
    assert lt["storages"]
    for node, j, first, last, size in lt["storages"]:
        schema = node.target._schema
        assert schema.name != "aten::_unsafe_view"
        assert all(r.alias_info is None for r in schema.returns), node
        val = node.meta["val"]
        val = val[j] if isinstance(val, (tuple, list)) else val
        assert val.untyped_storage()._cdata not in inputs
        assert size == val.numel() * val.element_size()
        assert first == lt["nodes"].index(node) and last >= first
    # every storage a compute node makes is either a record or a view of
    # one, a parameter or an input
    made = {s[0] for s in lt["storages"]}
    for node in lt["nodes"]:
        vals = node.meta["val"]
        for v in (vals if isinstance(vals, (tuple, list)) else [vals]):
            if node not in made and isinstance(v, torch.Tensor):
                assert any(r.alias_info is not None
                           for r in node.target._schema.returns) or \
                    node.target._schema.name == "aten::_unsafe_view", node


def test_classify_record_lives_through_every_read_of_its_storage(smoke):
    """A record's last_op is at or after every node that reads its
    storage, through any view (fake storages say which node reads what)."""
    _, gm, _, _ = smoke
    lt = graph_lifetimes(gm)
    life = {}
    for node, j, first, last, _ in lt["storages"]:
        val = node.meta["val"]
        val = val[j] if isinstance(val, (tuple, list)) else val
        life[val.untyped_storage()._cdata] = (first, last)
    viewed = 0
    for i, node in enumerate(lt["nodes"]):
        for arg in node.all_input_nodes:
            vals = arg.meta.get("val")
            for v in (vals if isinstance(vals, (tuple, list)) else [vals]):
                if not isinstance(v, torch.Tensor):
                    continue
                span = life.get(v.untyped_storage()._cdata)
                if span is None:
                    continue
                assert span[0] <= i <= span[1], (node, arg)
                viewed += arg not in {s[0] for s in lt["storages"]}
    assert viewed > 0            # views were read, and held their bases


def _layer_counts(cfg, gm, min_size=1):
    lt = graph_lifetimes(gm)
    norms = [i for i, n in enumerate(lt["nodes"])
             if str(n.target).startswith("repro_torch.fused_norm")]
    starts = norms[0:-1:2] + [norms[-1]]   # each layer's norm1, final norm
    firsts = [s[2] for s in lt["storages"] if s[4] >= min_size]
    return [sum(a <= f < b for f in firsts)
            for a, b in zip(starts, starts[1:])]


def _ops_before_first_layer(gm):
    return next(i for i, n in enumerate(_ops_of(gm))
                if str(n.target).startswith("repro_torch.fused_norm"))


@pytest.mark.parametrize("layers", [2, 4, 8])
def test_classify_records_repeat_layer_by_layer(layers):
    cfg = dataclasses.replace(get_smoke_config(ARCH), num_layers=layers)
    gm, fwd, args = _classify_trace(cfg)
    counts = _layer_counts(cfg, gm)
    assert len(counts) == layers and len(set(counts)) == 1, counts
    recs = records_for_fn(fwd, *args, min_size=1)
    kept = dedup_repeated_structure(recs, layers)
    # about 1/L of them: one layer's records and the few before it (the
    # embedding and the RoPE tables)
    before = sum(r.first_op < _ops_before_first_layer(gm) for r in recs)
    assert abs(len(kept) - len(recs) / layers) <= before + 0.1 * counts[0]
    assert counts[0] <= len(kept) <= counts[0] + before


def test_classify_plan_validates_within_the_reference_bound(smoke):
    _, _, fwd, args = smoke
    for min_size in (1, 1024):
        recs = records_for_fn(fwd, *args, min_size=min_size)
        alloc = SequenceAwareAllocator()
        plan = alloc.plan(recs)
        validate_plan(recs, plan)
        peak = peak_live_bytes(recs)
        # the bound of tests/test_allocator.py
        # ::test_property_footprint_at_most_peak_concurrency
        slack = sum(max(alloc.default_chunk_size,
                        int(r.size * alloc.k_scale)) for r in recs)
        assert peak <= plan.footprint <= peak + slack


def test_classify_records_follow_the_length(smoke):
    """Longer prompts, larger activations, the same graph: the record
    count is fixed and every size grows."""
    cfg, _, fwd, _ = smoke
    sizes = []
    for seq in (9, 40):
        tokens = torch.ones((1, seq), dtype=torch.int32)
        last = torch.tensor([seq - 1], dtype=torch.int32)
        recs = records_for_fn(fwd, tokens, last, min_size=1)
        sizes.append([r.size for r in recs])
    assert len(sizes[0]) == len(sizes[1])
    assert sum(sizes[1]) > sum(sizes[0])
    assert peak_live_bytes(records_for_fn(
        fwd, torch.ones((1, 40), dtype=torch.int32),
        torch.tensor([39], dtype=torch.int32))) > 0


# ---------------------------------------------------------------------------
# chip_smoke.py's allocator phase, its host half on the CPU
# ---------------------------------------------------------------------------

def test_chip_smoke_allocator_stream_on_the_smoke_forward():
    """The phase's stream of lengths is the reference benchmark's, cut in
    depth to its first ``ALLOC_REQUESTS``, and its planning half (records,
    Algorithm 1 full and deduplicated, both baselines, ``validate_plan`` on
    every plan) runs on the smoke forward."""
    import random
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    import chip_smoke
    from benchmarks import bench_allocator

    rng = random.Random(0)
    want = [rng.randint(5, 500) for _ in range(bench_allocator.NUM_REQUESTS)]
    assert 4 <= chip_smoke.ALLOC_REQUESTS <= bench_allocator.NUM_REQUESTS
    assert chip_smoke.allocator_lengths() == want[:chip_smoke.ALLOC_REQUESTS]
    cfg = get_smoke_config(ARCH)
    _, fwd, _ = _classify_trace(cfg)
    stream = chip_smoke.AllocatorStream(cfg.num_layers)
    rows = []
    for n in want[:4]:
        tokens = torch.ones((1, n), dtype=torch.int32)
        last = torch.tensor([n - 1], dtype=torch.int32)
        recs = records_for_fn(fwd, tokens, last,
                              min_size=chip_smoke.ALLOC_MIN_SIZE)
        rows.append(stream.step(recs))
        assert rows[-1]["records_peak_bytes"] == peak_live_bytes(recs)
        assert rows[-1]["records_dedup"] < rows[-1]["records"]
    # the simulated caching allocator never shrinks; turbo releases
    assert [r["caching_bytes"] for r in rows] == \
        sorted(r["caching_bytes"] for r in rows)
    traffic = stream.traffic()
    assert set(traffic) == {"turbo", "caching", "gsoc"}
    assert traffic["gsoc"]["alloc_events"] == 4
