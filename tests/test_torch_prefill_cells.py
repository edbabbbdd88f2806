"""The port's classify and prefill cells against the JAX package's, on the
CPU.

The reference compiles one cell per key for each of its prefill-side
functions (``_classify_fn``, ``_prefill_fn``, ``_suffix_fn``,
``_packed_fn``), counts them in ``compile_count`` and warms them in
``warmup_aot``.  The port captures one CUDA graph per key on the card; on
the CPU its cell tables run each cell's body eagerly and only record the
keys they were asked for.  Here, on bridged weights:

- after the same warm-up and the same serve workload (the paged packed
  default, per group with the prefix cache and chunked prefill, and the
  contiguous layout), the port's recorded keys equal the reference's
  ``_prefill_cache`` keys, with one deliberate difference: on the paged
  layout the port's per-group prefill keeps only the prompt bucket's KV
  (``prompt_kv_only``), so its key is (prompt bucket, batch bucket,
  prompt bucket) where the reference's first entry is the admission's
  sequence bucket;
- ``warmup_aot`` walks as many rounds as the reference's, and the client
  streams and counters after it equal the reference's token for token;
- the classify cells' keys after the cost-table warm-up and serving
  equal the reference's ``_classify_cache`` keys;
- each cell body gives bit for bit the logits and KV of the model
  function it was split from, and the helpers that fill a cell's inputs
  refuse what does not fit.
"""
import numpy as np
import pytest
import torch

from repro.api import TurboClient as JaxClient
from repro.core import AnalyticCostModel as JaxCostModel
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.models import (forward_hidden, logits_at, prefill,
                                prefill_packed, prefill_suffix)
from repro_torch.runtime import graphs
from repro_torch.runtime.engine import ContinuousEngine, segment_labels
from tests.test_torch_prefix import (ARCH, COST, _engine, _jax_engine,
                                     _serve, _workload, weights)

__all__ = ["weights"]          # the module-scoped fixture, shared

#: serving configurations: ContinuousEngine options, pipeline options
SETUPS = {
    "paged_packed": (dict(), dict()),
    "per_group_prefix_chunked": (
        dict(packed_prefill=False, prefix_cache=True),
        dict(chunked_prefill=True, prefill_chunk_tokens=16)),
    "contiguous": (dict(kv_layout="contiguous"), dict()),
}


def _clients(weights, setup):
    jcfg, jparams, tparams = weights
    engine_kw, pipe_kw = SETUPS[setup]
    opts = dict(max_slots=4, cap_new=24, **engine_kw)
    pipe = dict(policy="dp", max_batch_size=4, **pipe_kw)
    jclient = JaxClient(JaxContinuousEngine(_jax_engine(jcfg, jparams),
                                            **opts),
                        cost_model=JaxCostModel(**COST),
                        config=JaxPipelineConfig(**pipe), warmup=True)
    client = TurboClient(ContinuousEngine(_engine(tparams), **opts),
                         cost_model=AnalyticCostModel(**COST),
                         config=PipelineConfig(**pipe), warmup=True)
    return jclient, client


def _port_keys(ce):
    return set(ce.engine.prefill_cells.keys())


def _reference_keys(jce):
    """The reference's prefill cell keys as the port keys them: a paged
    per-group prefill keeps only its prompt bucket's KV."""
    keys = set()
    for key in jce.engine._prefill_cache:
        if isinstance(key[0], int) and jce.kv_layout == "paged":
            key = (key[2], key[1], key[2])
        keys.add(key)
    return keys


#: engine counters both packages restore after a warm-up, and those only
#: the port restores (the reference counts its warm rounds in them)
RESTORED = ("prefill_tokens", "decode_ticks", "cow_blocks")
PORT_RESTORED = ("prefill_dispatches", "pack_dispatches", "pack_segments")


@pytest.mark.parametrize("setup", sorted(SETUPS))
def test_warmup_and_serving_walk_the_reference_cells(weights, setup):
    """``warmup_aot`` walks the reference's rounds and records the
    reference's cell keys; the same workload served after it gives the
    reference's streams, counters and keys; on the CPU nothing is
    captured."""
    jclient, client = _clients(weights, setup)
    ce, jce = client.backend, jclient.backend
    assert client.warmup_stats["rounds"] == jclient.warmup_stats["rounds"]
    assert client.warmup_stats["compile_count"] == 0
    assert _port_keys(ce) == _reference_keys(jce)
    warm = {k: getattr(jce, k) for k in PORT_RESTORED}
    assert all(getattr(ce, k) == 0 for k in RESTORED + PORT_RESTORED)
    assert not ce.pack_log and not ce.state.sampling

    work = _workload(7, n=8)
    _, want = _serve(jclient, JaxParams, work)
    handles, got = _serve(client, GenerationParams, work)
    assert got == want
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    pipe, jpipe = client.pipeline, jclient.pipeline
    assert pipe.stats.__dict__ == jpipe.stats.__dict__
    assert pipe.batch_log == jpipe.batch_log
    assert {k: getattr(ce, k) for k in RESTORED} == \
        {k: getattr(jce, k) for k in RESTORED}
    assert {k: getattr(ce, k) for k in PORT_RESTORED} == \
        {k: getattr(jce, k) - warm[k] for k in PORT_RESTORED}
    assert _port_keys(ce) == _reference_keys(jce)
    if setup == "per_group_prefix_chunked":
        # cache hits and chunks went through exact-prefix suffix cells
        assert pipe.stats.chunked_prefills > 0
        assert any(k[0] == "sfx" and k[1] for k in _port_keys(ce))
    assert ce.engine.compile_count == 0
    cells = ce.engine.prefill_cells
    assert len(cells) == 0 and cells.captures == 0


def test_classify_cells_match_reference(weights):
    """The cost-table warm-up and one-shot classification ask for the
    reference's (seq bucket, batch bucket) cells and classify alike."""
    jcfg, jparams, tparams = weights
    jeng, eng = _jax_engine(jcfg, jparams), _engine(tparams)
    jeng.warmup(lengths=(8, 40), batches=(1, 3), repeats=1)
    eng.warmup(lengths=(8, 40), batches=(1, 3), repeats=1)
    rng = np.random.default_rng(4)
    batch = [[int(t) for t in rng.integers(1, 256, n)] for n in (5, 17)]
    assert eng.classify(batch) == jeng.classify(batch)
    assert eng.classify_cells.keys() == list(jeng._classify_cache)
    assert eng.classify_cells.calls[(32, 2)] == 1
    assert eng.compile_count == 0 and not eng.prefill_cells.keys()


# ---------------------------------------------------------------------------
# The cell bodies against the functions they were split from
# ---------------------------------------------------------------------------

def _rows(rng, vocab, lens, width):
    toks = np.zeros((len(lens), width), np.int64)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, vocab, n)
    return toks


def _first_logits(eng, monkeypatch):
    """Record the logits each prefill hands ``_finish_gen_state``."""
    seen = []
    real = eng._finish_gen_state

    def spy(logits, *args, **kw):
        seen.append(logits.clone())
        return real(logits, *args, **kw)

    monkeypatch.setattr(eng, "_finish_gen_state", spy)
    return seen


@pytest.mark.parametrize("kv_only", [False, True],
                         ids=["max_len", "prompt_kv_only"])
def test_prefill_cell_equals_prefill(weights, monkeypatch, kv_only):
    _, _, tparams = weights
    eng, cfg = _engine(tparams), get_smoke_config(ARCH)
    seen = _first_logits(eng, monkeypatch)
    lens = (20, 7, 31)
    toks = _rows(np.random.default_rng(1), cfg.vocab_size, lens + (0,), 32)
    prompts = [[int(t) for t in row[:n]] for row, n in zip(toks, lens)]
    state = eng._prefill_batch(prompts, eng.prefill_cells, max_len=64,
                               max_new_tokens=4, prompt_kv_only=kv_only)
    want_logits, want = prefill(
        cfg, tparams, torch.from_numpy(toks),
        max_len=None if kv_only else 64,
        true_lengths=torch.tensor([20, 7, 31, 1], dtype=torch.int32),
        cache_dtype=torch.float32)
    assert torch.equal(seen[0], want_logits)
    for key in ("k", "v", "len", "pos_offset"):
        assert torch.equal(state.cache[key], want[key]), key
    width = 32 if kv_only else 64
    assert eng.prefill_cells.keys() == [(width, 4, 32)]


def test_suffix_cell_equals_prefill_suffix(weights, monkeypatch):
    _, _, tparams = weights
    eng, cfg = _engine(tparams), get_smoke_config(ARCH)
    seen = _first_logits(eng, monkeypatch)
    rng = np.random.default_rng(2)
    pre = 21
    prompts = [[int(t) for t in rng.integers(1, 256, pre + n)]
               for n in (9, 30, 1)]
    shape = (cfg.num_layers, 3, pre, cfg.num_kv_heads, cfg.head_dim)
    pk = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    state = eng._prefill_suffix_batch(prompts, eng.prefill_cells,
                                      prefix_k=pk, prefix_v=pv,
                                      prefix_len=pre, max_new_tokens=2)
    toks = np.zeros((4, 32), np.int64)
    for i, p in enumerate(prompts):
        toks[i, :len(p) - pre] = p[pre:]
    pad = torch.zeros((cfg.num_layers, 1) + shape[2:])
    want_logits, want = prefill_suffix(
        cfg, tparams, torch.from_numpy(toks), torch.cat([pk, pad], 1),
        torch.cat([pv, pad], 1), prefix_len=pre,
        true_lengths=torch.tensor([9, 30, 1, 1], dtype=torch.int32),
        cache_dtype=torch.float32)
    assert torch.equal(seen[0], want_logits)
    for key in ("k", "v"):
        assert torch.equal(state.cache[key], want[key]), key
    assert state.cache["len"].tolist() == [30, 51, 22, 1]
    assert eng.prefill_cells.keys() == [("sfx", pre, 32, 4)]


@pytest.mark.parametrize("with_prefix", [False, True])
def test_packed_cell_equals_prefill_packed(weights, with_prefix):
    _, _, tparams = weights
    eng, cfg = _engine(tparams), get_smoke_config(ARCH)
    rng = np.random.default_rng(3)
    suffixes = [[int(t) for t in rng.integers(1, 256, n)] for n in (11, 4, 9)]
    offsets = [5, 0, 3] if with_prefix else [0, 0, 0]
    pre = sum(offsets)
    shape = (cfg.num_layers, pre, cfg.num_kv_heads, cfg.head_dim)
    pk = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pv = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    pseg = np.repeat(np.arange(3, dtype=np.int32), offsets)
    ppos = np.concatenate([np.arange(n, dtype=np.int32) for n in offsets])
    logits, parts = eng._prefill_packed_flat(suffixes, offsets,
                                             eng.prefill_cells, pk, pv,
                                             pseg, ppos)
    pre_b = 32 if pre else 0
    seg, pos = segment_labels([11, 4, 9], offsets, 32)
    toks = np.zeros((1, 32), np.int64)
    toks[0, :24] = np.concatenate(suffixes)
    pad = torch.zeros((cfg.num_layers, pre_b - pre) + shape[2:])
    want_logits, want = prefill_packed(
        cfg, tparams, torch.from_numpy(toks), torch.from_numpy(seg),
        torch.from_numpy(pos),
        torch.tensor([10, 14, 23, 0], dtype=torch.int32),
        torch.cat([pk, pad], 1), torch.cat([pv, pad], 1),
        torch.from_numpy(np.pad(pseg, (0, pre_b - pre),
                                constant_values=-1)),
        torch.from_numpy(np.pad(ppos, (0, pre_b - pre))),
        cache_dtype=torch.float32)
    assert torch.equal(logits, want_logits)
    for key in ("k", "v"):
        assert torch.equal(parts[key], want[key]), key
    assert eng.prefill_cells.keys() == [("pack", 32, pre_b, 4)]


def test_classify_cell_equals_forward_and_head(weights):
    _, _, tparams = weights
    eng, cfg = _engine(tparams), get_smoke_config(ARCH)
    rng = np.random.default_rng(5)
    batch = [[int(t) for t in rng.integers(1, 256, n)] for n in (40, 3, 12)]
    got = eng._classify(batch, eng.classify_cells)
    toks = np.zeros((4, 64), np.int64)
    for i, t in enumerate(batch):
        toks[i, :len(t)] = t
    h, _ = forward_hidden(cfg, tparams, torch.from_numpy(toks),
                          attn="naive")
    want = logits_at(cfg, tparams, h,
                     torch.tensor([39, 2, 11, 0], dtype=torch.int32))
    assert torch.equal(got, want)
    assert torch.equal(eng.classify_logits(batch), want[:3])
    assert eng.classify_cells.keys() == [(64, 4)]


def test_public_results_are_their_own(weights):
    """A public method's result is not overwritten by a later call."""
    _, _, tparams = weights
    eng = _engine(tparams)
    first = eng.classify_logits([[3, 4, 5]])
    kept = first.clone()
    eng.classify_logits([[9, 8, 7]])
    assert torch.equal(first, kept)


# ---------------------------------------------------------------------------
# What fills a cell's inputs
# ---------------------------------------------------------------------------

def test_padded_and_write():
    a = np.arange(6, dtype=np.int32).reshape(2, 3)
    assert graphs.padded(a, 1, 3) is a
    assert graphs.padded(a, 1, 5, -1).tolist() == [[0, 1, 2, -1, -1],
                                                   [3, 4, 5, -1, -1]]
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    fill = graphs.padded(t, 0, 4)
    assert graphs.spec(fill) == ((4, 3), torch.float32)
    out = torch.full((4, 3), 7.0)
    graphs.write(out, fill)
    assert torch.equal(out, torch.cat([t, torch.zeros(2, 3)]))
    with pytest.raises(ValueError, match="input of shape"):
        graphs.write(torch.empty(4, 3), t)              # no broadcast
    with pytest.raises(ValueError, match="input of shape"):
        graphs.write(torch.empty(2, 3, dtype=torch.float64), t)
    ran = graphs.run_eager(
        lambda ins, outs: outs["y"].copy_(ins["x"] * 2),
        {"x": a}, {"y": ((2, 3), torch.int32)}, torch.device("cpu"))
    assert ran["y"].tolist() == (a * 2).tolist()


def test_kv_out_must_fit_the_cache(weights):
    _, _, tparams = weights
    cfg = get_smoke_config(ARCH)
    toks = torch.ones((2, 8), dtype=torch.int64)
    shape = (cfg.num_layers, 2, 16, cfg.num_kv_heads, cfg.head_dim)
    good = {"k": torch.full(shape, 9.0), "v": torch.full(shape, 9.0)}
    _, cache = prefill(cfg, tparams, toks, max_len=16,
                       cache_dtype=torch.float32, kv_out=good)
    assert cache["k"] is good["k"]
    assert float(good["k"][:, :, 8:].abs().sum()) == 0.0   # tail zeroed
    with pytest.raises(ValueError, match="kv_out"):
        prefill(cfg, tparams, toks, max_len=32,
                cache_dtype=torch.float32, kv_out=good)
    with pytest.raises(ValueError, match="kv_out"):
        prefill(cfg, tparams, toks, max_len=16, cache_dtype=torch.float32,
                kv_out={k: v.double() for k, v in good.items()})


def test_prefix_fills_gather_the_pool(weights):
    """The pool gather that writes straight into a cell's input reads
    the blocks a block-wise gather reads."""
    _, _, tparams = weights
    ce = ContinuousEngine(_engine(tparams), max_slots=2, cap_new=8)
    ce._ensure_state(64)
    pool = ce.state.cache["k"]
    pool.copy_(torch.randn(pool.shape))
    tables = [[3, 5, 2], [7, 1, 4]]
    length = 37
    pk, _ = ce._gather_prefix(
        [type("M", (), dict(full_blocks=t[:2], tail_block=t[2]))()
         for t in tables], length)
    got = torch.empty(pk.shape)
    graphs.write(got, pk)
    idx = torch.tensor(tables)
    want = pool[:, idx].reshape((pool.shape[0], 2, 48) +
                                pool.shape[3:])[:, :, :length]
    assert torch.equal(got, want)
