"""The port's prefix cache against the JAX package's.

Host-side policy first: the refcount half of `BlockTableManager` (`ref`,
`take`, `allocate(prefix_blocks=)`, `copy_on_write`), its sanitizer, and
`RadixPrefixCache` run the same operation sequences in both packages and
must observe the same results (returned ids, refcounts, free lists,
errors).  Then the model: the port's `prefill_suffix` against the
reference's on bridged weights at prefix lengths 0, 16 and an unaligned
37, in f32 (1e-4, as in tests/test_torch_models.py).  Last, the engine:
client streams with ``prefix_cache=True`` (packed and per group, greedy
and seeded-sampled) equal the reference client's token for token, with
the same prefix counters, and the mechanics the reference's own tests
cover (copy-on-write at admission and before the first decode write, LRU
eviction under pool pressure, shared blocks raising admission) hold.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import TurboClient as JaxClient
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AnalyticCostModel as JaxCostModel
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import init_params as jax_init_params
from repro.models import prefill_suffix as jax_prefill_suffix
from repro.runtime import kv_cache as jax_kv
from repro.runtime import prefix_cache as jax_pc
from repro.runtime import sanitizer as jax_san
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.models import prefill, prefill_suffix
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime import kv_cache as port_kv
from repro_torch.runtime import prefix_cache as port_pc
from repro_torch.runtime import sanitizer as port_san
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
from repro_torch.runtime.session import SessionState

ARCH = "internlm2-1.8b"
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(1, 2, 4))
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
#: one cost model, spelled out in full for both packages, so both
#: pipelines make the same scheduling decisions
COST = dict(flops_per_token=1e6, bytes_per_token=1e3, weight_bytes=1e6,
            overhead=1e-4, peak_flops=197e12, hbm_bw=819e9)
PACKAGES = {"jax": (jax_kv, jax_san, jax_pc),
            "port": (port_kv, port_san, port_pc)}


# ---------------------------------------------------------------------------
# Host-side policy: the same operation sequences in both packages
# ---------------------------------------------------------------------------

def _recorder(btm, log):
    """``rec(fn, *args)``: call ``fn``, log its result (or the name of
    the error it raised) and the manager's state after it."""
    def rec(fn, *args, **kw):
        try:
            out = fn(*args, **kw)
        except Exception as e:      # the error's kind is the observation
            out, res = None, type(e).__name__
        else:
            res = out
        log.append((fn.__name__, res, btm.free_blocks,
                    tuple(btm.ref_count(b) for b in range(btm.num_blocks)),
                    tuple(sorted((r, tuple(t))
                                 for r, t in btm._tables.items()))))
        return out
    return rec


def seq_share_and_cow(btm, rec):
    a = rec(btm.allocate, 1, 40)
    rec(btm.ref, a[0])
    rec(btm.ref, a[1])
    b = rec(btm.allocate, 2, 48, prefix_blocks=[a[0], a[1]])
    rec(btm.free, 1)
    rec(btm.ref, b[0])                 # a cache node also holds it
    rec(btm.copy_on_write, 2, 0)
    rec(btm.unref, b[0])
    rec(btm.free, 2)
    rec(btm.free, 2)                   # a freed table again
    rec(btm.free, 123)                 # a never-allocated id


def seq_ref_rejects_trash_and_free(btm, rec):
    rec(btm.ref, 0)
    rec(btm.ref, 2)
    rec(btm.unref, 2)
    a = rec(btm.allocate, 1, 16)
    rec(btm.unref, a[0])
    rec(btm.unref, a[0])               # double free of the block


def seq_take_and_adopt(btm, rec):
    t = rec(btm.take, 2)
    rec(btm.allocate, 5, 40, prefix_blocks=t)
    rec(btm.ensure, 5, 70)
    rec(btm.take, 9)                   # more than the pool holds
    rec(btm.allocate, 6, 16, prefix_blocks=[7])   # a free block
    rec(btm.free, 5)


def seq_cow_write_checks(btm, rec):
    a = rec(btm.allocate, 1, 32)
    rec(btm.ref, a[1])                 # the trie's hold on the tail
    check = getattr(btm, "check_write", None)
    if check is not None:
        rec(check, 1, [a[0]])
        rec(check, 1, [a[1]])          # shared: no write without COW
        rec(check, 1, [0])
        rec(check, 2, [a[0]])          # no table
    new = rec(btm.copy_on_write, 1, 1)
    if check is not None:
        rec(check, 1, [new])
        rec(btm.check_conservation)
    rec(btm.free, 1)
    idle = getattr(btm, "check_idle", None)
    if idle is not None:
        rec(idle, (), 0)               # the trie's block is not accounted
        rec(idle, (), 1)
    rec(btm.unref, a[1])


def seq_pending_take_leaks(btm, rec):
    t = rec(btm.take, 1)
    idle = getattr(btm, "check_idle", None)
    if idle is not None:
        rec(idle)                      # taken, never adopted
    rec(btm.allocate, 3, 16, prefix_blocks=t)
    rec(btm.free, 3)
    if idle is not None:
        rec(idle)


SEQUENCES = [seq_share_and_cow, seq_ref_rejects_trash_and_free,
             seq_take_and_adopt, seq_cow_write_checks, seq_pending_take_leaks]


def _trace(pkg, sanitized, seq):
    kv, san, _ = PACKAGES[pkg]
    cls = san.SanitizedBlockTableManager if sanitized \
        else kv.BlockTableManager
    btm = cls(num_blocks=8, block_size=16)
    log = []
    seq(btm, _recorder(btm, log))
    return log


@pytest.mark.parametrize("sanitized", [False, True],
                         ids=["plain", "sanitized"])
@pytest.mark.parametrize("seq", SEQUENCES, ids=lambda f: f.__name__[4:])
def test_block_refcounts_match_reference(seq, sanitized):
    want = _trace("jax", sanitized, seq)
    got = _trace("port", sanitized, seq)
    assert got == want
    errors = [res for _, res, *_ in got if isinstance(res, str)]
    if sanitized and seq is not seq_share_and_cow:
        assert "SanitizerError" in errors


def _cached_prompt(btm, cache, tokens, rid):
    """A request donating its prompt: allocate, insert, free."""
    blocks = btm.allocate(rid, len(tokens))
    new = cache.insert(tokens, blocks)
    btm.free(rid)
    return blocks, new


def _m(m):
    return (list(m.full_blocks), m.full_tokens, m.tail_block, m.tail_tokens)


def radix_match_full_partial_and_cap(btm, cache):
    prompt = list(range(100, 110))              # chunks [4][4][2]
    out = [_cached_prompt(btm, cache, prompt, 1)]
    out.append((cache.cached_blocks, cache.evictable_blocks()))
    m = cache.match(prompt)                     # capped at len - 1
    out += [_m(m), btm.ref_count(m.full_blocks[0])]
    cache.release(m)
    out.append(btm.ref_count(m.full_blocks[0]))
    for p in (prompt[:9] + [999] * 3, prompt[:6] + [777] * 6,
              [1, 2, 3, 4, 5, 6]):
        out.append(_m(cache.match(p, take_refs=False)))
    return out


def radix_insert_dedup_and_branching(btm, cache):
    out = [_cached_prompt(btm, cache, [1, 2, 3, 4, 10, 11], 1),
           _cached_prompt(btm, cache, [1, 2, 3, 4, 20, 21], 2),
           cache.cached_blocks, btm.free_blocks,
           _cached_prompt(btm, cache, [1, 2, 3, 4, 10, 11], 3),
           cache.cached_blocks, btm.free_blocks]
    # a partial tail a cached full block already covers is not cached
    out.append(_cached_prompt(btm, cache, [1, 2, 3, 4, 10], 4))
    return out + [cache.cached_blocks]


def radix_lru_eviction_leaf_first(btm, cache):
    out = [_cached_prompt(btm, cache, [1, 2, 3, 4, 5, 6, 7, 8], 1),
           _cached_prompt(btm, cache, [9, 9, 9, 9], 2)]
    m = cache.match([1, 2, 3, 4, 5, 6, 7, 8, 9])
    out += [_m(m), cache.evict(1), btm.free_blocks,
            _m(cache.match([9, 9, 9, 9, 1], take_refs=False)),
            cache.evict(2)]
    cache.release(m)
    out += [cache.evict(2), cache.cached_blocks, btm.free_blocks]
    return out


def radix_never_evicts_referenced(btm, cache):
    out = [_cached_prompt(btm, cache, [1, 2, 3, 4, 5, 6, 7, 8], 1)]
    m = cache.match([1, 2, 3, 4, 5, 6, 7, 8, 9])
    out += [_m(m), cache.evictable_blocks(), cache.evict(5)]
    cache.release(m)
    return out + [cache.evict(5), cache.stats()]


def radix_hits_misses_and_stats(btm, cache):
    out = [_cached_prompt(btm, cache, list(range(30, 43)), 1)]
    for p in (list(range(30, 43)), list(range(30, 36)) + [1, 1],
              [5, 5, 5], list(range(30, 50))):
        m = cache.match(p)
        out.append(_m(m))
        cache.release(m)
    return out + [cache.stats(), cache.metrics()]


RADIX = [radix_match_full_partial_and_cap, radix_insert_dedup_and_branching,
         radix_lru_eviction_leaf_first, radix_never_evicts_referenced,
         radix_hits_misses_and_stats]


@pytest.mark.parametrize("seq", RADIX, ids=lambda f: f.__name__[6:])
def test_radix_cache_matches_reference(seq):
    results = []
    for pkg in ("jax", "port"):
        kv, _, pc = PACKAGES[pkg]
        btm = kv.BlockTableManager(num_blocks=32, block_size=4)
        results.append(seq(btm, pc.RadixPrefixCache(btm)))
    assert results[1] == results[0]


def test_evictable_count_is_what_eviction_can_reclaim():
    """Two prompts sharing two chunks, donated from one admission batch:
    the second's copies of the shared chunks stay private, and its own
    third chunk hangs below the first's cached second chunk.  Once the
    first finishes, the reference counts every ref-1 node evictable (3),
    though leaf-first eviction reaches only the first's third chunk; the
    port counts what `evict` returns (1), so its planner never promises
    capacity the engine cannot reclaim."""
    counts = {}
    for pkg in ("jax", "port"):
        kv, _, pc = PACKAGES[pkg]
        btm = kv.BlockTableManager(num_blocks=16, block_size=4)
        cache = pc.RadixPrefixCache(btm)
        a = btm.allocate(1, 12)
        b = btm.allocate(2, 12)
        cache.insert([1, 2, 3, 4, 5, 6, 7, 8, 9, 9, 9, 9], a)
        cache.insert([1, 2, 3, 4, 5, 6, 7, 8, 7, 7, 7, 7], b)
        btm.free(1)                    # the second request stays live
        counts[pkg] = (cache.evictable_blocks(), cache.evict(3))
    assert counts["jax"] == (3, 1)
    assert counts["port"] == (1, 1)


# ---------------------------------------------------------------------------
# The model: suffix prefill
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


@pytest.mark.parametrize("prefix_len", [0, 16, 37])
def test_prefill_suffix_matches_reference(weights, prefix_len):
    """Suffix prefill at a position offset, over prefix KV from numpy:
    logits and suffix-only K/V equal the reference's; with the prefix's
    own KV (from a prefill of the prefix) the suffix logits equal a full
    prompt's prefill."""
    jcfg, jparams, tparams = weights
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(prefix_len)
    b, s = 3, 24
    toks = rng.integers(1, cfg.vocab_size, (b, s)).astype(np.int32)
    lens = np.array([24, 9, 1], np.int32)
    shape = (cfg.num_layers, b, prefix_len, cfg.num_kv_heads, cfg.head_dim)
    pk = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    pv = (rng.standard_normal(shape) * 0.5).astype(np.float32)
    want_logits, want = jax_prefill_suffix(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(pk), jnp.asarray(pv),
        prefix_len=prefix_len, true_lengths=jnp.asarray(lens),
        cache_dtype=jnp.float32)
    logits, parts = prefill_suffix(
        cfg, tparams, torch.from_numpy(toks.astype(np.int64)),
        torch.from_numpy(pk), torch.from_numpy(pv), prefix_len=prefix_len,
        true_lengths=torch.from_numpy(lens), cache_dtype=torch.float32)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want_logits),
                               **MODEL_TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(parts[key].numpy(), np.asarray(want[key]),
                                   **MODEL_TOL)
    # the prefix's own KV: suffix logits == the full prompt's
    full = rng.integers(1, cfg.vocab_size, (1, prefix_len + 12))
    full_t = torch.from_numpy(full.astype(np.int64))
    want_full, _ = prefill(cfg, tparams, full_t)
    if prefix_len:
        _, pre = prefill(cfg, tparams, full_t[:, :prefix_len],
                         cache_dtype=torch.float32)
        pk_t, pv_t = pre["k"], pre["v"]
    else:
        pk_t = pv_t = torch.zeros((cfg.num_layers, 1, 0, cfg.num_kv_heads,
                                   cfg.head_dim))
    got_full, _ = prefill_suffix(cfg, tparams, full_t[:, prefix_len:],
                                 pk_t, pv_t, prefix_len=prefix_len)
    np.testing.assert_allclose(got_full.numpy(), want_full.numpy(),
                               **MODEL_TOL)


# ---------------------------------------------------------------------------
# The engine: client streams and prefix mechanics
# ---------------------------------------------------------------------------

SYS = [(7 * i) % 200 + 3 for i in range(20)]   # a block and 4 tokens


def _engine(tparams):
    return InferenceEngine(get_smoke_config(ARCH), tparams,
                           ladder=BucketLadder(**LADDER), device="cpu")


def _jax_engine(jcfg, jparams):
    return JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER))


def _workload(seed, n=8):
    """Requests sharing SYS (its 4-token tail forces copy-on-write),
    short cold ones and longer cold ones; every third is sampled."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        kind = ("sys", "short", "sys", "long")[i % 4]
        if kind == "sys":
            plen = int(rng.integers(1, 14))
            prompt = SYS + [int(t) for t in rng.integers(1, 256, plen)]
        elif kind == "long":
            prompt = [int(t) for t in rng.integers(1, 256,
                                                   int(rng.integers(30, 44)))]
        else:
            prompt = [int(t) for t in rng.integers(1, 256,
                                                   int(rng.integers(2, 10)))]
        sampled = i % 3 == 1
        out.append((prompt, dict(
            max_new_tokens=int(rng.integers(3, min(20, 64 - len(prompt)))),
            temperature=0.9 if sampled else 0.0,
            top_k=20 if sampled else 0, top_p=0.9 if sampled else 1.0,
            seed=100 + i)))
    return out


def _serve(client, make_params, work, first=2, ticks=3):
    """Submit ``first`` requests, tick a few times, then the rest arrive
    mid-decode."""
    handles = [client.submit(p, make_params(**g)) for p, g in work[:first]]
    client.pump(max_ticks=ticks)
    handles += [client.submit(p, make_params(**g)) for p, g in work[first:]]
    return handles, [h.result() for h in handles]


def serve_both(weights, work, *, packed, chunked, prefix_cache=True,
               **engine_kw):
    """Serve ``work`` through the reference client and the port's with
    the same engine and pipeline options; returns both clients and both
    results."""
    jcfg, jparams, tparams = weights
    opts = dict(max_slots=4, cap_new=24, packed_prefill=packed,
                prefix_cache=prefix_cache, **engine_kw)
    pipe = dict(policy="dp", max_batch_size=4, chunked_prefill=chunked,
                prefill_chunk_tokens=16)
    jclient = JaxClient(JaxContinuousEngine(_jax_engine(jcfg, jparams),
                                            **opts),
                        cost_model=JaxCostModel(**COST),
                        config=JaxPipelineConfig(**pipe), warmup=False)
    _, want = _serve(jclient, JaxParams, work)
    client = TurboClient(ContinuousEngine(_engine(tparams), **opts),
                         cost_model=AnalyticCostModel(**COST),
                         config=PipelineConfig(**pipe))
    handles, got = _serve(client, GenerationParams, work)
    return jclient, client, want, got, handles


def counters(client):
    """What the two packages must agree on: the engine's prefix and
    pack counters and the pipeline's scheduling counters."""
    ce, pipe = client.backend, client.pipeline
    m = pipe.obs.metrics
    return {"prefix": ce.prefix_stats(),
            "prefill_dispatches": ce.prefill_dispatches,
            "pack_dispatches": ce.pack_dispatches,
            "pack_segments": ce.pack_segments,
            "stats": pipe.stats.__dict__,
            "veto": {r: m.counter("pipeline.veto." + r).value
                     for r in ("stall", "capacity", "pack_wait")},
            "batches": pipe.batch_log}


def assert_drained(ce):
    """The drained pool holds only the warm cache, all of it evictable."""
    btm = ce.block_table
    held = btm.used_blocks
    assert held == ce.prefix_cache.cached_blocks
    assert ce.prefix_cache.evict(held) == held
    assert btm.used_blocks == 0 and not ce._reserved
    assert not ce._chunk_slots and ce.engine.kv_slab.live_bytes == 0


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
@pytest.mark.parametrize("seed", [3, 4])
def test_prefix_client_streams_match_reference(weights, seed, packed):
    """Greedy and seeded-sampled streams with ``prefix_cache=True`` equal
    the reference client's token for token; hits, reused tokens, copies
    and prefilled tokens equal the reference's."""
    work = _workload(seed)
    jclient, client, want, got, handles = serve_both(
        weights, work, packed=packed, chunked=False)
    assert got == want
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    assert counters(client) == counters(jclient)
    stats = client.backend.prefix_stats()
    assert stats["hits"] > 0 and stats["cow_blocks"] > 0
    assert_drained(client.backend)


def _port_ce(tparams, **kw):
    kw.setdefault("max_slots", 4)
    kw.setdefault("cap_new", 16)
    return ContinuousEngine(_engine(tparams), prefix_cache=True, **kw)


def _client(ce):
    return TurboClient(ce, cost_model=AnalyticCostModel(**COST),
                       config=PipelineConfig(policy="dp", max_batch_size=4))


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
def test_cow_on_mid_block_divergence_keeps_the_cached_block(weights,
                                                            packed):
    """A prompt sharing a cached prefix INTO the middle of a block copies
    that block at admission; the cached original's bytes are unchanged,
    and both streams equal the request served alone."""
    _, _, tparams = weights
    p1 = SYS + [1, 2, 3, 4, 5, 6, 7, 8]
    p2 = SYS + [1, 2, 3, 9, 9]               # diverges mid-block 2
    ce = _port_ce(tparams, packed_prefill=packed)
    client = _client(ce)
    a = client.submit(p1, GenerationParams(max_new_tokens=4)).result()
    m = ce.prefix_cache.match(p2, take_refs=False)
    assert m.full_tokens == 16 and m.tail_tokens == 7
    before = {k: ce.state.cache[k][:, m.tail_block].clone()
              for k in ("k", "v")}
    cows = ce.cow_blocks
    b = client.submit(p2, GenerationParams(max_new_tokens=6)).result()
    assert ce.cow_blocks > cows
    for k in ("k", "v"):
        assert torch.equal(ce.state.cache[k][:, m.tail_block], before[k])
    eng = ce.engine
    assert a == eng.generate([p1], max_new_tokens=4)[0]
    assert b == eng.generate([p2], max_new_tokens=6)[0]
    assert_drained(ce)


def test_owner_decode_cow_keeps_cached_tail_pristine(weights):
    """A prompt whose partial tail block is donated copies it before its
    first decode write; the same prompt again reuses all but its last
    token and still equals the request alone."""
    _, _, tparams = weights
    prompt = list(range(50, 70))             # a block and a 4-token tail
    ce = _port_ce(tparams, max_slots=2)
    client = _client(ce)
    a = client.submit(prompt, GenerationParams(max_new_tokens=6)).result()
    assert ce.cow_blocks >= 1 and ce.prefix_cache.cached_blocks == 2
    before = ce.prefill_tokens
    b = client.submit(prompt, GenerationParams(max_new_tokens=6)).result()
    assert ce.prefill_tokens == before + 1
    assert a == b == ce.engine.generate([prompt], max_new_tokens=6)[0]


def test_lru_eviction_under_pool_pressure(weights):
    """With a pool too small to keep the cache warm, a new prompt evicts
    unreferenced cached blocks instead of failing."""
    _, _, tparams = weights
    ce = _port_ce(tparams, max_slots=2, block_size=16, max_len=64,
                  num_blocks=6)                          # 5 usable
    client = _client(ce)
    p1, p2 = list(range(200, 235)), list(range(10, 40))
    a = client.submit(p1, GenerationParams(max_new_tokens=4)).result()
    assert ce.prefix_cache.cached_blocks == 3
    b = client.submit(p2, GenerationParams(max_new_tokens=5)).result()
    assert ce.prefix_cache.evicted_blocks > 0
    assert a == ce.engine.generate([p1], max_new_tokens=4)[0]
    assert b == ce.engine.generate([p2], max_new_tokens=5)[0]
    assert ce.block_table.used_blocks == ce.prefix_cache.cached_blocks


def test_shared_blocks_raise_admission_concurrency(weights):
    """Two sessions whose raw block demand exceeds the pool decode
    together once their common prefix is cached and pinned."""
    _, _, tparams = weights
    sys32 = list(range(3, 35))
    ce = _port_ce(tparams, block_size=16, max_len=64, num_blocks=8)
    client = _client(ce)
    client.submit(sys32 + [40], GenerationParams(max_new_tokens=1)).result()
    ha = client.submit(sys32 + [41], GenerationParams(max_new_tokens=8))
    hb = client.submit(sys32 + [42], GenerationParams(max_new_tokens=8))
    overlapped = False
    for _ in range(200):
        client.pump(max_ticks=1)
        overlapped |= (ha.session.state is SessionState.DECODE and
                       hb.session.state is SessionState.DECODE)
        if ha.session.is_finished and hb.session.is_finished:
            break
    assert overlapped
    eng = ce.engine
    assert ha.result() == eng.generate([sys32 + [41]], max_new_tokens=8)[0]
    assert hb.result() == eng.generate([sys32 + [42]], max_new_tokens=8)[0]
