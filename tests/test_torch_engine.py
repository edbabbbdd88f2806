"""The port's serving stack against the JAX package's, token for token.

Both stacks serve the smoke config of InternLM2-1.8B on the same weights
(the reference's `init_params`, carried over by the bridge) on the CPU
in f32: the reference is `TurboClient` over its `ContinuousEngine`, the
port is `repro_torch.api.TurboClient`.  Here both run the per-group
prefill (``packed_prefill=False``); the packed default is held against
the reference's in tests/test_torch_packed.py.  Streams are compared
exactly: greedy tokens are argmaxes, and sampled tokens draw bit-equal
noise (tests/test_torch_sampling.py).  The sanitizer is on (pytest turns
it on), so every block write is checked and leaks raise.
"""
import jax
import numpy as np
import pytest

from repro.api import TurboClient as JaxClient
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_smoke_config
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime import sanitizer
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
from repro_torch.runtime.session import SessionState

ARCH = "internlm2-1.8b"
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(4,))


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


def _port(tparams, **kw):
    engine = InferenceEngine(get_smoke_config(ARCH), tparams,
                             ladder=BucketLadder(**LADDER), device="cpu")
    return ContinuousEngine(engine, max_slots=4, cap_new=24, **kw)


def _workload(seed, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(2, 40))
        sampled = i % 3 == 1
        out.append(([int(t) for t in rng.integers(1, 256, plen)], dict(
            max_new_tokens=int(rng.integers(3, 20)),
            temperature=0.9 if sampled else 0.0,
            top_k=20 if sampled else 0, top_p=0.9 if sampled else 1.0,
            seed=100 + i)))
    return out


def _serve(client, make_params, work, first=4, ticks=3):
    """Submit ``first`` requests, tick a few times, then the rest arrive
    mid-decode."""
    handles = [client.submit(p, make_params(**g)) for p, g in work[:first]]
    client.pump(max_ticks=ticks)
    handles += [client.submit(p, make_params(**g)) for p, g in work[first:]]
    return handles, [h.result() for h in handles]


def test_client_streams_match_reference_token_for_token(weights):
    jcfg, jparams, tparams = weights
    work = _workload(1)
    jce = JaxContinuousEngine(
        JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER)),
        max_slots=4, cap_new=24, packed_prefill=False)
    _, want = _serve(JaxClient(jce, warmup=False), JaxParams, work)
    ce = _port(tparams, packed_prefill=False)
    handles, got = _serve(TurboClient(ce), GenerationParams, work)
    assert got == want
    assert ce.pack_dispatches == 0
    streamed = [h.tokens() for h in handles]
    assert streamed == [r[len(p):] for r, (p, _) in zip(got, work)]
    assert ce.block_table.used_blocks == 0
    assert ce.engine.kv_slab.live_bytes == 0


def test_generate_matches_reference_generate(weights):
    jcfg, jparams, tparams = weights
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, 256, n)] for n in (3, 17)]
    jeng = JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER))
    teng = _port(tparams).engine
    assert teng.generate(prompts, max_new_tokens=9) == \
        jeng.generate(prompts, max_new_tokens=9)


def test_continuous_batching_equals_generate_alone(weights):
    _, _, tparams = weights
    work = [(p, dict(g, temperature=0.0)) for p, g in _workload(3, n=7)]
    ce = _port(tparams)
    _, got = _serve(TurboClient(ce), GenerationParams, work, first=3)
    for (prompt, g), res in zip(work, got):
        alone = ce.engine.generate([prompt],
                                   max_new_tokens=g["max_new_tokens"])[0]
        assert res == alone


def test_seeded_stream_is_reproducible_across_batches(weights):
    _, _, tparams = weights
    prompt = list(range(5, 25))
    params = dict(max_new_tokens=12, temperature=1.1, seed=42)
    alone = TurboClient(_port(tparams)).submit(
        prompt, GenerationParams(**params)).result()
    work = _workload(4, n=5)
    work.insert(2, (prompt, params))
    _, got = _serve(TurboClient(_port(tparams)), GenerationParams, work,
                    first=2)
    assert got[2] == alone


def test_cancel_frees_blocks_and_keeps_partial_tokens(weights):
    _, _, tparams = weights
    ce = _port(tparams)
    client = TurboClient(ce)
    long = client.submit(list(range(1, 30)),
                         GenerationParams(max_new_tokens=20))
    other = client.submit(list(range(3, 9)),
                          GenerationParams(max_new_tokens=20))
    client.pump(max_ticks=4)
    assert isinstance(ce.block_table, sanitizer.SanitizedBlockTableManager)
    assert long.state is SessionState.DECODE
    held = ce.block_table.used_blocks
    assert long.cancel()
    assert ce.block_table.used_blocks < held
    partial = long.result()
    assert long.cancelled and 0 < len(partial) - 29 < 20
    queued = client.submit([5, 6, 7], GenerationParams(max_new_tokens=4))
    assert queued.cancel()
    other.result()
    assert not long.cancel()                     # already finished
    assert ce.block_table.used_blocks == 0
    assert ce.engine.kv_slab.live_bytes == 0
    ce.check_invariants(client.pipeline)


def test_sanitizer_catches_a_write_into_a_foreign_block(weights):
    _, _, tparams = weights
    ce = _port(tparams)
    client = TurboClient(ce)
    a = client.submit(list(range(1, 20)), GenerationParams(max_new_tokens=8))
    client.pump(max_ticks=1)
    theirs = ce.block_table.block_table(a.req_id)[0]
    ce.block_table.allocate(999, 16)
    with pytest.raises(sanitizer.SanitizerError):
        sanitizer.check_write(ce.block_table, 999, [theirs])
    ce.block_table.free(999)
    a.result()


@pytest.mark.parametrize("option", ["prefix_cache",
                                    "chunked_prefill+prefix_cache",
                                    "chunked_prefill", "kv_layout"])
def test_engine_refuses_options_not_ported_yet(weights, option):
    """Options the port does not serve raise, alone or together.  Both KV
    layouts of the JAX package are ported, so for ``kv_layout`` only a
    layout neither package has is refused; ``packed_prefill`` is ported
    (test_engine_accepts_packed_prefill_and_refuses_chunks)."""
    _, _, tparams = weights
    kw = ({"kv_layout": "ring"} if option == "kv_layout"
          else {o: True for o in option.split("+")})
    with pytest.raises(ValueError,
                       match="not ported yet|unknown kv_layout 'ring'"):
        _port(tparams, **kw)


def test_engine_accepts_packed_prefill_and_refuses_chunks(weights):
    """``packed_prefill=True`` is the default and is accepted; the chunk
    half of ``prefill_pack`` belongs to chunked prefill and raises."""
    _, _, tparams = weights
    ce = _port(tparams, packed_prefill=True)
    assert ce.supports_packed_prefill() and _port(tparams).packed_prefill
    client = TurboClient(ce)
    h = client.submit(list(range(1, 12)), GenerationParams(max_new_tokens=4))
    client.pump(max_ticks=1)
    live = next(s for s in ce.sessions if s is not None)
    with pytest.raises(ValueError, match="chunked prefill"):
        ce.prefill_pack([], chunks=[(live, 8)])
    h.result()
    assert ce.pack_dispatches == 1 and ce.block_table.used_blocks == 0


def test_port_pipeline_takes_the_per_group_prefill_path(weights):
    _, _, tparams = weights
    ce = _port(tparams, packed_prefill=False)
    assert not ce.supports_packed_prefill()
    client = TurboClient(ce)
    _serve(client, GenerationParams, _workload(5, n=6))
    assert ce.prefill_dispatches >= 2
    stats = client.pipeline.stats
    assert stats.admitted == 6 and stats.prefill_batches == \
        ce.prefill_dispatches
    assert len(client.pipeline.finished) == 6


def test_metrics_and_trace_record_every_request(weights, tmp_path):
    _, _, tparams = weights
    client = TurboClient(_port(tparams), trace=True)
    handles, _ = _serve(client, GenerationParams, _workload(6, n=5), first=3)
    snap = client.metrics()
    assert snap["counters"]["pipeline.admitted"] == 5
    events = client.trace_events()
    for h in handles:
        names = [e["name"] for e in events
                 if e["track"] == "request" and e["req"] == h.req_id]
        assert names[0] == "enqueue" and names[-1] == "finish"
        assert "prefill" in names and "decode" in names
    doc = client.save_trace(str(tmp_path / "trace.json"))
    assert (tmp_path / "trace.json").exists() and doc["traceEvents"]
