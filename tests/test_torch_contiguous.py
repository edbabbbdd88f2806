"""The port's contiguous KV layout against the JAX package's.

The contiguous slot cache (one ``max_len`` stripe per row, the JAX
package's equivalence baseline for the paged pool) serves the smoke
config of InternLM2-1.8B on the same weights (the reference's
`init_params`, carried over by the bridge) in f32 on the CPU.  Decode
logits are held to 1e-4 (summation order over every layer); streams are
compared token for token, against the reference's contiguous engine and
against the port's own paged engine.  The sanitizer is on (pytest turns
it on).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import TurboClient as JaxClient
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_smoke_config
from repro_torch.models import decode_step, prefill
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine

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


def _jax(jcfg, jparams):
    return JaxContinuousEngine(
        JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER)),
        max_slots=4, cap_new=24, kv_layout="contiguous")


def _workload(seed, n=8, first_short=4):
    """The first ``first_short`` requests fit the 32 bucket (the slot
    cache is sized for them), later ones need 64, so the cache grows
    mid-decode; every third request samples."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(2, 12 if i < first_short else 40))
        new = int(rng.integers(3, 32 - plen if i < first_short else 20))
        sampled = i % 3 == 1
        out.append(([int(t) for t in rng.integers(1, 256, plen)], dict(
            max_new_tokens=new, temperature=0.9 if sampled else 0.0,
            top_k=20 if sampled else 0, top_p=0.9 if sampled else 1.0,
            seed=200 + i)))
    return out


def _serve(client, make_params, work, first=4, ticks=3):
    handles = [client.submit(p, make_params(**g)) for p, g in work[:first]]
    client.pump(max_ticks=ticks)
    handles += [client.submit(p, make_params(**g)) for p, g in work[first:]]
    return handles, [h.result() for h in handles]


def test_contiguous_decode_step_matches_reference(weights):
    """Ragged prompts prefilled into a contiguous cache, then decode steps
    on both sides: logits within 1e-4 at every step."""
    jcfg, jparams, tparams = weights
    cfg = get_smoke_config(ARCH)
    rng = np.random.default_rng(4)
    lens = np.array([5, 17, 9], np.int32)
    toks = np.zeros((3, 24), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, 256, n)
    jl, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks), max_len=32,
                             true_lengths=jnp.asarray(lens),
                             cache_dtype=jnp.float32)
    tl, tcache = prefill(cfg, tparams, torch.from_numpy(toks.astype(np.int64)),
                         max_len=32, true_lengths=torch.from_numpy(lens),
                         cache_dtype=torch.float32)
    assert "block_tables" not in tcache
    assert tuple(tcache["k"].shape) == tuple(jcache["k"].shape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    cur = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(4):
        jl, jcache = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(cur))
        tl, tcache = decode_step(cfg, tparams, tcache, torch.from_numpy(cur))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
        cur = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_contiguous_streams_match_reference_token_for_token(weights):
    jcfg, jparams, tparams = weights
    work = _workload(1)
    _, want = _serve(JaxClient(_jax(jcfg, jparams), warmup=False),
                     JaxParams, work)
    ce = _port(tparams, kv_layout="contiguous")
    handles, got = _serve(TurboClient(ce), GenerationParams, work)
    assert got == want
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    assert ce.max_len == 64 and ce.block_table is None   # grew 32 -> 64
    assert ce.engine.kv_slab.live_bytes == 0


def test_contiguous_streams_equal_the_paged_streams(weights):
    _, _, tparams = weights
    work = _workload(2)
    _, contiguous = _serve(TurboClient(_port(tparams,
                                             kv_layout="contiguous")),
                           GenerationParams, work)
    paged_ce = _port(tparams)
    _, paged = _serve(TurboClient(paged_ce), GenerationParams, work)
    assert contiguous == paged
    assert paged_ce.block_table.used_blocks == 0


def test_contiguous_serving_equals_generate_alone(weights):
    _, _, tparams = weights
    work = [(p, dict(g, temperature=0.0)) for p, g in _workload(3, n=6)]
    ce = _port(tparams, kv_layout="contiguous")
    _, got = _serve(TurboClient(ce), GenerationParams, work, first=3)
    for (prompt, g), res in zip(work, got):
        assert res == ce.engine.generate([prompt],
                                         max_new_tokens=g["max_new_tokens"])[0]


def test_contiguous_cancel_and_invariants(weights):
    _, _, tparams = weights
    ce = _port(tparams, kv_layout="contiguous", max_len=64)
    client = TurboClient(ce)
    long = client.submit(list(range(1, 30)),
                         GenerationParams(max_new_tokens=20))
    other = client.submit(list(range(3, 9)),
                          GenerationParams(max_new_tokens=10))
    client.pump(max_ticks=4)
    ce.check_invariants(client.pipeline)
    assert long.cancel()
    assert long.cancelled and 0 < len(long.result()) - 29 < 20
    other.result()
    ce.check_invariants(client.pipeline)
    assert ce.engine.kv_slab.live_bytes == 0
    assert ce.max_len == 64
    with pytest.raises(ValueError, match="exceeds max_len 64"):
        client.submit(list(range(1, 60)), GenerationParams(max_new_tokens=8))


def test_decode_step_batch_advances_a_prefilled_contiguous_state(weights):
    """As in the JAX package, a prefilled GenState (a contiguous cache of
    ``max_len`` positions) decodes in place; the stream equals
    ``generate`` (which decodes over its own paged pool)."""
    _, _, tparams = weights
    eng = _port(tparams).engine
    prompts = [[5, 9, 3, 7], list(range(10, 30))]
    state = eng.prefill_batch(prompts, max_len=32, max_new_tokens=8)
    assert tuple(state.cache["k"].shape[1:3]) == (4, 32)
    for _ in range(7):
        state = eng.decode_step_batch(state)
    assert eng.read_out(state, prompts) == eng.generate(prompts,
                                                        max_new_tokens=8)


def test_client_warmup_runs_the_engine_warmup_aot(weights):
    jcfg, jparams, tparams = weights
    ce = _port(tparams, kv_layout="contiguous")
    client = TurboClient(ce, warmup=True)
    stats = client.warmup_stats
    assert set(stats) == {"compile_count", "warmup_seconds", "rounds"}
    # the reference's walk: as many rounds as its warm-up of the same
    # configuration
    assert stats["rounds"] == _jax(jcfg, jparams).warmup_aot()["rounds"]
    assert stats["compile_count"] == 0        # no graph on the CPU
    # the slot cache at the top bucket, every slot free
    assert ce.max_len == LADDER["seq_buckets"][-1]
    assert tuple(ce.state.cache["k"].shape[1:3]) == (4, ce.max_len)
    assert bool(ce.state.done.all()) and not ce.state.sampling
    assert not hasattr(ce.engine, "warmup_aot")
