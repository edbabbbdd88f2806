"""The port's packed segment-id prefill against the JAX package's.

Packed prefill is the JAX package's default admission path: an admission
group's prompts are concatenated into one flat row with segment ids and
per-token positions and prefilled in one pass (`attention_packed`,
`prefill_packed`, `InferenceEngine.prefill_packed_flat`,
`ContinuousEngine.prefill_pack`).  Here the port's counterparts run on
the CPU in f32 (their plain attention, `kernels.ref.
flash_attention_packed_ref`) on the reference's weights, carried over by
the bridge, and on numpy inputs from a seed.  Tolerances are f32: 2e-5
on one attention call, 1e-4 on logits and K/V through the model, as in
tests/test_torch_models.py.  Packed and per-prompt prefill are held to
each other within a tolerance, not bit for bit: the reference itself is
not bit-invariant under pack composition on the CPU.  Streams are
compared token for token.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import TurboClient as JaxClient
from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill_packed as jax_prefill_packed
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import PipelineConfig
from repro_torch.kernels import ref
from repro_torch.models import prefill, prefill_packed
from repro_torch.models import layers as L
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine

ARCH = "internlm2-1.8b"
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(4,))
F32 = dict(rtol=2e-5, atol=2e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, jparams, tparams


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or F32))


def _t(a):
    return torch.from_numpy(np.array(a))


def _labels(fresh, prefix, pad_fresh, pad_prefix):
    """Segment ids and positions of a pack: each segment's ``prefix[i]``
    cached keys (positions 0..), then its ``fresh[i]`` tokens (positions
    ``prefix[i]..``); the prefix region first, its ids restarting at 0 in
    the fresh one; padding (id -1, position 0) after each region."""
    def region(parts, start, pad):
        seg, pos = [], []
        for i, (n, off) in enumerate(parts):
            seg += [i] * n
            pos += list(range(off, off + n))
        seg += [-1] * pad
        pos += [0] * pad
        return np.array(seg, np.int32), np.array(pos, np.int32)
    q_seg, q_pos = region([(n, p) for n, p in zip(fresh, prefix)], 0,
                          pad_fresh)
    p_seg, p_pos = region([(p, 0) for p in prefix], 0, pad_prefix)
    return q_seg, q_pos, np.concatenate([p_seg, q_seg]), \
        np.concatenate([p_pos, q_pos])


#: (fresh lengths, prefix lengths, fresh padding, prefix padding, H, KV):
#: mixed lengths with a one-token segment and padding; a prefix region
#: (with its own padding) under GQA; MHA
PACKS = {
    "mixed_one_token_padding": ((7, 1, 12, 3), (0, 0, 0, 0), 9, 0, 4, 2),
    "prefix_gqa": ((5, 9, 1), (4, 0, 6), 1, 6, 8, 2),
    "mha_prefix": ((3, 11), (2, 5), 2, 1, 2, 2),
}


@pytest.mark.parametrize("case", sorted(PACKS))
def test_packed_attention_matches_reference(weights, case):
    """The plain version and the port's ``attention_packed`` against the
    reference's ``attention_packed`` on real rows; every padding row of
    both port functions finite."""
    jcfg = weights[0]
    fresh, prefix, pad_f, pad_p, h, kv = PACKS[case]
    q_seg, q_pos, k_seg, k_pos = _labels(fresh, prefix, pad_f, pad_p)
    sq, sk, dh = len(q_seg), len(k_seg), 16
    rng = np.random.default_rng(sum(fresh) + h)
    q = rng.standard_normal((1, sq, h, dh), np.float32)
    k = rng.standard_normal((1, sk, kv, dh), np.float32)
    v = rng.standard_normal((1, sk, kv, dh), np.float32)
    want = np.asarray(JL.attention_packed(
        jcfg, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        q_seg=jnp.asarray(q_seg), k_seg=jnp.asarray(k_seg),
        q_pos=jnp.asarray(q_pos), k_pos=jnp.asarray(k_pos)))
    plain = ref.flash_attention_packed_ref(
        _t(q).transpose(1, 2), _t(k).transpose(1, 2), _t(v).transpose(1, 2),
        _t(q_seg), _t(k_seg), _t(q_pos), _t(k_pos)).transpose(1, 2)
    port = L.attention_packed(get_smoke_config(ARCH), _t(q), _t(k), _t(v),
                              q_seg=_t(q_seg), k_seg=_t(k_seg),
                              q_pos=_t(q_pos), k_pos=_t(k_pos))
    real = q_seg >= 0
    for got in (plain, port):
        _close(got.numpy()[:, real], want[:, real])
        assert np.isfinite(got.numpy()).all()


def _pack_inputs(fresh, prefix, pack, vocab, seed):
    """Flat tokens (1, pack), labels and last indices of a pack of
    segments with ``fresh`` new tokens after ``prefix`` cached ones."""
    rng = np.random.default_rng(seed)
    q_seg, q_pos, _, _ = _labels(fresh, prefix, pack - sum(fresh), 0)
    toks = np.zeros((1, pack), np.int32)
    toks[0, :sum(fresh)] = rng.integers(1, vocab, sum(fresh))
    last = np.cumsum(fresh).astype(np.int32) - 1
    p_seg, p_pos = _labels(fresh, prefix, 0, 0)[2:]
    n_pre = sum(prefix)
    return toks, q_seg, q_pos, last, p_seg[:n_pre], p_pos[:n_pre]


@pytest.mark.parametrize("with_prefix", [False, True])
def test_prefill_packed_matches_reference(weights, with_prefix):
    """Logits at each segment's last token and the suffix K/V, without a
    prefix and with random prefix KV before some segments."""
    jcfg, jparams, tparams = weights
    cfg = get_smoke_config(ARCH)
    fresh = (6, 1, 13)
    prefix = (5, 0, 3) if with_prefix else (0, 0, 0)
    toks, seg, pos, last, p_seg, p_pos = _pack_inputs(
        fresh, prefix, 32, cfg.vocab_size, 7)
    rng = np.random.default_rng(8)
    pre_shape = (cfg.num_layers, sum(prefix), cfg.num_kv_heads,
                 cfg.head_dim)
    pk = rng.standard_normal(pre_shape, np.float32)
    pv = rng.standard_normal(pre_shape, np.float32)
    want_logits, want_kv = jax_prefill_packed(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(seg),
        jnp.asarray(pos), jnp.asarray(last), jnp.asarray(pk),
        jnp.asarray(pv), jnp.asarray(p_seg), jnp.asarray(p_pos),
        cache_dtype=jnp.float32)
    logits, kv = prefill_packed(
        cfg, tparams, _t(toks).long(), _t(seg), _t(pos), _t(last), _t(pk),
        _t(pv), _t(p_seg), _t(p_pos), cache_dtype=torch.float32)
    _close(logits, want_logits, **MODEL_TOL)
    for key in ("k", "v"):
        assert tuple(kv[key].shape) == tuple(want_kv[key].shape)
        _close(kv[key], want_kv[key], **MODEL_TOL)


def _engine(tparams, batch_buckets=(4,)):
    return InferenceEngine(get_smoke_config(ARCH), tparams,
                           ladder=BucketLadder(seq_buckets=(32, 64),
                                               batch_buckets=batch_buckets),
                           device="cpu")


def test_prefill_packed_flat_matches_per_prompt_prefill(weights):
    """Each segment's last-token logits and K/V from one packed pass
    against the prompt's own prefill (a tolerance, not bit for bit)."""
    eng = _engine(weights[2])
    cfg = eng.cfg
    rng = np.random.default_rng(3)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (9, 1, 30, 17)]
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim))
    no_ids = torch.zeros((0,), dtype=torch.int32)
    logits, parts = eng.prefill_packed_flat(prompts, [0] * 4, no_kv, no_kv,
                                            no_ids, no_ids)
    assert tuple(parts["k"].shape[:2]) == (cfg.num_layers, 64)
    at = 0
    for i, p in enumerate(prompts):
        want, cache = prefill(cfg, eng.params, torch.tensor([p]),
                              cache_dtype=torch.float32)
        _close(logits[i], want[0], **MODEL_TOL)
        for key in ("k", "v"):
            _close(parts[key][:, at:at + len(p)], cache[key][:, 0],
                   **MODEL_TOL)
        at += len(p)


def test_prefill_packed_flat_refuses_an_empty_segment(weights):
    eng = _engine(weights[2])
    cfg = eng.cfg
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim))
    no_ids = torch.zeros((0,), dtype=torch.int32)
    with pytest.raises(ValueError, match="fresh token"):
        eng.prefill_packed_flat([[3, 4], []], [0, 0], no_kv, no_kv, no_ids,
                                no_ids)


def test_pack_wider_than_ladder_splits(weights):
    """An admission group wider than the ladder's top batch bucket splits
    into ladder-sized packs, with tokens equal to ``generate`` alone."""
    eng = _engine(weights[2], batch_buckets=(1, 2, 4))
    ce = ContinuousEngine(eng, max_slots=8, cap_new=16)
    client = TurboClient(ce, config=PipelineConfig(policy="naive",
                                                   max_batch_size=8))
    n = eng.ladder.batch_buckets[-1] + 2
    prompts = [[9 + i] * 10 for i in range(n)]
    handles = [client.submit(p, GenerationParams(max_new_tokens=6))
               for p in prompts]
    got = [h.result() for h in handles]
    assert client.pipeline.stats.prefill_batches == 1
    assert ce.pack_dispatches == ce.prefill_dispatches == 2
    assert ce.pack_segments == n
    assert [seg for seg, _, _ in ce.pack_log] == [4, 2]
    for p, res in zip(prompts, got):
        assert res == eng.generate([p], max_new_tokens=6)[0]
    assert ce.block_table.used_blocks == 0
    assert eng.kv_slab.live_bytes == 0


def test_failed_pack_sweeps_the_pool(weights, monkeypatch):
    """A pack that fails after its tables were allocated and its KV
    scattered leaves nothing behind: no used block, no pack ledger, no
    reservation, no occupied slot; the engine then serves again."""
    eng = _engine(weights[2])
    ce = ContinuousEngine(eng, max_slots=4, cap_new=16)
    client = TurboClient(ce)

    def fail(*args, **kwargs):
        assert ce.block_table.used_blocks > 0      # tables were allocated
        raise RuntimeError("injected failure after the scatter")
    monkeypatch.setattr(eng, "_finish_gen_state", fail)
    handles = [client.submit(list(range(2, 2 + n)),
                             GenerationParams(max_new_tokens=5))
               for n in (7, 19)]
    with pytest.raises(RuntimeError, match="injected"):
        client.pump(max_ticks=1)
    assert ce.block_table.used_blocks == 0
    assert ce._last_pack == {} and ce._reserved == {}
    assert all(s is None for s in ce.sessions)
    assert ce.pack_dispatches == 0
    assert all(h.done for h in handles)
    assert eng.kv_slab.live_bytes == 0
    ce.check_invariants(client.pipeline)
    monkeypatch.undo()
    res = client.submit([5, 6, 7], GenerationParams(max_new_tokens=3))
    assert len(res.result()) == 6 and ce.pack_dispatches == 1
    assert ce.block_table.used_blocks == 0


def _workload(seed, n=8):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        plen = int(rng.integers(1, 40))
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


@pytest.mark.parametrize("seed", [11, 12])
def test_default_client_matches_reference_default_client(weights, seed):
    """Greedy and seeded-sampled streams of the port's default client
    (packed prefill) equal the reference's default ``ContinuousEngine``
    (packed too) token for token, and the port's per-group path; the
    default serves every admission group as one packed dispatch, the
    per-group path none, and the packs pad fewer tokens."""
    jcfg, jparams, tparams = weights
    work = _workload(seed)
    jce = JaxContinuousEngine(
        JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER)),
        max_slots=4, cap_new=24)
    assert jce.supports_packed_prefill()
    _, want = _serve(JaxClient(jce, warmup=False), JaxParams, work)
    assert jce.pack_dispatches > 0
    ce = ContinuousEngine(_engine(tparams), max_slots=4, cap_new=24)
    client = TurboClient(ce)
    handles, got = _serve(client, GenerationParams, work)
    assert got == want
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    assert ce.pack_dispatches == ce.prefill_dispatches == \
        client.pipeline.stats.prefill_batches > 0
    assert ce.pack_segments == len(work)
    assert all(0 < flat <= bucket and bucket == ce.pack_bucket(flat)
               for _, flat, bucket in ce.pack_log)
    per_group = ContinuousEngine(_engine(tparams), max_slots=4, cap_new=24,
                                 packed_prefill=False)
    pg_client = TurboClient(per_group)
    pg_handles, got_pg = _serve(pg_client, GenerationParams, work)
    assert got_pg == got
    assert per_group.pack_dispatches == 0
    # both paths run one pass per batch of the shared planner, as the
    # reference's do; the per-group pass pads every prompt of a batch to
    # the batch's bucket, the pack only the batch's flat total to its own
    assert 0 < ce.prefill_dispatches == per_group.prefill_dispatches
    plen = {h.req_id: len(p) for h, (p, _) in zip(pg_handles, work)}
    ladder = per_group.engine.ladder
    padded = sum(ladder.batch_bucket(len(b)) *
                 ladder.seq_bucket(max(plen[r] for r in b))
                 for b in pg_client.pipeline.batch_log)
    assert sum(bucket for _, _, bucket in ce.pack_log) < padded
    for engine in (ce, per_group):
        assert engine.block_table.used_blocks == 0
        assert engine.engine.kv_slab.live_bytes == 0
