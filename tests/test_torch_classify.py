"""The port's one-shot classification path against the JAX package's.

The paper's attention (`attention_naive`: scores, the masked softmax,
weights times V) and `InferenceEngine.classify` run on the same numpy
inputs and, for the engine, the same weights (the reference's
`init_params`, carried over by the bridge) in f32 on the CPU, where the
port's softmax is its plain version; both sides differ only in summation
order, hence the 1e-5 (one attention) and 1e-4 (logits after every
layer) tolerances.  The warm-up's cost table and the cost models
built on it are held against the reference's on the same table.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.core.cost_model import BucketedCostModel as JaxBucketed
from repro.core.cost_model import TableCostModel as JaxTable
from repro.models import init_params as jax_init_params
from repro.models import layers as jlayers
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro_torch.configs import get_smoke_config
from repro_torch.core.cost_model import BucketedCostModel, TableCostModel
from repro_torch.kernels import ref
from repro_torch.models import layers
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import InferenceEngine

ARCH = "internlm2-1.8b"
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(1, 2, 4, 8))


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


def _prompts(seed, lengths):
    rng = np.random.default_rng(seed)
    return [[int(t) for t in rng.integers(1, 256, n)] for n in lengths]


@pytest.mark.parametrize("b,sq,sk,h,kv,causal,q_offset", [
    (2, 12, 12, 4, 2, True, 0),        # GQA causal prefill
    (1, 9, 9, 4, 4, False, 0),         # MHA, no mask
    (2, 5, 16, 8, 2, True, 11),        # suffix queries at an offset
    (3, 7, 7, 4, 1, True, 0),          # MQA
])
def test_attention_naive_matches_reference(b, sq, sk, h, kv, causal,
                                           q_offset):
    rng = np.random.default_rng(sq * 10 + h)
    dh = 16
    q = rng.standard_normal((b, sq, h, dh), np.float32)
    k = rng.standard_normal((b, sk, kv, dh), np.float32)
    v = rng.standard_normal((b, sk, kv, dh), np.float32)
    cfg = get_smoke_config(ARCH)
    got = layers.attention_naive(cfg, torch.from_numpy(q),
                                 torch.from_numpy(k), torch.from_numpy(v),
                                 causal=causal, q_offset=q_offset)
    want = jlayers.attention_naive(jax_smoke_config(ARCH), jnp.asarray(q),
                                   jnp.asarray(k), jnp.asarray(v),
                                   causal=causal, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("lengths", [(5, 31, 12), (64,), (3, 40, 17, 60, 9)])
def test_classify_matches_reference(engines, lengths):
    jeng, teng = engines
    prompts = _prompts(len(lengths), lengths)
    assert teng.classify(prompts) == jeng.classify(prompts)
    toks, last, seq_b, batch_b = jeng._pad_batch(prompts)
    want = jeng._classify_fn(seq_b, batch_b)(jeng.params, toks, last)
    got = teng.classify_logits(prompts)
    np.testing.assert_allclose(got.numpy(), np.asarray(want)[:len(prompts)],
                               rtol=1e-4, atol=1e-4)


def test_classify_takes_the_softmax_route_once_per_layer(engines,
                                                         monkeypatch):
    """Every layer's attention goes through the masked softmax (its plain
    version on the CPU), none through flash attention; padding rows of the
    batch bucket do not change the real rows' classes."""
    _, teng = engines
    calls = {"softmax": 0, "flash": 0}
    softmax_ref, flash_ref = ref.softmax_ref, ref.flash_attention_ref

    def count_softmax(*a, **k):
        calls["softmax"] += 1
        return softmax_ref(*a, **k)

    def count_flash(*a, **k):
        calls["flash"] += 1
        return flash_ref(*a, **k)
    monkeypatch.setattr(ref, "softmax_ref", count_softmax)
    monkeypatch.setattr(ref, "flash_attention_ref", count_flash)
    prompts = _prompts(7, (4, 20, 33))          # batch bucket 4, seq 64
    preds = teng.classify(prompts)
    assert calls == {"softmax": teng.cfg.num_layers, "flash": 0}
    assert preds == [teng.classify([p])[0] for p in prompts]


def test_warmup_builds_the_cost_table(engines):
    _, teng = engines
    cost = teng.warmup(lengths=(32, 64), batches=(1, 4), repeats=1)
    assert isinstance(cost, TableCostModel)
    assert set(cost.table) == {(32, 1), (32, 4), (64, 1), (64, 4)}
    assert all(t > 0 for t in cost.table.values())


def test_cost_models_match_reference_on_a_grid():
    rng = np.random.default_rng(0)
    table = {(ln, b): float(1e-3 + 1e-6 * ln * b * rng.uniform(0.5, 1.5))
             for ln in (32, 128, 512) for b in (1, 4, 16)}
    del table[(128, 4)]                      # a hole: nearest-batch scaling
    ours, theirs = TableCostModel(table), JaxTable(table)
    ours.observe(128, 16, 0.02)
    theirs.observe(128, 16, 0.02)
    ours.observe(256, 2, 0.004)              # a new grid point
    theirs.observe(256, 2, 0.004)
    buckets = (32, 64, 128, 256, 512)
    b_ours = BucketedCostModel(ours, buckets=buckets)
    b_theirs = JaxBucketed(theirs, buckets=buckets)
    for ln in (1, 5, 32, 77, 128, 200, 256, 300, 512, 900):
        for b in (1, 2, 3, 4, 9, 16, 20, 33):
            assert ours.latency(ln, b) == theirs.latency(ln, b)
            assert b_ours.latency(ln, b) == b_theirs.latency(ln, b)
            assert b_ours.prefill_latency(ln, b) == \
                b_theirs.prefill_latency(ln, b)
        assert b_ours.decode_latency(4, ln) == b_theirs.decode_latency(4, ln)
