"""Qwen3-32B's head layout against the JAX package's on the CPU.

The smoke config has 4 query heads over 2 KV heads at dh 16; the served
model has 64 over 8 (group 8) at dh 128, with qk-norm over every head.
Here both packages' Qwen3 smoke configs are widened to that layout (2
layers, d_model 64, d_ff 128, vocab 256, f32), the reference draws the
weights and the bridge carries them over.  Held: a ragged prefill and
four decode steps over the contiguous and the paged cache, logits within
1e-4 (two summation orders and attention routines, as
tests/test_torch_archs.py); and the default client's greedy and
seeded-sampled streams (packed admission over the paged pool) token for
token.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import TurboClient as JaxClient
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AnalyticCostModel as JaxCostModel
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.models import decode_step, prefill
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
from tests.test_torch_archs import LADDER, _close, _decode_inputs, _paged
from tests.test_torch_packed import _workload
from tests.test_torch_prefix import COST, _serve

ARCH = "qwen3-32b"
FULL = get_config(ARCH)
#: the served model's heads on the smoke config's narrow widths
HEADS = dict(num_heads=FULL.num_heads, num_kv_heads=FULL.num_kv_heads,
             d_head=FULL.head_dim)


@pytest.fixture(scope="module")
def weights():
    jcfg = dataclasses.replace(jax_smoke_config(ARCH), **HEADS)
    cfg = dataclasses.replace(get_smoke_config(ARCH), **HEADS)
    assert (cfg.num_heads // cfg.num_kv_heads, cfg.head_dim, cfg.qk_norm) \
        == (8, 128, True)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, cfg, jparams, tparams


@pytest.fixture(scope="module")
def reference_run(weights):
    jcfg, cfg, jparams, _ = weights
    toks, lens, _, steps = _decode_inputs(cfg)
    logits, cache = jax_prefill(jcfg, jparams, jnp.asarray(toks), max_len=32,
                                true_lengths=jnp.asarray(lens),
                                cache_dtype=jnp.float32)
    out = [(np.asarray(logits), np.asarray(cache["len"]))]
    for tok in steps:
        logits, cache = jax_decode_step(jcfg, jparams, cache,
                                        jnp.asarray(tok))
        out.append((np.asarray(logits), np.asarray(cache["len"])))
    return out


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_and_decode_match_reference_at_group_8(weights,
                                                       reference_run,
                                                       layout):
    _, cfg, _, tparams = weights
    toks, lens, _, steps = _decode_inputs(cfg)
    tl, tc = prefill(cfg, tparams, torch.from_numpy(toks), max_len=32,
                     true_lengths=torch.from_numpy(lens),
                     cache_dtype=torch.float32)
    if layout == "paged":
        tc = _paged(cfg, tc)
    got = [(tl, tc["len"])]
    for tok in steps:
        tl, tc = decode_step(cfg, tparams, tc, torch.from_numpy(tok))
        got.append((tl, tc["len"]))
    for (tl, tlen), (jl, jlen) in zip(got, reference_run):
        assert tuple(tl.shape) == jl.shape
        _close(tl, jl)
        np.testing.assert_array_equal(tlen.numpy(), jlen)


def test_client_streams_match_reference_at_group_8(weights):
    """Greedy and seeded-sampled streams of the default client, some
    admitted mid-decode, equal the reference client's token for token;
    the pool drains."""
    jcfg, cfg, jparams, tparams = weights
    work = _workload(31, n=5)
    opts = dict(max_slots=4, cap_new=24)
    pipe = dict(policy="dp", max_batch_size=4)
    jclient = JaxClient(JaxContinuousEngine(JaxInferenceEngine(
        jcfg, jparams, ladder=JaxLadder(**LADDER)), **opts),
        cost_model=JaxCostModel(**COST), config=JaxPipelineConfig(**pipe))
    client = TurboClient(ContinuousEngine(InferenceEngine(
        cfg, tparams, ladder=BucketLadder(**LADDER), device="cpu"), **opts),
        cost_model=AnalyticCostModel(**COST), config=PipelineConfig(**pipe))
    _, want = _serve(jclient, JaxParams, work)
    _, got = _serve(client, GenerationParams, work)
    assert got == want
    assert any(g["temperature"] > 0 for _, g in work)
    assert client.backend.pack_dispatches > 0
    assert client.backend.block_table.used_blocks == 0
    assert client.backend.engine.kv_slab.live_bytes == 0
