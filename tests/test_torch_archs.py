"""The port's five newer transformer configs against the JAX package's.

Qwen2-VL-7B (M-RoPE, an image prefix of precomputed patch embeddings),
StarCoder2-15B (LayerNorm + GELU), MusicGen-large (four codebooks,
LayerNorm + GELU), Qwen3-32B (qk-norm) and Llama3-405B, each at its
smoke config.  The reference's `init_params` draws the weights and the
bridge carries them over, so both packages run the identical tree; every
input comes from a numpy seed.  Everything is f32 on the CPU, and the
two sides differ in summation order and in the attention routine (the
reference's jnp attention, the port's kernels' plain versions), hence
1e-4 relative and absolute on logits through two layers, as in
tests/test_torch_models.py.  Streams are compared token for token:
the client's (greedy and seeded-sampled, packed admission over the
paged pool) and `InferenceEngine.generate`'s on MusicGen, with and
without the per-token host sync.
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
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.models import prefill_packed as jax_prefill_packed
from repro.models import prefill_suffix as jax_prefill_suffix
from repro.models import transformer as JT
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_smoke_config
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.models import (decode_step, forward_hidden, init_params,
                                make_paged_cache, prefill, prefill_packed,
                                prefill_suffix)
from repro_torch.models import layers as L
from repro_torch.models.bridge import params_from_numpy
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
from tests.test_torch_packed import _workload
from tests.test_torch_prefix import COST, _serve

ARCHS = ("qwen2-vl-7b", "starcoder2-15b", "musicgen-large", "qwen3-32b",
         "llama3-405b")
TOKEN_ARCHS = tuple(a for a in ARCHS if a != "musicgen-large")
TOL = dict(rtol=1e-4, atol=1e-4)
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(1, 2, 4))
N_IMG = 9                       # a 3 x 3 patch grid before the text


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return arch, jcfg, get_smoke_config(arch), jparams, tparams


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _tokens(cfg, rng, b, s):
    """(B, S) tokens, or (B, K, S) codes for a codebook model."""
    shape = (b, cfg.num_codebooks, s) if cfg.num_codebooks else (b, s)
    return rng.integers(1, cfg.vocab_size, shape).astype(np.int32)


def _patches(cfg, rng, b):
    if cfg.frontend != "vision":
        return None
    return (0.02 * rng.standard_normal((b, N_IMG, cfg.d_model))).astype(
        np.float32)


def _opt(a):
    return None if a is None else torch.from_numpy(a)


def _jopt(a):
    return None if a is None else jnp.asarray(a)


def test_port_init_params_matches_reference_tree(weights):
    """The port's own init draws the reference's tree: K embedding and
    head tables for MusicGen, the GELU FFN's biases for StarCoder2 and
    MusicGen, qk-norm scales for Qwen3."""
    _, _, cfg, _, tparams = weights

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), tree.dtype)
    own = init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    assert shapes(own) == shapes(tparams)
    k = max(cfg.num_codebooks, 1)
    assert tuple(own["embed"]["tok"].shape) == (k, cfg.vocab_size,
                                                cfg.d_model)
    assert tuple(own["embed"]["head"].shape) == (k, cfg.d_model,
                                                 cfg.vocab_size)


def test_forward_hidden_logits_match_reference(weights):
    """A causal pass (with the image prefix for the VLM, codes for
    MusicGen) and the head: logits (B, S, V), or (B, K, S, V)."""
    _, jcfg, cfg, jparams, tparams = weights
    rng = np.random.default_rng(1)
    toks = _tokens(cfg, rng, 2, 24)
    emb = _patches(cfg, rng, 2)
    n = 0 if emb is None else N_IMG
    jh, _, _ = JT.forward_hidden(jcfg, jparams, jnp.asarray(toks),
                                 embeds_override=_jopt(emb),
                                 num_prefix_patches=n)
    want = JL.lm_logits(jcfg, jparams["embed"], jh)
    h, _ = forward_hidden(cfg, tparams, torch.from_numpy(toks),
                          embeds_override=_opt(emb), num_prefix_patches=n)
    got = L.lm_logits(cfg, tparams["embed"], h)
    assert got.shape == want.shape
    _close(got, want)


def _paged(cfg, cache, block_size=8):
    """The contiguous prefill cache moved into a private paged pool (row
    b owns blocks 1 + b * MB ..), as `InferenceEngine.own_pool` does."""
    nl, b, s = cache["k"].shape[:3]
    mb = -(-s // block_size)
    pc = make_paged_cache(cfg, b, 1 + b * mb, block_size, mb,
                          cache["k"].dtype, device="cpu")
    pc["block_tables"] = (1 + torch.arange(b)[:, None] * mb +
                          torch.arange(mb)[None]).to(torch.int32)
    for key in ("k", "v"):
        pool = pc[key].view(nl, -1, *pc[key].shape[3:])
        for r in range(b):
            at = block_size * (1 + r * mb)
            pool[:, at:at + s] = cache[key][:, r]
    pc["len"], pc["pos_offset"] = cache["len"], cache["pos_offset"]
    return pc


#: the reference's prefill and decode steps, once an arch (both layouts
#: are held to them)
_REFERENCE_RUNS = {}


def _decode_inputs(cfg):
    rng = np.random.default_rng(2)
    toks = _tokens(cfg, rng, 2, 20)
    emb = _patches(cfg, rng, 2)
    shape = (2, cfg.num_codebooks) if cfg.num_codebooks else (2,)
    steps = [rng.integers(1, cfg.vocab_size, shape).astype(np.int32)
             for _ in range(4)]
    return toks, np.array([20, 13], np.int32), emb, steps


def _reference_run(arch, jcfg, cfg, jparams):
    if arch not in _REFERENCE_RUNS:
        toks, lens, emb, steps = _decode_inputs(cfg)
        logits, cache = jax_prefill(jcfg, jparams, jnp.asarray(toks),
                                    max_len=32, embeds_override=_jopt(emb),
                                    true_lengths=jnp.asarray(lens),
                                    cache_dtype=jnp.float32)
        out = [(np.asarray(logits), np.asarray(cache["pos_offset"]),
                np.asarray(cache["len"]))]
        for tok in steps:
            logits, cache = jax_decode_step(jcfg, jparams, cache,
                                            jnp.asarray(tok))
            out.append((np.asarray(logits), np.asarray(cache["pos_offset"]),
                        np.asarray(cache["len"])))
        _REFERENCE_RUNS[arch] = out
    return _REFERENCE_RUNS[arch]


@pytest.mark.parametrize("layout", ["contiguous", "paged"])
def test_prefill_and_decode_match_reference(weights, layout):
    """A ragged prefill (the VLM's with its image prefix, so its text
    decodes from ``len + pos_offset``, pos_offset = -(N - 1)) and four
    decode steps on numpy tokens (codes for MusicGen): logits within
    1e-4, lengths and offsets equal."""
    arch, jcfg, cfg, jparams, tparams = weights
    want = _reference_run(arch, jcfg, cfg, jparams)
    toks, lens, emb, steps = _decode_inputs(cfg)
    tl, tc = prefill(cfg, tparams, torch.from_numpy(toks), max_len=32,
                     embeds_override=_opt(emb),
                     true_lengths=torch.from_numpy(lens),
                     cache_dtype=torch.float32)
    assert (tc["pos_offset"] != 0).any().item() == (emb is not None)
    if layout == "paged":
        tc = _paged(cfg, tc)
    got = [(tl, tc["pos_offset"], tc["len"])]
    for tok in steps:
        tl, tc = decode_step(cfg, tparams, tc, torch.from_numpy(tok))
        got.append((tl, tc["pos_offset"], tc["len"]))
    for (tl, toff, tlen), (jl, joff, jlen) in zip(got, want):
        assert tuple(tl.shape) == jl.shape
        _close(tl, jl)
        np.testing.assert_array_equal(toff.numpy(), joff)
        np.testing.assert_array_equal(tlen.numpy(), jlen)


def test_vlm_prefill_packed_matches_reference():
    """A packed prefill of the VLM broadcasts its flat positions to
    M-RoPE's three streams, after cached prefix keys."""
    arch = "qwen2-vl-7b"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(3)
    seg = np.array([0] * 5 + [1] * 7 + [-1] * 4, np.int32)
    pos = np.array(list(range(3, 8)) + list(range(7)) + [0] * 4, np.int32)
    toks = rng.integers(1, cfg.vocab_size, (1, 16)).astype(np.int32)
    pk = rng.standard_normal((cfg.num_layers, 3, cfg.num_kv_heads,
                              cfg.head_dim)).astype(np.float32)
    pv = rng.standard_normal(pk.shape).astype(np.float32)
    pseg = np.zeros(3, np.int32)
    ppos = np.arange(3, dtype=np.int32)
    last = np.array([4, 11], np.int32)
    args = (toks, seg, pos, last, pk, pv, pseg, ppos)
    jl, jkv = jax_prefill_packed(jcfg, jparams,
                                 *[jnp.asarray(a) for a in args],
                                 cache_dtype=jnp.float32)
    tl, tkv = prefill_packed(cfg, tparams,
                             *[torch.from_numpy(a) for a in args],
                             cache_dtype=torch.float32)
    _close(tl, jl)
    _close(tkv["k"][:, :12], jkv["k"][:, :12])


def test_codebook_refusals_raise_where_the_reference_does():
    """MusicGen takes no suffix or packed prefill, no ContinuousEngine
    and no sampled rows, in both packages."""
    arch = "musicgen-large"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    toks = np.ones((1, 4), np.int32)
    pre = np.zeros((cfg.num_layers, 1, 0, cfg.num_kv_heads, cfg.head_dim),
                   np.float32)
    with pytest.raises(ValueError, match="suffix prefill does not support "
                                         "codebook models"):
        jax_prefill_suffix(jcfg, jparams, jnp.asarray(toks),
                           jnp.asarray(pre), jnp.asarray(pre), prefix_len=0)
    with pytest.raises(ValueError, match="suffix prefill does not support "
                                         "codebook models"):
        prefill_suffix(cfg, tparams, torch.from_numpy(toks),
                       torch.from_numpy(pre), torch.from_numpy(pre),
                       prefix_len=0)
    seg = np.zeros(4, np.int32)
    flat = np.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim),
                    np.float32)
    packed = (toks, seg, np.arange(4, dtype=np.int32),
              np.array([3], np.int32), flat, flat, np.zeros(0, np.int32),
              np.zeros(0, np.int32))
    with pytest.raises(ValueError, match="packed prefill does not support "
                                         "codebook models"):
        jax_prefill_packed(jcfg, jparams, *[jnp.asarray(a) for a in packed])
    with pytest.raises(ValueError, match="packed prefill does not support "
                                         "codebook models"):
        prefill_packed(cfg, tparams, *[torch.from_numpy(a) for a in packed])
    jeng = JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER))
    teng = InferenceEngine(cfg, tparams, ladder=BucketLadder(**LADDER),
                           device="cpu")
    for ce, eng in ((JaxContinuousEngine, jeng), (ContinuousEngine, teng)):
        with pytest.raises(ValueError, match="single-codebook"):
            ce(eng, max_slots=2)
    for eng, gp in ((jeng, JaxParams), (teng, GenerationParams)):
        with pytest.raises(ValueError, match="codebook models"):
            eng.prefill_batch([[1, 2, 3]], max_len=32, max_new_tokens=4,
                              sampling=[gp(max_new_tokens=4,
                                           temperature=0.9, seed=1)])


@pytest.mark.parametrize("per_token_host_sync", [False, True],
                         ids=["device_loop", "host_synced"])
def test_musicgen_generate_matches_reference(per_token_host_sync):
    """`InferenceEngine.generate` on the four-codebook model: a ragged
    batch of flat prompts, each frame decoded from all K greedy codes,
    the first codebook emitted, as the reference's does."""
    arch = "musicgen-large"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    rng = np.random.default_rng(4)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in (5, 17, 11)]
    jeng = JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(**LADDER))
    teng = InferenceEngine(cfg, tparams, ladder=BucketLadder(**LADDER),
                           device="cpu")
    want = jeng.generate(prompts, max_new_tokens=9,
                         per_token_host_sync=per_token_host_sync)
    got = teng.generate(prompts, max_new_tokens=9,
                        per_token_host_sync=per_token_host_sync)
    assert got == want
    assert teng.kv_slab.live_bytes == 0


@pytest.mark.parametrize("arch", TOKEN_ARCHS)
def test_client_streams_match_reference(arch):
    """Greedy and seeded-sampled streams of the default client (packed
    admission over the paged pool; M-RoPE's three equal streams for the
    VLM's text) equal the reference client's token for token."""
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    work = _workload(21, n=5)
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
