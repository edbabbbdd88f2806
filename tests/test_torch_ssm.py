"""The port's SSM and hybrid families against the JAX package's, on the CPU.

Falcon-Mamba-7B (attention-free Mamba1) and Zamba2-1.2B (a Mamba2
backbone with one weight-shared attention + FFN block every
``attn_every`` layers), each at its smoke config.  The reference's
`init_params` draws the weights and the bridge carries them over, so both
packages run the identical tree; every input comes from a numpy seed.
Everything is f32 on the CPU.  The two sides differ in the scan's tree
(the port's Hillis–Steele rounds against ``lax.associative_scan``), in
summation order and, in the hybrid's shared block, in the attention
routine, hence 1e-4 relative and absolute, as in
tests/test_torch_models.py.  Streams are compared token for token on the
contiguous layout (the reference refuses the paged one for these
families, and so does the port), with the cell keys, the ``warmup_aot``
rounds and the serving counters.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.api import TurboClient as JaxClient
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_smoke_config
from repro.core import AnalyticCostModel as JaxCostModel
from repro.core.pipeline import PipelineConfig as JaxPipelineConfig
from repro.models import decode_step as jax_decode_step
from repro.models import forward_hidden as jax_forward_hidden
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import prefill as jax_prefill
from repro.models import ssm as JS
from repro.runtime import kv_cache as jax_kv
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.models import (decode_step, forward_hidden, init_params,
                                logits_at, make_paged_cache, prefill,
                                prefill_packed, prefill_suffix)
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import layer_params
from repro_torch.runtime import kv_cache as port_kv
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
from tests.test_torch_prefix import COST

ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")
TOL = dict(rtol=1e-4, atol=1e-4)
LADDER = dict(seq_buckets=(32, 64), batch_buckets=(1, 2, 4))


def _ssd(cfg):
    """``cfg`` with Mamba2's SSD (block-matmul) form."""
    return dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, ssd_matmul=True))


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


def _block(jparams, tparams, i=0):
    """Layer ``i``'s mamba weights on both sides."""
    jblk = jax.tree.map(lambda x: x[i], jparams["layers"]["mamba"])
    return jblk, layer_params(tparams, i)["mamba"]


def _x(cfg, seed, b, s):
    return np.random.default_rng(seed).normal(
        size=(b, s, cfg.d_model)).astype(np.float32)


# ---------------------------------------------------------------------------
# The mamba block
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seq", [45, 7])
def test_apply_mamba_with_state_matches_reference(weights, seq):
    """From zeros and from a given state; 45 spans a second, partial
    chunk of the smoke config's 32."""
    _, jcfg, cfg, jparams, tparams = weights
    jblk, tblk = _block(jparams, tparams, 1)
    x = _x(cfg, 1, 2, seq)
    jy, jconv, jst = JS.apply_mamba_with_state(jcfg, jblk, jnp.asarray(x),
                                               None)
    ty, tconv, tst = S.apply_mamba_with_state(cfg, tblk,
                                              torch.from_numpy(x), None)
    for got, want in ((ty, jy), (tconv, jconv), (tst, jst)):
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)
    # resumed from that state
    x2 = _x(cfg, 2, 2, 5)
    jy, jconv, jst = JS.apply_mamba_with_state(jcfg, jblk, jnp.asarray(x2),
                                               (jconv, jst))
    ty, tconv, tst = S.apply_mamba_with_state(
        cfg, tblk, torch.from_numpy(x2), (tconv, tst))
    for got, want in ((ty, jy), (tconv, jconv), (tst, jst)):
        _close(got, want)
    assert torch.equal(S.apply_mamba(cfg, tblk, torch.from_numpy(x2)),
                       S.apply_mamba_with_state(
                           cfg, tblk, torch.from_numpy(x2), None)[0])


def test_causal_conv_matches_reference(weights):
    """The depthwise causal conv over a whole sequence (from a zero
    window), as the reference's ``_causal_conv``."""
    _, _, cfg, jparams, tparams = weights
    jblk, tblk = _block(jparams, tparams)
    x = np.random.default_rng(8).normal(
        size=(2, 11, cfg.d_inner)).astype(np.float32)
    _close(S._causal_conv(tblk, torch.from_numpy(x)),
           JS._causal_conv(jblk, jnp.asarray(x)))


def test_apply_mamba_step_matches_reference(weights):
    _, jcfg, cfg, jparams, tparams = weights
    jblk, tblk = _block(jparams, tparams)
    conv_s, state_s = S.ssm_state_shapes(cfg, 3)
    assert (conv_s, state_s) == JS.ssm_state_shapes(jcfg, 3)
    rng = np.random.default_rng(3)
    conv = rng.normal(size=conv_s).astype(np.float32)
    state = rng.normal(size=state_s).astype(np.float32)
    jc, js = jnp.asarray(conv), jnp.asarray(state)
    tc, ts = torch.from_numpy(conv), torch.from_numpy(state)
    for step in range(4):
        x = rng.normal(size=(3, cfg.d_model)).astype(np.float32)
        jy, jc, js = JS.apply_mamba_step(jcfg, jblk, jnp.asarray(x), jc, js)
        ty, tc, ts = S.apply_mamba_step(cfg, tblk, torch.from_numpy(x), tc,
                                        ts)
        for got, want in ((ty, jy), (tc, jc), (ts, js)):
            assert tuple(got.shape) == tuple(want.shape)
            _close(got, want)


def test_bf16_step_runs_in_bf16_where_the_reference_promotes(weights):
    """A planned departure: with bf16 weights over an f32 cache, the
    reference's decode step promotes the conv window (f32 state, bf16
    input) and with it the whole mamba step to f32, while its prompt
    pass runs in bf16; the port's step takes the window in the input's
    dtype, as both prompt passes do.  The cast loses nothing: the state
    only ever holds earlier bf16 inputs."""
    _, jcfg, cfg, jparams, tparams = weights
    jblk, tblk = _block(jparams, tparams)
    rng = np.random.default_rng(9)
    conv_s, _ = S.ssm_state_shapes(cfg, 2)
    state = rng.normal(size=conv_s).astype(np.float32)
    state = np.asarray(jnp.asarray(state, jnp.bfloat16), np.float32)
    x = rng.normal(size=(2, cfg.d_inner)).astype(np.float32)
    jb = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), jblk)
    tb = {k: v.to(torch.bfloat16) for k, v in tblk.items()}
    jnew, jout = JS._conv_step(jb, jnp.asarray(state),
                               jnp.asarray(x, jnp.bfloat16))
    tnew, tout = S._conv_step(tb, torch.from_numpy(state),
                              torch.from_numpy(x).to(torch.bfloat16))
    assert jout.dtype == jnp.float32 and tout.dtype == torch.bfloat16
    assert torch.equal(tnew.float(), torch.from_numpy(np.array(
        jnew, np.float32)))
    _close(tout.float(), jout, rtol=2 ** -7, atol=2 ** -7)


def test_prompt_state_equals_one_token_at_a_time(weights):
    """A prompt pass's output and last state against the same prompt fed
    one token at a time through the step, from zeros."""
    _, _, cfg, _, tparams = weights
    tblk = layer_params(tparams, 0)["mamba"]
    x = torch.from_numpy(_x(cfg, 5, 2, 40))
    y, conv, state = S.apply_mamba_with_state(cfg, tblk, x, None)
    conv_s, state_s = S.ssm_state_shapes(cfg, 2)
    c, st = torch.zeros(conv_s), torch.zeros(state_s)
    ys = []
    for t in range(x.shape[1]):
        yt, c, st = S.apply_mamba_step(cfg, tblk, x[:, t], c, st)
        ys.append(yt)
    _close(torch.stack(ys, dim=1), y)
    _close(c, conv)
    _close(st, state)


@pytest.mark.parametrize("seq", [64, 45, 1])
def test_mamba2_scan_and_ssd_forms_agree(seq):
    """Mamba2's scan and SSD forms against each other and against the
    reference's two forms, at a whole number of chunks, a partial last
    chunk and one token."""
    arch = "zamba2-1.2b"
    jcfg, cfg = jax_smoke_config(arch), get_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(1))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    jblk, tblk = _block(jparams, tparams)
    x = _x(cfg, 7, 2, seq)
    outs = {}
    for form, jc, tc in (("scan", jcfg, cfg), ("ssd", _ssd(jcfg), _ssd(cfg))):
        outs[form] = S.apply_mamba_with_state(tc, tblk, torch.from_numpy(x),
                                              None)
        want = JS.apply_mamba_with_state(jc, jblk, jnp.asarray(x), None)
        for got, w in zip(outs[form], want):
            _close(got, w)
    for a, b in zip(outs["scan"], outs["ssd"]):
        _close(a, b)


def test_linear_scan_is_the_recurrence():
    """The log-depth scan against the recurrence run step by step, with
    ``a`` broadcast over ``b``'s trailing dims as Mamba2 runs it."""
    rng = np.random.default_rng(0)
    for c in (1, 2, 5, 32, 33):
        a = torch.from_numpy(rng.uniform(0.5, 1.0, (2, c, 3, 1))
                             .astype(np.float32))
        b = torch.from_numpy(rng.normal(size=(2, c, 3, 4))
                             .astype(np.float32))
        h = torch.zeros((2, 3, 4))
        want = []
        for t in range(c):
            h = a[:, t] * h + b[:, t]
            want.append(h)
        _close(S._linear_scan(a, b), torch.stack(want, dim=1), rtol=1e-6,
               atol=1e-6)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


def test_init_params_tree_matches_reference(weights):
    """The port's own draw has the reference's tree: keys, shapes and
    dtypes (``A_log``, ``D`` and ``dt_bias`` in f32), the hybrid's
    ``shared`` block among them."""
    _, jcfg, cfg, jparams, _ = weights
    tp = init_params(cfg, device="cpu")
    want = jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jparams)
    got = jax.tree.map(lambda t: (tuple(t.shape),
                                  str(t.dtype).replace("torch.", "")), tp)
    assert got == want
    assert ("shared" in tp) == (cfg.family == "hybrid")
    for name in ("A_log", "D", "dt_bias"):
        assert tp["layers"]["mamba"][name].dtype == torch.float32
    bf16 = init_params(cfg, device="cpu", param_dtype="bfloat16")
    assert bf16["layers"]["mamba"]["in_proj"].dtype == torch.bfloat16
    assert bf16["layers"]["mamba"]["A_log"].dtype == torch.float32


@pytest.mark.parametrize("arch,first", [("falcon-mamba-7b", "in_proj"),
                                        ("internlm2-1.8b", "wq")])
def test_only_the_hybrid_draws_a_shared_seed(arch, first):
    """The hybrid's shared block takes a generator of its own, seeded
    from one draw; no other family makes that draw, so their weights
    from a seed are what they were: the embedding tables first, then
    layer 0's first matrix, straight from the generator."""
    import math
    cfg = get_smoke_config(arch)
    params = init_params(cfg, device="cpu", seed=3)
    gen = torch.Generator().manual_seed(3)
    d = cfg.d_model
    tok = torch.randn((1, cfg.vocab_size, d), generator=gen) / math.sqrt(d)
    assert torch.equal(params["embed"]["tok"], tok)
    if not cfg.tie_embeddings:
        head = torch.randn((1, d, cfg.vocab_size), generator=gen) / \
            math.sqrt(d)
        assert torch.equal(params["embed"]["head"], head)
    layer0 = layer_params(params, 0)
    w = layer0["mamba"][first] if cfg.family == "ssm" \
        else layer0["attn"][first]
    assert torch.equal(w, torch.randn(tuple(w.shape), generator=gen) /
                       math.sqrt(d))


@pytest.mark.parametrize("arch", ARCHS)
def test_counts_match_reference(arch):
    """``param_count`` (the hybrid's shared block once),
    ``kv_bytes_per_token`` and ``ssm_state_bytes``, full and smoke."""
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
        assert port.d_inner == ref.d_inner
        assert port.is_attention_free == ref.is_attention_free
        for fn in ("kv_bytes_per_token", "ssm_state_bytes"):
            assert getattr(port_kv, fn)(port) == getattr(jax_kv, fn)(ref)
    if arch == "falcon-mamba-7b":
        assert 6.5e9 < get_config(arch).param_count() < 7.5e9


def test_forward_hidden_logits_match_reference(weights):
    _, jcfg, cfg, jparams, tparams = weights
    toks = np.random.default_rng(2).integers(1, 256, (2, 37)).astype(
        np.int32)
    jh, _, _ = jax_forward_hidden(jcfg, jparams, jnp.asarray(toks))
    want = JL.lm_logits(jcfg, jparams["embed"], jh)
    for attn in ("flash", "naive"):
        h, parts = forward_hidden(cfg, tparams, torch.from_numpy(toks),
                                  attn=attn)
        assert parts is None
        _close(L.lm_logits(cfg, tparams["embed"], h), want)


@pytest.mark.parametrize("ssd", [False, True], ids=["scan", "ssd"])
def test_prefill_and_decode_match_reference(weights, ssd):
    """Prefill into a contiguous cache wider than the prompt, then 8
    decode steps: logits and every cache leaf (conv window, scan state,
    the shared block's KV) within 1e-4 at every step."""
    _, jcfg, cfg, jparams, tparams = weights
    if ssd:
        jcfg, cfg = _ssd(jcfg), _ssd(cfg)
    toks = np.random.default_rng(4).integers(1, 256, (3, 41)).astype(
        np.int32)
    jl, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks), max_len=64,
                             cache_dtype=jnp.float32)
    tl, tcache = prefill(cfg, tparams, torch.from_numpy(toks), max_len=64,
                         cache_dtype=torch.float32)
    assert set(tcache) == set(jcache)
    want_keys = {"len", "pos_offset", "conv", "state"}
    if cfg.attn_every:
        want_keys |= {"shared_k", "shared_v"}
    assert set(tcache) == want_keys

    def same(tl, tcache, jl, jcache):
        _close(tl, jl)
        for k in jcache:
            assert tuple(tcache[k].shape) == tuple(jcache[k].shape), k
            assert str(tcache[k].dtype).replace("torch.", "") == \
                str(jcache[k].dtype), k
            _close(tcache[k], jcache[k])

    same(tl, tcache, jl, jcache)
    conv, state = tcache["conv"], tcache["state"]
    cur = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
    for _ in range(8):
        jl, jcache = jax_decode_step(jcfg, jparams, jcache, jnp.asarray(cur))
        tl, tcache = decode_step(cfg, tparams, tcache,
                                 torch.from_numpy(cur.copy()))
        same(tl, tcache, jl, jcache)
        # the step writes the state in place
        assert tcache["conv"] is conv and tcache["state"] is state
        cur = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)


def test_refusals_raise_where_the_reference_does(weights):
    """Ragged prefill (``true_lengths``), suffix and packed prefill and the
    paged cache raise for these families in both packages."""
    _, jcfg, cfg, jparams, tparams = weights
    toks = np.ones((2, 8), np.int32)
    lens = np.array([8, 5], np.int32)
    with pytest.raises(ValueError, match="ragged prefill unsupported"):
        jax_prefill(jcfg, jparams, jnp.asarray(toks), max_len=16,
                    true_lengths=jnp.asarray(lens))
    with pytest.raises(ValueError, match="ragged prefill unsupported"):
        prefill(cfg, tparams, torch.from_numpy(toks), max_len=16,
                true_lengths=torch.from_numpy(lens))
    empty = torch.zeros((cfg.num_layers, 2, 0, 1, 1))
    with pytest.raises(ValueError, match="SSM state cannot restart"):
        prefill_suffix(cfg, tparams, torch.from_numpy(toks), empty, empty,
                       prefix_len=0)
    ids = torch.zeros((8,), dtype=torch.int32)
    with pytest.raises(ValueError, match="SSM state rolls through"):
        prefill_packed(cfg, tparams, torch.from_numpy(toks[:1]), ids, ids,
                       ids[:1], empty[:, 0], empty[:, 0], ids[:0], ids[:0])
    with pytest.raises(ValueError, match="paged KV applies"):
        make_paged_cache(cfg, 2, 9, 8, 4, device="cpu")


# ---------------------------------------------------------------------------
# The engines and the client
# ---------------------------------------------------------------------------


def _engine(cfg, tparams, **ladder):
    return InferenceEngine(cfg, tparams,
                           ladder=BucketLadder(**(ladder or LADDER)),
                           device="cpu")


def _jax_engine(jcfg, jparams, **ladder):
    return JaxInferenceEngine(jcfg, jparams,
                              ladder=JaxLadder(**(ladder or LADDER)))


#: prompt lengths of the served mix: few distinct ones, since every
#: exact length is a prefill cell (a compile on the reference's side)
MIX_LENS = (6, 6, 20, 6, 20, 33, 20, 33)


def _mix(seed):
    """The serve mix: 8 requests of ``MIX_LENS`` tokens, every third
    sampled; the first 3 arrive together, the rest mid-decode."""
    rng = np.random.default_rng(seed)
    out = []
    for i, plen in enumerate(MIX_LENS):
        sampled = i % 3 == 1
        out.append(([int(t) for t in rng.integers(1, 256, plen)], dict(
            max_new_tokens=int(rng.integers(3, 12)),
            temperature=0.9 if sampled else 0.0,
            top_k=20 if sampled else 0, top_p=0.9 if sampled else 1.0,
            seed=300 + i)))
    return out


def _serve(client, make_params, work, first=3, ticks=3):
    handles = [client.submit(p, make_params(**g)) for p, g in work[:first]]
    client.pump(max_ticks=ticks)
    handles += [client.submit(p, make_params(**g)) for p, g in work[first:]]
    return handles, [h.result() for h in handles]


def _clients(weights, monkeypatch, warmup, max_len=None):
    """Both packages' ``TurboClient.from_arch(arch, kv_layout=
    "contiguous", ...)`` with the same options; the port's draws no
    weights of its own but gets the reference's from ``init_seed`` 0,
    bridged (the fixture's)."""
    arch, _, _, _, tparams = weights
    import repro_torch.models
    monkeypatch.setattr(repro_torch.models, "init_params",
                        lambda cfg, seed=0, device=None: tparams)
    kw = dict(max_slots=4, cap_new=16, kv_layout="contiguous",
              max_len=max_len, init_seed=0, warmup=warmup, **LADDER)
    pipe = dict(policy="dp", max_batch_size=4)
    jclient = JaxClient.from_arch(arch, cost_model=JaxCostModel(**COST),
                                  config=JaxPipelineConfig(**pipe), **kw)
    client = TurboClient.from_arch(arch, device="cpu",
                                   cost_model=AnalyticCostModel(**COST),
                                   config=PipelineConfig(**pipe), **kw)
    return jclient, client


def test_client_streams_match_reference(weights, monkeypatch):
    """The contiguous layout from a slot cache of 32 positions, grown to
    64 mid-decode: greedy and seeded-sampled streams, the pipeline's
    stats and batch log, the engine's counters and its prefill cells'
    keys equal the reference's; the sanitizer's invariants hold and
    nothing leaks."""
    jclient, client = _clients(weights, monkeypatch, warmup=False,
                               max_len=32)
    work = _mix(11)
    _, want = _serve(jclient, JaxParams, work)
    handles, got = _serve(client, GenerationParams, work)
    assert got == want
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    ce, jce = client.backend, jclient.backend
    assert ce.max_len == jce.max_len == 64
    pipe, jpipe = client.pipeline, jclient.pipeline
    assert pipe.stats.__dict__ == jpipe.stats.__dict__
    assert pipe.batch_log == jpipe.batch_log
    for k in ("prefill_tokens", "prefill_dispatches", "decode_ticks"):
        assert getattr(ce, k) == getattr(jce, k), k
    assert set(ce.engine.prefill_cells.keys()) == \
        set(jce.engine._prefill_cache)
    ce.check_invariants(client.pipeline)
    assert ce.engine.kv_slab.live_bytes == 0


def test_warmup_walk_cells_and_counters_match_reference(weights,
                                                        monkeypatch):
    """``warmup_aot`` walks the reference's rounds and records its cell
    keys (exact prompt lengths), leaves the counters as it found them,
    and the mix served after it equals the reference's."""
    jclient, client = _clients(weights, monkeypatch, warmup=True)
    ce, jce = client.backend, jclient.backend
    assert client.warmup_stats["rounds"] == jclient.warmup_stats["rounds"]
    assert client.warmup_stats["compile_count"] == 0
    assert set(ce.engine.prefill_cells.keys()) == \
        set(jce.engine._prefill_cache)
    assert ce.prefill_tokens == ce.decode_ticks == 0
    assert not ce.state.sampling
    work = _mix(12)
    _, want = _serve(jclient, JaxParams, work)
    _, got = _serve(client, GenerationParams, work)
    assert got == want
    for k in ("prefill_tokens", "decode_ticks"):
        assert getattr(ce, k) == getattr(jce, k), k
    assert set(ce.engine.prefill_cells.keys()) == \
        set(jce.engine._prefill_cache)
    assert ce.engine.compile_count == 0


def test_paged_layout_is_refused_as_the_reference_refuses_it(weights):
    _, jcfg, cfg, jparams, tparams = weights
    msg = "use kv_layout='contiguous' for SSM/hybrid"
    with pytest.raises(ValueError, match=msg):
        JaxContinuousEngine(_jax_engine(jcfg, jparams), max_slots=2)
    with pytest.raises(ValueError, match=msg):
        ContinuousEngine(_engine(cfg, tparams), max_slots=2)
    with pytest.raises(ValueError, match=msg):
        TurboClient.from_arch(weights[0], device="cpu", warmup=False)
    client = TurboClient.from_arch(weights[0], device="cpu", warmup=False,
                                   kv_layout="contiguous", max_slots=2)
    out = client.submit([5, 6, 7], GenerationParams(max_new_tokens=3))
    assert len(out.result()) == 6


@pytest.mark.parametrize("per_token_host_sync", [False, True],
                         ids=["device", "host_sync"])
def test_generate_matches_reference(weights, per_token_host_sync):
    """`generate` of prompts of one length (its contiguous state decoded
    in place) equals the reference's, and both raise on ragged ones."""
    _, jcfg, cfg, jparams, tparams = weights
    prompts = [[3, 9, 27, 81, 4], [7, 1, 8, 2, 8]]
    eng, jeng = _engine(cfg, tparams), _jax_engine(jcfg, jparams)
    kw = dict(max_new_tokens=10, per_token_host_sync=per_token_host_sync)
    assert eng.generate(prompts, **kw) == jeng.generate(prompts, **kw)
    assert eng.kv_slab.live_bytes == 0
    for e in (eng, jeng):
        with pytest.raises(ValueError, match="grouped by exact length"):
            e.generate([[1, 2, 3], [4, 5]], max_new_tokens=4)


def test_classify_matches_reference(weights):
    """Right padding after each row's last token does not reach it."""
    _, jcfg, cfg, jparams, tparams = weights
    rows = [[5, 6, 7], list(range(1, 30)), [9] * 12]
    got = _engine(cfg, tparams).classify_logits(rows)
    assert _engine(cfg, tparams).classify(rows) == \
        _jax_engine(jcfg, jparams).classify(rows)
    jh, _, _ = jax_forward_hidden(jcfg, jparams, jnp.asarray(
        [r + [0] * (32 - len(r)) for r in rows], jnp.int32))
    last = jnp.asarray([len(r) - 1 for r in rows])
    want = JL.lm_logits(jcfg, jparams["embed"],
                        jh[jnp.arange(3), last][:, None])[:, 0]
    _close(got, want)


def test_inplace_tick_equals_decode_step_batch(weights):
    """The in-place tick (the form a CUDA graph captures) gives the
    eager tick's tokens, and the same conv, scan state and shared KV bit
    for bit, over several ticks."""
    _, _, cfg, _, tparams = weights
    eng = _engine(cfg, tparams)
    prompts = [[4, 8, 15, 16, 23, 42]] * 2
    a = eng.prefill_batch(prompts, max_len=32, max_new_tokens=8)
    b = eng.prefill_batch(prompts, max_len=32, max_new_tokens=8)
    held = {k: t for k, t in a.cache.items()}
    for _ in range(6):
        eng.decode_step_inplace(a)
        b = eng.decode_step_batch(b)
        for k in held:
            assert a.cache[k] is held[k]
            assert torch.equal(a.cache[k], b.cache[k]), k
        assert torch.equal(a.emitted, b.emitted)


def test_tick_cell_key_and_warm_copy_cover_the_state(weights):
    """The tick cell's key names every state leaf of the cache (so a
    graph never replays against other state tensors), and the eager
    tick that warms a capture runs on its own copy of the conv window
    and scan state, which the step writes on every row, done or not,
    while the KV it writes only at a row's frozen length stays shared."""
    from repro_torch.runtime import graphs
    _, _, cfg, _, tparams = weights
    eng = _engine(cfg, tparams)
    state = eng.prefill_batch([[1, 2, 3]] * 2, max_len=32, max_new_tokens=4)
    names = {entry[0] for entry in graphs.signature(state)}
    assert set(state.cache) <= names
    assert graphs.decode_heads(state.cache) == cfg.num_kv_heads
    warm = graphs.warm_copy(state)
    for name, t in state.cache.items():
        shared = name not in graphs.STEP_STATE + ("len",)
        assert (warm.cache[name] is t) == shared, name
        assert torch.equal(warm.cache[name], t)
    assert bool(warm.done.all())


def test_logits_at_reads_each_rows_last_token(weights):
    _, _, cfg, _, tparams = weights
    h = torch.randn(2, 5, cfg.d_model)
    got = logits_at(cfg, tparams, h, torch.tensor([4, 1]))
    rows = h[[0, 1], [4, 1]][:, None]
    want = L.lm_logits(cfg, tparams["embed"], rows)[:, 0]
    _close(got, want)


# ---------------------------------------------------------------------------
# The reference's hybrid regressions (tests/test_paged_kv.py), on the port
# ---------------------------------------------------------------------------

#: the reference test's cost model
CM = dict(flops_per_token=1e6, bytes_per_token=1e3, weight_bytes=1e6,
          overhead=1e-4)


def _zamba_client(max_batch_size=32):
    """The reference test's stack (its ``ServingSystem`` over a backend
    is the port's client over one): Zamba2's smoke config, two slots,
    the contiguous layout."""
    cfg = get_smoke_config("zamba2-1.2b")
    eng = InferenceEngine(cfg, init_params(cfg, device="cpu"),
                          ladder=BucketLadder(seq_buckets=(32, 64),
                                              batch_buckets=(1, 2)),
                          device="cpu")
    ce = ContinuousEngine(eng, max_slots=2, cap_new=16,
                          kv_layout="contiguous")
    client = TurboClient(ce, cost_model=AnalyticCostModel(**CM),
                         config=PipelineConfig(
                             policy="dp", max_batch_size=max_batch_size))
    return eng, ce, client


def test_contiguous_grow_keeps_shared_kv_leaves():
    """Growing the contiguous slot cache past its first max_len pads the
    hybrid's shared_k/shared_v leaves too, so the shared block's writes
    do not clamp at the old boundary."""
    eng, ce, client = _zamba_client()
    client.submit([1, 2, 3, 4], GenerationParams(max_new_tokens=4)).result()
    assert ce.max_len == 32           # slot cache fixed at bucket 32
    prompt = list(range(2, 32))       # total 30 + 8 = 38 > 32: grow
    b = client.submit(prompt, GenerationParams(max_new_tokens=8))
    result = b.result()
    assert ce.max_len == 64
    assert ce.state.cache["shared_k"].shape[2] == 64
    assert ce.state.cache["shared_v"].shape[2] == 64
    assert result == eng.generate([prompt], max_new_tokens=8)[0]


def test_hybrid_mixed_length_admission_splits_groups():
    """A prefill batch mixing prompt lengths splits into equal-length
    sub-batches (ragged SSM prefill is unsupported)."""
    eng, ce, client = _zamba_client(max_batch_size=2)
    a = client.submit([1, 2, 3], GenerationParams(max_new_tokens=5))
    b = client.submit([4, 5, 6, 7, 8], GenerationParams(max_new_tokens=5))
    ra, rb = a.result(), b.result()
    assert ce.prefill_dispatches == 2
    assert len(client.pipeline.batch_log[0]) == 2     # one admission of two
    assert ra == eng.generate([[1, 2, 3]], max_new_tokens=5)[0]
    assert rb == eng.generate([[4, 5, 6, 7, 8]], max_new_tokens=5)[0]
