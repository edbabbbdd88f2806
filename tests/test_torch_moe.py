"""The port's MoE family (`repro_torch.models.moe`, qk-norm) against the
JAX package's, on the CPU.

The reference's `init_params` draws the weights of the `olmoe-1b-7b` and
`phi3.5-moe-42b-a6.6b` smoke configs (4 experts, top 2, capacity factor
2.0; OLMoE with qk-norm, Phi-3.5-MoE with LayerNorm and GQA); the bridge
carries them over, so both packages run the identical tree.  Everything
is f32 on the CPU, and inputs come from numpy seeds.  Tolerances: 1e-5
on one routing, dispatch or MoE call (f32 products of width 64 to 128,
summed in another order), 1e-4 on logits and K/V through the model (two
layers), as in tests/test_torch_models.py.  Expert choices, ranks, slots
and keep flags are integers and are compared exactly, a tied router row
and a capacity overflow among them (the overflow made with
``dataclasses.replace`` on both configs).  Client streams are compared
token for token, greedy and seeded-sampled, on the packed default, per
group, and with the prefix cache and chunked prefill, with the engine
and pipeline counters equal to the reference's.
"""
import ast
import dataclasses
from pathlib import Path

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
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import make_paged_cache as jax_make_paged_cache
from repro.models import moe as JM
from repro.models import prefill as jax_prefill
from repro.models import prefill_packed as jax_prefill_packed
from repro.models import prefill_suffix as jax_prefill_suffix
from repro.runtime.bucketing import BucketLadder as JaxLadder
from repro.runtime.engine import ContinuousEngine as JaxContinuousEngine
from repro.runtime.engine import InferenceEngine as JaxInferenceEngine
from repro.runtime.session import GenerationParams as JaxParams
from repro_torch.api import GenerationParams, TurboClient
from repro_torch.configs import get_config, get_smoke_config
from repro_torch.core import AnalyticCostModel, PipelineConfig
from repro_torch.models import (decode_step, init_params, make_paged_cache,
                                prefill, prefill_packed, prefill_suffix)
from repro_torch.models import layers as L
from repro_torch.models import moe as M
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import layer_params
from repro_torch.runtime.bucketing import BucketLadder
from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
from tests.test_torch_packed import _workload
from tests.test_torch_prefix import COST, _serve, assert_drained, counters
from tests.test_torch_prefix import _workload as _prefix_workload

ARCHS = ("olmoe-1b-7b", "phi3.5-moe-42b-a6.6b")
OLMOE = "olmoe-1b-7b"
PHI = "phi3.5-moe-42b-a6.6b"
CALL_TOL = dict(rtol=1e-5, atol=1e-5)
MODEL_TOL = dict(rtol=1e-4, atol=1e-4)
PORT = Path(__file__).resolve().parents[1] / "src" / "repro_torch"


def _bridge(jcfg, seed=0, param_dtype=None):
    jparams = jax_init_params(jcfg, jax.random.key(seed), param_dtype)
    return jparams, params_from_numpy(jax.tree.map(np.asarray, jparams),
                                      device="cpu")


def _smoke_weights(arch):
    jcfg = jax_smoke_config(arch)
    jparams, tparams = _bridge(jcfg)
    return jcfg, get_smoke_config(arch), jparams, tparams


@pytest.fixture(scope="module", params=ARCHS)
def weights(request):
    return _smoke_weights(request.param)


@pytest.fixture(scope="module")
def olmoe():
    return _smoke_weights(OLMOE)


@pytest.fixture(scope="module")
def phi():
    return _smoke_weights(PHI)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32),
                               **(tol or MODEL_TOL))


def _equal(got, want):
    np.testing.assert_array_equal(np.asarray(got).astype(np.int64),
                                  np.asarray(want).astype(np.int64))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def _moe_block(jparams, tparams, layer=0):
    return (jax.tree.map(lambda a: a[layer], jparams["layers"]["moe"]),
            layer_params(tparams, layer)["moe"])


# ---------------------------------------------------------------------------
# Configs and weights
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_and_param_counts_match_reference(arch):
    for port, ref in ((get_config(arch), jax_get_config(arch)),
                      (get_smoke_config(arch), jax_smoke_config(arch))):
        assert dataclasses.asdict(port) == dataclasses.asdict(ref)
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == ref.active_param_count()
    assert get_config(arch).family == "moe"


def test_dense_param_count_matches_reference():
    for port, ref in ((get_config("internlm2-1.8b"),
                       jax_get_config("internlm2-1.8b")),
                      (get_smoke_config("internlm2-1.8b"),
                       jax_smoke_config("internlm2-1.8b"))):
        assert port.param_count() == ref.param_count()
        assert port.active_param_count() == port.param_count()


#: changes of the OLMoE smoke config into another family: the SSM and
#: hybrid ones take the mamba block of their own smoke config
FAMILY_CHANGES = [dict(family="ssm", ssm_of="falcon-mamba-7b"),
                  dict(family="hybrid", ssm_of="zamba2-1.2b", attn_every=2),
                  dict(num_codebooks=4)]


def _changed(get, change):
    """``get(OLMOE)`` with ``change`` applied (``get`` is either package's
    ``get_smoke_config``)."""
    change = dict(change)
    ssm_of = change.pop("ssm_of", None)
    if ssm_of is not None:
        change["ssm"] = get(ssm_of).ssm
    return dataclasses.replace(get(OLMOE), **change)


@pytest.mark.parametrize("change", FAMILY_CHANGES,
                         ids=["ssm", "hybrid", "codebooks"])
def test_param_count_refuses_what_the_port_does_not_serve(change):
    """Every family is served now: the SSM and hybrid families (the
    hybrid's shared block counted once) and codebooks are counted as the
    reference counts them; a family of neither package is refused."""
    cfg = _changed(get_smoke_config, change)
    ref = _changed(jax_smoke_config, change)
    assert cfg.param_count() == ref.param_count()
    assert cfg.active_param_count() == ref.active_param_count()
    with pytest.raises(ValueError, match="families"):
        dataclasses.replace(cfg, family="diffusion").param_count()


def test_olmoe_param_count_is_the_published_size():
    """About 6.9 B parameters, 1.3 B of them active a token."""
    cfg = get_config(OLMOE)
    assert 6.8e9 < cfg.param_count() < 7.0e9
    assert 1.2e9 < cfg.active_param_count() < 1.4e9


@pytest.mark.parametrize("arch", ARCHS)
def test_bridged_tree_equals_port_tree_with_an_f32_router(arch):
    """In a bf16 model the bridged tree's keys, shapes and dtypes equal
    the port's ``init_params`` tree, the router f32 in both; the qk-norm
    scales are ones of (dh,)."""
    jcfg = jax_smoke_config(arch)
    _, bridged = _bridge(jcfg, param_dtype="bfloat16")
    own = init_params(get_smoke_config(arch), device="cpu",
                      param_dtype="bfloat16")

    def specs(tree):
        if isinstance(tree, dict):
            return {k: specs(v) for k, v in tree.items()}
        return (tuple(tree.shape), tree.dtype)
    assert specs(own) == specs(bridged)
    moe = own["layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["w_gate"].dtype == torch.bfloat16
    cfg = get_smoke_config(arch)
    attn = own["layers"]["attn"]
    assert ("q_norm" in attn) == cfg.qk_norm
    if cfg.qk_norm:
        for key in ("q_norm", "k_norm"):
            assert bool((attn[key] == 1).all())
            assert tuple(attn[key].shape) == (cfg.num_layers, cfg.head_dim)
    assert "ffn" not in own["layers"]


# ---------------------------------------------------------------------------
# Routing, capacity, dispatch and the MoE layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["init_moe", "expert_capacity", "route",
                                  "_dispatch_group", "_combine_group",
                                  "apply_moe"])
def test_moe_signatures_match_reference(name):
    """The reference's parameter names, in order; ``init_moe`` draws from
    a torch generator on a device where the reference takes a key, and
    into ``out`` (a layer's slices of the stacked leaves) where given, as
    the port's other ``init_*`` functions do."""
    import inspect
    ref = list(inspect.signature(getattr(JM, name)).parameters)
    port = list(inspect.signature(getattr(M, name)).parameters)
    if name == "init_moe":
        ref = [("gen" if p == "key" else p) for p in ref] + ["device",
                                                            "out"]
    assert port == ref


def test_expert_capacity_matches_reference():
    for arch in ARCHS:
        for cfg, jcfg in ((get_config(arch), jax_get_config(arch)),
                          (get_smoke_config(arch), jax_smoke_config(arch))):
            for t in list(range(1, 300)) + [1024, 4096, 8191, 8192, 32768]:
                assert M.expert_capacity(cfg, t) == \
                    JM.expert_capacity(jcfg, t), (arch, t)
    full = get_config(OLMOE)
    assert M.expert_capacity(full, 8) == 8
    assert M.expert_capacity(full, 8192) == 1280


def _overflow(jcfg, cfg, factor=0.5):
    """Both configs with a capacity factor small enough to drop."""
    moe = dataclasses.replace(cfg.moe, capacity_factor=factor)
    jmoe = dataclasses.replace(jcfg.moe, capacity_factor=factor)
    return (dataclasses.replace(jcfg, moe=jmoe),
            dataclasses.replace(cfg, moe=moe))


def _tied(jp, tp):
    """The router with experts 1, 2 and 3 sharing one column, so every
    token's probabilities tie among them."""
    router = np.asarray(jp["router"]).copy()
    router[:, 2] = router[:, 1]
    router[:, 3] = router[:, 1]
    jp = dict(jp, router=jnp.asarray(router))
    tp = dict(tp, router=torch.from_numpy(router))
    return jp, tp


#: (config change, router change): the smoke config (no drop), a
#: capacity overflow, tied router rows
MOE_CASES = ("smoke", "overflow", "tied")


def _case(weights, case):
    jcfg, cfg, jparams, tparams = weights
    jp, tp = _moe_block(jparams, tparams)
    if case == "overflow":
        jcfg, cfg = _overflow(jcfg, cfg)
    if case == "tied":
        jp, tp = _tied(jp, tp)
    return jcfg, cfg, jp, tp


def _x(seed, b, s, d, zero_row=False):
    x = np.random.default_rng(seed).standard_normal((b, s, d)).astype(
        np.float32)
    if zero_row:
        x[0, 1] = 0.0               # every logit 0: all experts tie
    return x


@pytest.mark.parametrize("case", MOE_CASES)
def test_route_matches_reference(weights, case):
    jcfg, cfg, jp, tp = _case(weights, case)
    x = _x(1, 2, 16, cfg.d_model, zero_row=True).reshape(-1, cfg.d_model)
    w, idx, aux = M.route(cfg, tp, torch.from_numpy(x))
    jw, jidx, jaux = JM.route(jcfg, jp, jnp.asarray(x))
    _equal(idx, jidx)
    _close(w, jw, **CALL_TOL)
    _close(aux, jaux, **CALL_TOL)
    assert w.dtype == torch.float32
    # the all-zero row ties every expert: the lowest k win, in order
    _equal(idx[1], np.arange(cfg.moe.top_k))


def test_tied_router_row_is_routed_as_the_reference_routes_it(weights):
    """Experts 1..3 share a column: where they lead, experts 1 and 2 take
    the token, in that order, in both packages."""
    jcfg, cfg, jp, tp = _case(weights, "tied")
    x = _x(2, 1, 32, cfg.d_model).reshape(-1, cfg.d_model)
    _, idx, _ = M.route(cfg, tp, torch.from_numpy(x))
    _, jidx, _ = JM.route(jcfg, jp, jnp.asarray(x))
    _equal(idx, jidx)
    led = (idx[:, 0] != 0).numpy()
    assert led.any()
    _equal(idx[led], np.tile([1, 2], (int(led.sum()), 1)))


@pytest.mark.parametrize("case", MOE_CASES)
def test_dispatch_group_matches_reference(weights, case):
    """Slots, keep flags, the flat token and weight columns and the
    expert batch equal the reference's; the overflow case drops."""
    jcfg, cfg, jp, tp = _case(weights, case)
    x = _x(3, 2, 32, cfg.d_model).reshape(-1, cfg.d_model)
    jw, jidx, _ = JM.route(jcfg, jp, jnp.asarray(x))
    e = cfg.moe.num_experts
    cap = M.expert_capacity(cfg, x.shape[0])
    got = M._dispatch_group(torch.from_numpy(x),
                            torch.from_numpy(np.asarray(jidx).astype(
                                np.int64)),
                            torch.from_numpy(np.array(jw)), e, cap,
                            torch.float32)
    want = JM._dispatch_group(jnp.asarray(x), jidx, jw, e, cap, jnp.float32)
    xin, slot, flat_token, flat_weight, keep = got
    _close(xin, want[0], rtol=0, atol=0)
    _equal(slot, want[1])
    _equal(flat_token, want[2])
    _close(flat_weight, want[3], rtol=0, atol=0)
    _equal(keep, want[4])
    assert (not bool(keep.all())) == (case == "overflow")


@pytest.mark.parametrize("case", MOE_CASES)
def test_apply_moe_matches_reference(weights, case):
    jcfg, cfg, jp, tp = _case(weights, case)
    x = _x(4, 2, 32, cfg.d_model, zero_row=True)
    out, aux = M.apply_moe(cfg, tp, torch.from_numpy(x))
    jout, jaux = JM.apply_moe(jcfg, jp, jnp.asarray(x))
    assert tuple(out.shape) == x.shape
    _close(out, jout, **CALL_TOL)
    _close(aux, jaux, **CALL_TOL)


def test_overflow_drops_the_later_tokens(olmoe):
    """Past an expert's capacity the later (token, k) assignments drop:
    within each expert the kept ones are the earliest."""
    jcfg, cfg, jp, tp = _case(olmoe, "overflow")
    x = _x(5, 1, 64, cfg.d_model).reshape(-1, cfg.d_model)
    w, idx, _ = M.route(cfg, tp, torch.from_numpy(x))
    cap = M.expert_capacity(cfg, 64)
    _, _, _, _, keep = M._dispatch_group(torch.from_numpy(x), idx, w,
                                         cfg.moe.num_experts, cap,
                                         torch.float32)
    flat = idx.reshape(-1)
    for ex in range(cfg.moe.num_experts):
        mine = keep[flat == ex]
        n = int(mine.sum())
        assert n == min(cap, mine.numel())
        assert bool(mine[:n].all()) and not bool(mine[n:].any())


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("rows", [1, 3, 8])
def test_decode_tick_never_drops(arch, rows):
    """At B <= 8 rows the capacity is at least 8 and each token picks k
    distinct experts, so no assignment drops: smoke and full configs."""
    for cfg in (get_smoke_config(arch), get_config(arch)):
        assert M.expert_capacity(cfg, rows) >= rows
    cfg = get_smoke_config(arch)
    p = init_params(cfg, device="cpu", seed=rows)
    tp = layer_params(p, 0)["moe"]
    x = torch.from_numpy(_x(rows, rows, 1, cfg.d_model)).reshape(rows, -1)
    w, idx, _ = M.route(cfg, tp, x)
    _, _, _, _, keep = M._dispatch_group(
        x, idx, w, cfg.moe.num_experts, M.expert_capacity(cfg, rows),
        torch.float32)
    assert bool(keep.all())
    assert all(len(set(r)) == cfg.moe.top_k for r in idx.tolist())


def test_moe_path_has_no_atomics_syncs_or_data_dependent_shapes():
    """The MoE module calls nothing that adds in an unspecified order,
    reads a value back to the host or makes a shape from data."""
    tree = ast.parse((PORT / "models" / "moe.py").read_text())
    names = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    keywords = {k.arg for n in ast.walk(tree) if isinstance(n, ast.Call)
                for k in n.keywords}
    banned = {"index_add", "index_add_", "index_put", "index_put_",
              "scatter_add", "scatter_add_", "scatter_reduce", "nonzero",
              "masked_select", "repeat_interleave", "item", "tolist",
              "unique", "bincount", "one_hot", "topk", "cpu", "numpy"}
    assert not names & banned
    assert "accumulate" not in keywords


# ---------------------------------------------------------------------------
# qk-norm and the model's entry points
# ---------------------------------------------------------------------------


def test_qkv_project_with_qk_norm_matches_reference(olmoe):
    """q and k normalised per head before RoPE, with scales other than
    ones, as the reference does."""
    jcfg, cfg, jparams, tparams = olmoe
    assert cfg.qk_norm
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 30]).astype(np.int32)
    jblk = dict(jax.tree.map(lambda a: a[1], jparams["layers"]["attn"]))
    scales = {k: (1 + 0.2 * rng.standard_normal(cfg.head_dim)).astype(
        np.float32) for k in ("q_norm", "k_norm")}
    jblk.update({k: jnp.asarray(v) for k, v in scales.items()})
    tblk = dict(layer_params(tparams, 1)["attn"])
    tblk.update({k: torch.from_numpy(v) for k, v in scales.items()})
    got = L.qkv_project(cfg, tblk, torch.from_numpy(x), torch.from_numpy(pos))
    want = JL.qkv_project(jcfg, jblk, jnp.asarray(x), jnp.asarray(pos))
    for g, w in zip(got, want):
        _close(g, w, **CALL_TOL)
    plain = dataclasses.replace(cfg, qk_norm=False)
    q_plain = L.qkv_project(plain, tblk, torch.from_numpy(x),
                            torch.from_numpy(pos))[0]
    assert not torch.allclose(q_plain, got[0])


def test_prefill_matches_reference(weights):
    jcfg, cfg, jparams, tparams = weights
    toks = _tokens(5, 3, 24, cfg.vocab_size)
    lens = np.array([24, 9, 1], np.int32)
    logits, parts = prefill(cfg, tparams, torch.from_numpy(toks),
                            true_lengths=torch.from_numpy(lens),
                            cache_dtype=torch.float32)
    jlogits, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks),
                                  max_len=32, true_lengths=jnp.asarray(lens),
                                  cache_dtype=jnp.float32)
    _close(logits, jlogits)
    for key in ("k", "v"):
        _close(parts[key], np.asarray(jcache[key])[:, :, :24])


@pytest.mark.parametrize("prefix_len", [0, 16])
def test_prefill_suffix_matches_reference(weights, prefix_len):
    jcfg, cfg, jparams, tparams = weights
    rng = np.random.default_rng(prefix_len + 1)
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
    _close(logits, want_logits)
    for key in ("k", "v"):
        _close(parts[key], want[key])


def test_prefill_packed_matches_reference(weights):
    """Three segments, two after prefix keys, padded to 32 slots: the pad
    tail is routed and takes capacity in both packages."""
    jcfg, cfg, jparams, tparams = weights
    fresh, prefix = (6, 1, 13), (5, 0, 3)
    rng = np.random.default_rng(7)
    pack = 32
    seg = np.full((pack,), -1, np.int32)
    pos = np.zeros((pack,), np.int32)
    at = 0
    for i, (n, off) in enumerate(zip(fresh, prefix)):
        seg[at:at + n] = i
        pos[at:at + n] = np.arange(off, off + n)
        at += n
    toks = np.zeros((1, pack), np.int32)
    toks[0, :at] = rng.integers(1, cfg.vocab_size, at)
    last = (np.cumsum(fresh) - 1).astype(np.int32)
    p_seg = np.concatenate([np.full((n,), i, np.int32)
                            for i, n in enumerate(prefix)])
    p_pos = np.concatenate([np.arange(n, dtype=np.int32) for n in prefix])
    pre_shape = (cfg.num_layers, sum(prefix), cfg.num_kv_heads,
                 cfg.head_dim)
    pk = rng.standard_normal(pre_shape).astype(np.float32)
    pv = rng.standard_normal(pre_shape).astype(np.float32)
    want_logits, want = jax_prefill_packed(
        jcfg, jparams, jnp.asarray(toks), jnp.asarray(seg), jnp.asarray(pos),
        jnp.asarray(last), jnp.asarray(pk), jnp.asarray(pv),
        jnp.asarray(p_seg), jnp.asarray(p_pos), cache_dtype=jnp.float32)

    def t(a):
        return torch.from_numpy(np.array(a))
    logits, parts = prefill_packed(
        cfg, tparams, t(toks).long(), t(seg), t(pos), t(last), t(pk), t(pv),
        t(p_seg), t(p_pos), cache_dtype=torch.float32)
    _close(logits, want_logits)
    for key in ("k", "v"):
        _close(parts[key], want[key])


def test_paged_decode_steps_match_reference(weights):
    jcfg, cfg, jparams, tparams = weights
    b, nb, bs, mb = 3, 3 * 6 + 1, 4, 6
    rng = np.random.default_rng(8)
    lens = rng.integers(1, (mb - 2) * bs, b).astype(np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    used = 0
    for i in range(b):
        need = -(-(int(lens[i]) + 5) // bs)
        tables[i, :need] = perm[used:used + need]
        used += need
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.head_dim)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    tcache = make_paged_cache(cfg, b, nb, bs, mb, torch.float32,
                              device="cpu")
    jcache = jax_make_paged_cache(jcfg, b, nb, bs, mb, dtype=jnp.float32)
    for key, val in (("k", k), ("v", v), ("block_tables", tables),
                     ("len", lens)):
        tcache[key] = torch.from_numpy(val.copy())
        jcache[key] = jnp.asarray(val)
    toks = _tokens(9, 5, b, cfg.vocab_size)
    for step in range(5):
        logits, tcache = decode_step(cfg, tparams, tcache,
                                     torch.from_numpy(toks[step]))
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(toks[step]))
        _close(logits, jlogits)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


# ---------------------------------------------------------------------------
# The engine and the client
# ---------------------------------------------------------------------------


def _engine(tparams, cfg, batch_buckets=(1, 2, 4)):
    return InferenceEngine(cfg, tparams, ladder=BucketLadder(
        seq_buckets=(32, 64), batch_buckets=batch_buckets), device="cpu")


def _jax_engine(jcfg, jparams, batch_buckets=(1, 2, 4)):
    return JaxInferenceEngine(jcfg, jparams, ladder=JaxLadder(
        seq_buckets=(32, 64), batch_buckets=batch_buckets))


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_continuous_engine_admits_moe(olmoe, layout):
    _, cfg, _, tparams = olmoe
    ce = ContinuousEngine(_engine(tparams, cfg), max_slots=2,
                          kv_layout=layout)
    client = TurboClient(ce)
    out = client.submit([5, 6, 7], GenerationParams(max_new_tokens=3))
    assert len(out.result()) == 6


@pytest.mark.parametrize("change", FAMILY_CHANGES,
                         ids=["ssm", "hybrid", "codebooks"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_continuous_engine_refuses_other_families(olmoe, change, layout):
    """The SSM and hybrid families are served on the contiguous layout
    and refused on the paged one with the reference's message; codebook
    models are refused on both; each family's init draws its tree."""
    _, cfg, _, tparams = olmoe
    engine = _engine(tparams, cfg)
    engine.cfg = _changed(get_smoke_config, change)
    init_params(engine.cfg, device="cpu")
    if "family" not in change:
        with pytest.raises(ValueError, match="codebook"):
            ContinuousEngine(engine, max_slots=2, kv_layout=layout)
        return
    if layout == "paged":
        with pytest.raises(ValueError, match="use kv_layout='contiguous' "
                           "for SSM/hybrid"):
            ContinuousEngine(engine, max_slots=2, kv_layout=layout)
        return
    ce = ContinuousEngine(engine, max_slots=2, kv_layout=layout)
    assert ce.kv_layout == "contiguous" and ce.block_table is None


def _serve_both(weights, work, *, packed, chunked=False,
                prefix_cache=False, warmup=False):
    jcfg, cfg, jparams, tparams = weights
    opts = dict(max_slots=4, cap_new=24, packed_prefill=packed,
                prefix_cache=prefix_cache)
    pipe = dict(policy="dp", max_batch_size=4, chunked_prefill=chunked,
                prefill_chunk_tokens=16)
    jclient = JaxClient(JaxContinuousEngine(_jax_engine(jcfg, jparams),
                                            **opts),
                        cost_model=JaxCostModel(**COST),
                        config=JaxPipelineConfig(**pipe), warmup=warmup)
    client = TurboClient(ContinuousEngine(_engine(tparams, cfg), **opts),
                         cost_model=AnalyticCostModel(**COST),
                         config=PipelineConfig(**pipe), warmup=warmup)
    if warmup:
        assert client.warmup_stats["rounds"] == \
            jclient.warmup_stats["rounds"]
    _, want = _serve(jclient, JaxParams, work)
    handles, got = _serve(client, GenerationParams, work)
    assert [h.tokens() for h in handles] == \
        [r[len(p):] for r, (p, _) in zip(got, work)]
    return jclient, client, want, got


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
@pytest.mark.parametrize("seed", [11, 12])
def test_client_streams_match_reference(olmoe, seed, packed):
    """Greedy and seeded-sampled streams equal the reference client's
    token for token, on the packed default and per group, with the
    engine's and pipeline's counters equal."""
    jclient, client, want, got = _serve_both(olmoe, _workload(seed),
                                             packed=packed)
    assert got == want
    assert counters(client) == counters(jclient)
    ce = client.backend
    assert (ce.pack_dispatches > 0) == packed
    assert ce.block_table.used_blocks == 0
    assert ce.engine.kv_slab.live_bytes == 0


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
def test_client_streams_match_reference_under_capacity_overflow(olmoe,
                                                                 packed):
    """With a capacity factor of 0.5 a prefill drops assignments (pad
    slots and other prompts of the pack or group compete): the streams
    still equal the reference's, which drops the same ones."""
    jcfg, cfg, jparams, tparams = olmoe
    jcfg, cfg = _overflow(jcfg, cfg)
    jclient, client, want, got = _serve_both(
        (jcfg, cfg, jparams, tparams), _workload(14), packed=packed)
    assert got == want
    assert counters(client) == counters(jclient)


def test_warmed_client_streams_match_reference(olmoe):
    """``warmup_aot`` walks the reference's rounds on a MoE model and
    the warmed client then serves the reference's streams."""
    jclient, client, want, got = _serve_both(olmoe, _workload(15),
                                             packed=True, warmup=True)
    assert got == want
    assert client.backend.engine.prefill_cells.keys()


@pytest.mark.parametrize("packed", [True, False],
                         ids=["packed", "per_group"])
def test_prefix_cache_and_chunked_streams_match_reference(olmoe, packed):
    """With the prefix cache and chunked prefill: streams, hits, copies,
    chunked prefills and pack counters equal the reference's."""
    jclient, client, want, got = _serve_both(
        olmoe, _prefix_workload(3, n=10), packed=packed, chunked=True,
        prefix_cache=True)
    assert got == want
    assert counters(client) == counters(jclient)
    stats = client.backend.prefix_stats()
    assert stats["hits"] > 0
    assert client.pipeline.stats.chunked_prefills > 0
    assert_drained(client.backend)


def test_phi35_moe_client_streams_match_reference(phi):
    """The other MoE smoke config (LayerNorm, GQA, no qk-norm) through
    the packed default."""
    jclient, client, want, got = _serve_both(phi, _workload(13),
                                             packed=True)
    assert got == want
    assert counters(client) == counters(jclient)
