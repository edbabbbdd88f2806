"""The port's dense decoder against `repro.models` on the same weights.

The reference's `init_params` draws the weights; the bridge
(`repro_torch.models.bridge`) carries them over as numpy arrays, so both
packages run the identical parameter tree.  Everything is f32 on the
CPU; the two sides differ in summation order and in the attention
routine (the reference's `attention_naive` / gather + `attention_decode`,
the port's flash and paged-decode kernels' plain versions), hence the
f32 tolerances below (1e-4 relative and absolute on logits and KV, over
two layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as JL
from repro.models import make_paged_cache as jax_make_paged_cache
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.models import (decode_step, init_params, make_paged_cache,
                                prefill)
from repro_torch.models import layers as L
from repro_torch.models.bridge import params_from_numpy
from repro_torch.models.transformer import layer_params

TOL = dict(rtol=1e-4, atol=1e-4)
ARCH = "internlm2-1.8b"


@pytest.fixture(scope="module")
def weights():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, get_smoke_config(ARCH), jparams, tparams


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or TOL))


def _tokens(seed, b, s, vocab):
    return np.random.default_rng(seed).integers(1, vocab, (b, s)).astype(
        np.int32)


def test_bridge_keeps_keys_and_layouts(weights):
    jcfg, cfg, jparams, tparams = weights
    flat_j = jax.tree_util.tree_leaves_with_path(jparams)

    def count(tree):
        if isinstance(tree, dict):
            return sum(count(v) for v in tree.values())
        return 1
    assert count(tparams) == len(flat_j)
    attn = tparams["layers"]["attn"]
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.d_head
    assert tuple(attn["wq"].shape) == (cfg.num_layers, d, h, dh)
    assert tuple(attn["wk"].shape) == (cfg.num_layers, d, kv, dh)
    assert tuple(attn["wo"].shape) == (cfg.num_layers, h, dh, d)
    assert tuple(tparams["embed"]["tok"].shape) == (1, cfg.vocab_size, d)
    for path, leaf in flat_j:
        node = tparams
        for key in path:
            node = node[key.key]
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_port_init_params_matches_reference_tree(weights):
    _, cfg, _, tparams = weights
    gen = torch.Generator().manual_seed(3)
    own = init_params(cfg, gen, "cpu")

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), tree.dtype)
    assert shapes(own) == shapes(tparams)
    again = init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    torch.testing.assert_close(own["layers"]["attn"]["wq"],
                               again["layers"]["attn"]["wq"], rtol=0, atol=0)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
@pytest.mark.parametrize("with_residual", [False, True])
def test_apply_norm_matches_reference(weights, norm, with_residual):
    jcfg, cfg, _, _ = weights
    jcfg = dataclasses.replace(jcfg, norm=norm)
    cfg = dataclasses.replace(cfg, norm=norm)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    res = rng.standard_normal(x.shape).astype(np.float32)
    p = {"scale": (1 + 0.1 * rng.standard_normal(cfg.d_model)).astype(
        np.float32), "bias": rng.standard_normal(cfg.d_model).astype(
        np.float32)}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    if with_residual:
        got, s = L.apply_norm(cfg, tp, torch.from_numpy(x),
                              residual=torch.from_numpy(res))
        _close(s, x + res, rtol=0, atol=0)
        want = JL.apply_norm(jcfg, jp, jnp.asarray(x + res))
    else:
        got = L.apply_norm(cfg, tp, torch.from_numpy(x))
        want = JL.apply_norm(jcfg, jp, jnp.asarray(x))
    _close(got, want, rtol=1e-5, atol=1e-5)


def test_rope_and_projections_match_reference(weights):
    jcfg, cfg, jparams, tparams = weights
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 7, cfg.d_model)).astype(np.float32)
    pos = np.stack([np.arange(7), np.arange(7) + 30]).astype(np.int32)
    jblk = jax.tree.map(lambda a: a[1], jparams["layers"])
    tblk = layer_params(tparams, 1)
    tq, tk, tv = L.qkv_project(cfg, tblk["attn"], torch.from_numpy(x),
                               torch.from_numpy(pos))
    jq, jk, jv = JL.qkv_project(jcfg, jblk["attn"], jnp.asarray(x),
                                jnp.asarray(pos))
    for got, want in ((tq, jq), (tk, jk), (tv, jv)):
        _close(got, want, rtol=1e-5, atol=1e-5)
    attn = rng.standard_normal(tq.shape).astype(np.float32)
    _close(L.attention_output(tblk["attn"], torch.from_numpy(attn)),
           JL.attention_output(jblk["attn"], jnp.asarray(attn)),
           rtol=1e-5, atol=1e-5)
    _close(L.apply_ffn(cfg, tblk["ffn"], torch.from_numpy(x)),
           JL.apply_ffn(jcfg, jblk["ffn"], jnp.asarray(x)),
           rtol=1e-5, atol=1e-5)


def test_embed_and_logits_match_reference(weights):
    jcfg, cfg, jparams, tparams = weights
    toks = _tokens(4, 2, 6, cfg.vocab_size)
    h = L.embed_tokens(cfg, tparams["embed"], torch.from_numpy(toks))
    _close(h, JL.embed_tokens(jcfg, jparams["embed"], jnp.asarray(toks)),
           rtol=0, atol=0)
    _close(L.lm_logits(cfg, tparams["embed"], h),
           JL.lm_logits(jcfg, jparams["embed"], jnp.asarray(h.numpy())),
           rtol=1e-5, atol=1e-5)


def test_prefill_logits_and_kv_match_reference(weights):
    jcfg, cfg, jparams, tparams = weights
    toks = _tokens(5, 3, 24, cfg.vocab_size)
    lens = np.array([24, 9, 1], np.int32)
    logits, parts = prefill(cfg, tparams, torch.from_numpy(toks),
                            true_lengths=torch.from_numpy(lens))
    jlogits, jcache = jax_prefill(jcfg, jparams, jnp.asarray(toks),
                                  max_len=32,
                                  true_lengths=jnp.asarray(lens),
                                  cache_dtype=jnp.float32)
    _close(logits, jlogits)
    np.testing.assert_array_equal(parts["len"].numpy(), lens)
    for key in ("k", "v"):
        _close(parts[key], np.asarray(jcache[key])[:, :, :24])


def _paged_pair(jcfg, cfg, b, nb, bs, mb, seed, steps=5):
    """The same paged cache for both packages: ragged prompt KV already
    in scattered blocks, trash block 0 holding garbage."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, (mb - 2) * bs, b).astype(np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    used = 0
    for i in range(b):
        need = -(-(int(lens[i]) + steps) // bs)     # later entries: trash
        tables[i, :need] = perm[used:used + need]
        used += need
    shape = (cfg.num_layers, nb, bs, cfg.num_kv_heads, cfg.d_head)
    k = rng.standard_normal(shape).astype(np.float32)
    v = rng.standard_normal(shape).astype(np.float32)
    k[:, 0] = v[:, 0] = 50.0                       # trash garbage
    tcache = make_paged_cache(cfg, b, nb, bs, mb, device="cpu")
    jcache = jax_make_paged_cache(jcfg, b, nb, bs, mb, dtype=jnp.float32)
    for key, val in (("k", k), ("v", v), ("block_tables", tables),
                     ("len", lens)):
        tcache[key] = torch.from_numpy(val.copy())
        jcache[key] = jnp.asarray(val)
    return tcache, jcache


def test_decode_steps_match_reference_on_paged_pool(weights):
    jcfg, cfg, jparams, tparams = weights
    b, nb, bs, mb = 3, 3 * 6 + 1, 4, 6
    tcache, jcache = _paged_pair(jcfg, cfg, b, nb, bs, mb, seed=6)
    start = tcache["len"].clone()
    toks = _tokens(7, 5, b, cfg.vocab_size)
    for t in range(5):
        logits, tcache = decode_step(cfg, tparams, tcache,
                                     torch.from_numpy(toks[t]))
        jlogits, jcache = jax_decode_step(jcfg, jparams, jcache,
                                          jnp.asarray(toks[t]))
        _close(logits, jlogits)
        np.testing.assert_array_equal(tcache["len"].numpy(),
                                      np.asarray(jcache["len"]))
    np.testing.assert_array_equal(tcache["len"].numpy(), start.numpy() + 5)
    for key in ("k", "v"):
        _close(tcache[key], jcache[key])


def test_decode_writes_only_each_rows_next_position(weights):
    _, cfg, _, tparams = weights
    b, nb, bs, mb = 2, 2 * 4 + 1, 4, 4
    jcfg = jax_smoke_config(ARCH)
    tcache, _ = _paged_pair(jcfg, cfg, b, nb, bs, mb, seed=8)
    before = {k: tcache[k].clone() for k in ("k", "v")}
    lens = tcache["len"].numpy().copy()
    tables = tcache["block_tables"].numpy()
    decode_step(cfg, tparams, tcache, torch.tensor([3, 4]))
    changed = (tcache["k"] != before["k"]).any(-1).any(-1).any(0).numpy()
    want = np.zeros((nb, bs), bool)
    for i in range(b):
        want[tables[i, lens[i] // bs], lens[i] % bs] = True
    np.testing.assert_array_equal(changed, want)
