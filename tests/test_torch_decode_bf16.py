"""Decode over a bf16 K/V (the model functions' default cache, as the JAX
package's), held against the JAX package on the CPU.

The Pallas decode kernels read K and V in their stored type and compute
in f32 (``src/repro/kernels/flash_decode.py``); the port's plain versions
cast K and V to f32 before the products, and its wrappers route CPU
tensors to them.  So on the same bf16 values both compute in f32 and
differ only in summation order: at most 1e-5 absolute with f32 queries.

Then the model functions on their defaults: the port's ``prefill`` and 8
``decode_step``s on its default (bf16) cache against the reference's on
its default (bf16) cache, on bridged weights at the InternLM2 and Zamba2
smoke configs (f32 weights).  Both round the same f32 K/V to bf16, but an
f32 value a summation order apart may round to the neighbouring bf16 value,
so the logits are held to 1e-3 absolute and relative, and the caches'
dtypes and the step count equal.

The bf16 kernels themselves run only on a card: ``tests/test_torch_cuda.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config as jax_smoke_config
from repro.kernels.flash_decode import (flash_decode_paged_pallas,
                                        flash_decode_pallas)
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.kernels import ops, ref
from repro_torch.models import decode_step, make_cache, make_paged_cache
from repro_torch.models import prefill
from repro_torch.models.bridge import params_from_numpy

#: f32 queries over the same bf16 K/V: summation order only
KERNEL_TOL = dict(rtol=0, atol=1e-5)
#: the model functions on their bf16 caches: see the module docstring
MODEL_TOL = dict(rtol=1e-3, atol=1e-3)
STEPS = 8


def _bf16(a: np.ndarray) -> np.ndarray:
    """``a`` rounded to bf16 once (by JAX), kept as f32 numpy: both
    packages are handed these values."""
    return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))


def _kv_torch(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.copy()).bfloat16()


def _kv_jax(a: np.ndarray):
    return jnp.asarray(a).astype(jnp.bfloat16)


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **tol)


@pytest.mark.parametrize("b,h,kv,s", [(3, 4, 2, 48), (2, 8, 1, 40),
                                      (4, 4, 4, 33)])
def test_contiguous_decode_over_bf16_kv_matches_pallas(b, h, kv, s):
    """The plain version and the wrapper (a strided (B, KV, S, dh) view of
    the (B, S, KV, dh) cache) against ``flash_decode_pallas`` in interpret
    mode on the same bf16 K/V; ragged lengths, one row of one key and one
    of the whole cache."""
    rng = np.random.default_rng(b * 10 + s)
    dh = 16
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, s
    q = rng.standard_normal((b, h, dh), np.float32)
    kc = _bf16(rng.standard_normal((b, s, kv, dh), np.float32))
    vc = _bf16(rng.standard_normal((b, s, kv, dh), np.float32))
    k, v = _kv_torch(kc).transpose(1, 2), _kv_torch(vc).transpose(1, 2)
    got = ops.flash_decode(torch.from_numpy(q), k, v,
                           torch.from_numpy(lengths))
    plain = ref.flash_decode_ref(torch.from_numpy(q), k, v,
                                 torch.from_numpy(lengths))
    assert got.dtype == torch.float32
    pallas = flash_decode_pallas(
        jnp.asarray(q), _kv_jax(kc.swapaxes(1, 2)),
        _kv_jax(vc.swapaxes(1, 2)), jnp.asarray(lengths), num_splits=2,
        block_k=8, interpret=True)
    _close(got, pallas, **KERNEL_TOL)
    _close(plain, pallas, **KERNEL_TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_decode_over_bf16_kv_matches_pallas(seed):
    """The paged plain version and wrapper against
    ``flash_decode_paged_pallas`` in interpret mode on the same bf16 pool
    (blocks scattered by a permutation, unassigned entries on the trash
    block 0, which holds garbage)."""
    rng = np.random.default_rng(seed)
    b, h, kv, dh, bs, mb = 3, 4, 2, 16, 4, 6
    nb = b * mb + 1
    lengths = rng.integers(1, mb * bs + 1, b).astype(np.int32)
    lengths[0] = 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        nblk = -(-int(ln) // bs)
        tables[i, :nblk] = perm[used:used + nblk]
        used += nblk
    q = rng.standard_normal((b, h, dh), np.float32)
    kp = rng.standard_normal((nb, bs, kv, dh), np.float32)
    vp = rng.standard_normal((nb, bs, kv, dh), np.float32)
    kp[0] = vp[0] = 1e4
    kp, vp = _bf16(kp), _bf16(vp)
    targs = (torch.from_numpy(q), _kv_torch(kp), _kv_torch(vp),
             torch.from_numpy(tables), torch.from_numpy(lengths))
    got = ops.flash_decode_paged(*targs)
    plain = ref.flash_decode_paged_ref(*targs)
    pallas = flash_decode_paged_pallas(
        jnp.asarray(q), _kv_jax(kp), _kv_jax(vp), jnp.asarray(tables),
        jnp.asarray(lengths), num_splits=2, interpret=True)
    _close(got, pallas, **KERNEL_TOL)
    _close(plain, pallas, **KERNEL_TOL)


def test_cache_constructors_default_to_bf16():
    """The reference's defaults: both cache constructors and the prefill
    give bf16 K/V (an SSM model's conv window too; its scan state stays
    f32)."""
    cfg = get_smoke_config("internlm2-1.8b")
    assert make_cache(cfg, 2, 8, device="cpu")["k"].dtype == torch.bfloat16
    assert make_paged_cache(cfg, 2, 5, 4, 2,
                            device="cpu")["v"].dtype == torch.bfloat16
    zcfg = get_smoke_config("zamba2-1.2b")
    zc = make_cache(zcfg, 2, 8, device="cpu")
    assert zc["conv"].dtype == zc["shared_k"].dtype == torch.bfloat16
    assert zc["state"].dtype == torch.float32


@pytest.fixture(scope="module", params=["internlm2-1.8b", "zamba2-1.2b"])
def model(request):
    arch = request.param
    jcfg = jax_smoke_config(arch)
    jparams = jax_init_params(jcfg, jax.random.key(3))
    tparams = params_from_numpy(jax.tree.map(np.asarray, jparams),
                                device="cpu")
    return jcfg, get_smoke_config(arch), jparams, tparams


def test_prefill_and_decode_on_the_default_cache_match_reference(model):
    """The port's prefill into its default cache, then 8 decode steps fed
    the reference's greedy tokens, against the reference's prefill and
    steps on its default cache: every cache leaf's dtype equal after the
    prefill (bf16 K/V and conv window) and after the steps, logits within
    ``MODEL_TOL`` at every step, the K/V (the shared block's, for Zamba2)
    within one bf16 ulp of the values."""
    jcfg, cfg, jparams, tparams = model
    toks = np.random.default_rng(4).integers(1, 256, (3, 21)).astype(
        np.int32)
    max_len = toks.shape[1] + STEPS
    jl, jc = jax_prefill(jcfg, jparams, jnp.asarray(toks), max_len=max_len)
    tl, tc = prefill(cfg, tparams, torch.from_numpy(toks), max_len=max_len)
    kv = "shared_k" if cfg.attn_every else "k"
    assert tc[kv].dtype == torch.bfloat16
    assert set(tc) == set(jc)
    for key in jc:
        assert str(tc[key].dtype).replace("torch.", "") == \
            str(jc[key].dtype), key
    _close(tl, jl, **MODEL_TOL)
    for _ in range(STEPS):
        cur = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)
        jl, jc = jax_decode_step(jcfg, jparams, jc, jnp.asarray(cur))
        tl, tc = decode_step(cfg, tparams, tc, torch.from_numpy(cur))
        _close(tl, jl, **MODEL_TOL)
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    # the reference's step returns the conv window in the activations'
    # f32 (the promotion of the two types): the port's cache follows
    for key in jc:
        assert str(tc[key].dtype).replace("torch.", "") == \
            str(jc[key].dtype), key
    # one bf16 ulp of values below 4 is 2**-6
    _close(tc[kv].float(), np.asarray(jc[kv], np.float32), rtol=2 ** -7,
           atol=2 ** -6)
