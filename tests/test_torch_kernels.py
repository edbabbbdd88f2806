"""The port's kernels, held against the JAX package on the CPU.

Each plain version in `repro_torch.kernels.ref` (which `repro_torch.kernels
.ops` routes CPU tensors to) is compared with the JAX oracle in
`repro.kernels.ref` and with the Pallas kernel run in interpret mode, on
the same numpy inputs.  Tolerances are f32: both sides compute in f32 and
differ only in summation order (2e-5 relative / absolute).  Sampling is
compared token for token on shared Gumbel noise; the masked softmax on
bf16 input to one bf16 ulp of its output.

The Hopper kernels themselves run only on a card: see
``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops

F32 = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), **(tol or F32))


# ---------------------------------------------------------------------------
# fused norm (both modes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("with_bias", [False, True])
@pytest.mark.parametrize("with_residual,return_residual",
                         [(False, False), (True, False), (True, True)])
def test_norm_plain_matches_reference_and_pallas(rms, with_bias,
                                                 with_residual,
                                                 return_residual):
    rng = np.random.default_rng(11)
    r, c = 24, 96
    x = rng.standard_normal((r, c), np.float32)
    g = (1 + 0.1 * rng.standard_normal(c)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(c)).astype(np.float32)
    bias = (0.1 * rng.standard_normal(c)).astype(np.float32) \
        if with_bias else None
    res = rng.standard_normal((r, c), np.float32) if with_residual else None
    j = (lambda a: None if a is None else jnp.asarray(a))
    t = (lambda a: None if a is None else _t(a))
    if rms:
        got = ops.fused_rmsnorm(t(x), t(g), t(bias), t(res),
                                return_residual=return_residual)
        want = jref.rmsnorm_ref(j(x), j(g), j(bias), j(res),
                                return_residual=return_residual)
        pallas = jops.fused_rmsnorm(j(x), j(g), j(bias), j(res),
                                    return_residual=return_residual,
                                    impl="interpret")
    else:
        got = ops.fused_layernorm(t(x), t(g), t(beta), t(bias), t(res),
                                  return_residual=return_residual)
        want = jref.layernorm_ref(j(x), j(g), j(beta), j(bias), j(res),
                                  return_residual=return_residual)
        pallas = jops.fused_layernorm(j(x), j(g), j(beta), j(bias), j(res),
                                      return_residual=return_residual,
                                      impl="interpret")
    if return_residual:
        for a, b, p in zip(got, want, pallas):
            _close(a, b)
            _close(a, p)
    else:
        _close(got, want)
        _close(got, pallas)


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,sq,sk,causal,with_lengths", [
    (2, 4, 2, 32, 32, True, False),      # GQA causal prefill
    (2, 4, 4, 24, 24, False, True),      # MHA, ragged lengths
    (1, 8, 2, 8, 40, True, True),        # Sq < Sk: suffix queries
    (3, 4, 1, 16, 16, True, True),       # MQA with lengths
])
def test_flash_attention_plain_matches_reference_and_pallas(
        b, h, kv, sq, sk, causal, with_lengths):
    rng = np.random.default_rng(b * 100 + sq)
    dh = 16
    q = rng.standard_normal((b, h, sq, dh), np.float32)
    k = rng.standard_normal((b, kv, sk, dh), np.float32)
    v = rng.standard_normal((b, kv, sk, dh), np.float32)
    lengths = rng.integers(sk - sq + 1, sk + 1, b).astype(np.int32) \
        if with_lengths else None
    got = ops.flash_attention(_t(q), _t(k), _t(v),
                              None if lengths is None else _t(lengths),
                              causal=causal)
    jl = None if lengths is None else jnp.asarray(lengths)
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), jl, causal=causal)
    pallas = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jl, causal=causal,
                                  impl="interpret", block_q=8, block_k=8)
    _close(got, want)
    _close(got, pallas)


def test_flash_attention_reads_strided_model_layout():
    """The model hands (B,S,H,dh) activations viewed as (B,H,S,dh)."""
    rng = np.random.default_rng(3)
    q = _t(rng.standard_normal((2, 12, 4, 16), np.float32))
    k = _t(rng.standard_normal((2, 12, 2, 16), np.float32))
    v = _t(rng.standard_normal((2, 12, 2, 16), np.float32))
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    want = ops.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous())
    _close(got, want, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# paged decode
# ---------------------------------------------------------------------------

def _paged_case(seed, b=3, h=4, kv=2, dh=16, bs=4, mb=6):
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    lengths = rng.integers(1, mb * bs + 1, b).astype(np.int32)
    lengths[0] = 1                               # a one-token row
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)         # unassigned: trash 0
    used = 0
    for i, ln in enumerate(lengths):
        nblk = -(-int(ln) // bs)
        tables[i, :nblk] = perm[used:used + nblk]
        used += nblk
    q = rng.standard_normal((b, h, dh), np.float32)
    kp = rng.standard_normal((nb, bs, kv, dh), np.float32)
    vp = rng.standard_normal((nb, bs, kv, dh), np.float32)
    kp[0] = vp[0] = 1e4                          # trash block garbage
    return q, kp, vp, tables, lengths


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_decode_plain_matches_reference_and_pallas(seed):
    q, kp, vp, tables, lengths = _paged_case(seed)
    got = ops.flash_decode_paged(_t(q), _t(kp), _t(vp), _t(tables),
                                 _t(lengths))
    args = [jnp.asarray(a) for a in (q, kp, vp, tables, lengths)]
    want = jops.flash_decode_paged(*args, impl="xla")
    pallas = jops.flash_decode_paged(*args, num_splits=2, impl="interpret")
    _close(got, want)
    _close(got, pallas)


# ---------------------------------------------------------------------------
# contiguous decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kv,s", [(3, 4, 2, 48), (2, 8, 1, 40),
                                      (4, 4, 4, 33)])
def test_contiguous_decode_plain_matches_reference_and_pallas(b, h, kv, s):
    """GQA / MQA / MHA with ragged lengths (one row of a single key, one
    of the whole cache); the port reads the (B, S, KV, dh) cache layout
    as a strided (B, KV, S, dh) view."""
    rng = np.random.default_rng(b * 10 + s)
    dh = 16
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, s
    q = rng.standard_normal((b, h, dh), np.float32)
    kc = rng.standard_normal((b, s, kv, dh), np.float32)
    vc = rng.standard_normal((b, s, kv, dh), np.float32)
    got = ops.flash_decode(_t(q), _t(kc).transpose(1, 2),
                           _t(vc).transpose(1, 2), _t(lengths))
    args = [jnp.asarray(a) for a in (q, kc.swapaxes(1, 2),
                                     vc.swapaxes(1, 2), lengths)]
    want = jops.flash_decode(*args, impl="xla")
    pallas = jops.flash_decode(*args, num_splits=2, block_k=8,
                               impl="interpret")
    _close(got, want, rtol=1e-5, atol=1e-5)
    _close(got, pallas, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# masked softmax
# ---------------------------------------------------------------------------

def _softmax_case(seed, rows=24, cols=40):
    rng = np.random.default_rng(seed)
    x = (4 * rng.standard_normal((rows, cols))).astype(np.float32)
    lengths = rng.integers(1, cols + 1, rows).astype(np.int32)
    lengths[:3] = [0, cols + 7, cols]       # empty, past C, exactly C
    return x, lengths


@pytest.mark.parametrize("scale", [1.0, 0.125])
@pytest.mark.parametrize("with_lengths", [True, False])
def test_softmax_plain_matches_reference_and_pallas_f32(scale,
                                                        with_lengths):
    x, lengths = _softmax_case(int(scale * 8) + with_lengths)
    ln = lengths if with_lengths else None
    got = ops.fused_softmax(_t(x), None if ln is None else _t(ln),
                            scale=scale)
    jx, jl = jnp.asarray(x), None if ln is None else jnp.asarray(ln)
    want = jops.fused_softmax(jx, jl, scale=scale, impl="xla")
    pallas = jops.fused_softmax(jx, jl, scale=scale, impl="interpret")
    _close(got, want, rtol=1e-6, atol=1e-6)
    _close(got, pallas, rtol=1e-6, atol=1e-6)
    if with_lengths:
        past = np.arange(x.shape[1])[None, :] >= lengths[:, None]
        assert (got.numpy()[past] == 0).all()
        assert (got.numpy()[0] == 0).all()       # the empty row: no NaN


@pytest.mark.parametrize("scale", [1.0, 0.3])
def test_softmax_plain_matches_reference_and_pallas_bf16(scale):
    x, lengths = _softmax_case(5)
    xb = torch.from_numpy(x).bfloat16()
    got = ops.fused_softmax(xb, _t(lengths), scale=scale)
    assert got.dtype == torch.bfloat16
    jx = jnp.asarray(xb.float().numpy()).astype(jnp.bfloat16)
    jl = jnp.asarray(lengths)
    # one bf16 ulp: at most 2^-7 of the value
    for impl in ("xla", "interpret"):
        want = jops.fused_softmax(jx, jl, scale=scale, impl=impl)
        _close(got.float(), np.asarray(want.astype(jnp.float32)),
               rtol=2 ** -7, atol=0)


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------

def _sample_case(seed, rows=6, cols=300, c=16):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.standard_normal((rows, cols))).astype(np.float32)
    logits[0, 10:14] = logits[0].max() + 1        # ties at the top
    logits[1, :] = 0.5                            # a fully tied row
    temp = np.array([0.0, 0.7, 1.0, -0.5, 1.3, 0.9][:rows], np.float32)
    top_k = np.array([0, 0, 5, 3, 1000, 1][:rows], np.int32)  # 0, > C
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 0.8, 1.0][:rows], np.float32)
    gumbel = rng.gumbel(size=(rows, c)).astype(np.float32)
    return logits, temp, top_k, top_p, gumbel


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_sample_plain_matches_reference_and_pallas(seed):
    args = _sample_case(seed)
    got = ops.fused_sample(*[_t(a) for a in args]).numpy()
    jargs = [jnp.asarray(a) for a in args]
    want = np.asarray(jref.sample_ref(*jargs))
    pallas = np.asarray(jops.fused_sample(*jargs, impl="interpret"))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, pallas)
    logits, temp = args[0], args[1]
    greedy = temp <= 0
    np.testing.assert_array_equal(got[greedy],
                                  logits[greedy].argmax(-1))
