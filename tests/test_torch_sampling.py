"""The port's sampling against the JAX package's, bit for bit.

`repro_torch.runtime.sampling.gumbel_noise` rebuilds, in torch integer
ops, the noise the reference draws per row and step
(``jax.random.gumbel(fold_in(PRNGKey(seed), step), (C,), float32)``);
it must be bit-equal, or seeded streams could not match.  Then
`sample_tokens` must pick the reference's token on the same logits.
Tokens and noise are compared exactly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.sampling import sample_tokens as jax_sample_tokens
from repro_torch.runtime.sampling import (gumbel_noise, sample_tokens,
                                          threefry2x32, xla_log)


def _jax_noise(seeds, steps, cands):
    def one(s, i):
        key = jax.random.fold_in(jax.random.PRNGKey(s), i)
        return jax.random.gumbel(key, (cands,), jnp.float32)
    return np.asarray(jax.vmap(one)(jnp.asarray(seeds), jnp.asarray(steps)))


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("cands", [64, 7])
def test_gumbel_noise_is_bit_equal_to_jax(cands):
    rng = np.random.default_rng(cands)
    seeds = rng.integers(-2 ** 31, 2 ** 31 - 1, 512).astype(np.int32)
    steps = rng.integers(0, 4096, 512).astype(np.int32)
    seeds[:4] = [0, -1, 2 ** 31 - 1, -2 ** 31]      # edge seeds
    steps[:4] = [0, 2 ** 31 - 1, 1, 0]
    got = gumbel_noise(torch.from_numpy(seeds), torch.from_numpy(steps),
                       cands)
    np.testing.assert_array_equal(_bits(got.numpy()),
                                  _bits(_jax_noise(seeds, steps, cands)))


def test_fold_in_is_threefry_of_the_step():
    """fold_in(PRNGKey(s), i) == threefry2x32((0, s), (0, i))."""
    seeds = np.array([0, 5, 123456789], np.int32)
    steps = np.array([0, 9, 77], np.int32)
    for s, i in zip(seeds, steps):
        want = np.asarray(jax.random.key_data(jax.random.fold_in(
            jax.random.PRNGKey(s), i))).astype(np.int64)
        zero = torch.zeros((), dtype=torch.int64)
        k1, k2 = threefry2x32(zero, torch.tensor(int(s) & 0xFFFFFFFF), zero,
                              torch.tensor(int(i)))
        assert [int(k1), int(k2)] == [int(w) & 0xFFFFFFFF for w in want]


def test_xla_log_is_bit_equal_to_jax_log():
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.uniform(1e-30, 1.0, 4096),
                        rng.uniform(1.0, 50.0, 1024),
                        [np.finfo(np.float32).tiny, 1.0,
                         np.nextafter(np.float32(1), 0)]]).astype(np.float32)
    got = xla_log(torch.from_numpy(x)).numpy()
    want = np.asarray(jnp.log(jnp.asarray(x)))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("seed", [0, 1])
def test_sample_tokens_match_reference(seed):
    rng = np.random.default_rng(seed)
    b, v = 8, 256
    logits = (2 * rng.standard_normal((b, v))).astype(np.float32)
    logits[2, 40:44] = logits[2].max() + 1          # a tie at the top
    temp = np.array([0.0, 0.6, 1.0, 1.5, 0.9, 0.0, 2.0, 0.3], np.float32)
    top_k = np.array([0, 0, 10, 0, 1, 3, 500, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.5, 1.0, 1.0, 0.95, 1.0], np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, b).astype(np.int32)
    steps = rng.integers(0, 64, b).astype(np.int32)
    args = dict(temperature=temp, top_k=top_k, top_p=top_p, seed=seeds,
                step=steps)
    got = sample_tokens(torch.from_numpy(logits),
                        **{k: torch.from_numpy(a) for k, a in args.items()})
    want = jax_sample_tokens(jnp.asarray(logits),
                             **{k: jnp.asarray(a) for k, a in args.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32


def test_sampled_row_is_independent_of_its_batch():
    """A row's token depends on its own seed and step only."""
    rng = np.random.default_rng(3)
    logits = torch.from_numpy(rng.standard_normal((4, 256)).astype(
        np.float32))
    kw = dict(temperature=torch.full((4,), 0.8),
              top_k=torch.zeros(4, dtype=torch.int32),
              top_p=torch.ones(4), seed=torch.tensor([7, 8, 9, 10],
                                                     dtype=torch.int32),
              step=torch.tensor([2, 2, 5, 0], dtype=torch.int32))
    full = sample_tokens(logits, **kw)
    for i in range(4):
        one = sample_tokens(logits[i:i + 1],
                            **{k: t[i:i + 1] for k, t in kw.items()})
        assert int(one[0]) == int(full[i])
