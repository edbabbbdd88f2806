"""What the port's sampling and norm wrappers decide from shapes alone,
read on the CPU: the sampling kernel's plan (cluster size, slice length,
shared memory) and its refusal of a slice that does not fit one block,
the norm's choice of body by row width, and that bf16 logits, which the
serve path now hands to the sampler as the LM head writes them, give the
JAX package's tokens on the same values as f32."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.runtime.sampling import sample_tokens as jax_sample_tokens
from repro_torch.kernels import layernorm, sampling
from repro_torch.runtime.sampling import sample_tokens

#: keys and positions (6 bytes a value) + two 256-bin histograms + 64
#: candidates (value, index, sorted value, sorted index, noise)
_HIST_AND_CANDS = 2 * 256 * 4 + 64 * 20


@pytest.mark.parametrize("vocab,slice_len", [
    (300, 40), (5000, 632), (92544, 11568), (151936, 18992),
    (256000, 32000)])
def test_sample_plan_covers_the_row_in_aligned_slices(vocab, slice_len):
    plan = sampling.sample_plan(8, vocab, 64)
    assert plan == (8, 8, slice_len, slice_len * 6 + _HIST_AND_CANDS)
    assert plan.slice_len % 8 == 0                # 16-byte aligned slices
    assert plan.cluster * plan.slice_len >= vocab
    assert (plan.cluster - 1) * plan.slice_len < vocab
    assert plan.smem_bytes <= sampling.SMEM_LIMIT


@pytest.mark.parametrize("cands,pow2", [(1, 1), (16, 16), (64, 64),
                                        (65, 128), (1024, 1024)])
def test_sample_plan_pads_candidates_to_a_power_of_two(cands, pow2):
    plan = sampling.sample_plan(1, 92544, cands)
    assert plan.smem_bytes == 11568 * 6 + 2 * 256 * 4 + pow2 * 20


@pytest.mark.parametrize("vocab", [500000, 1 << 20])
def test_sample_plan_refuses_a_slice_that_does_not_fit(vocab):
    with pytest.raises(ValueError, match="more than one block holds"):
        sampling.sample_plan(8, vocab, 64)


def test_sample_plan_is_fixed_by_shapes_alone():
    a = sampling.sample_plan(1, 92544, 64)
    b = sampling.sample_plan(8, 92544, 64)
    assert a[1:] == b[1:]


@pytest.mark.parametrize("cols,dtype,plan", [
    (64, torch.float32, (32, 1)),       # the smoke model's width
    (296, torch.float32, (128, 1)),
    (1024, torch.bfloat16, (128, 1)),
    (2048, torch.bfloat16, (256, 1)),   # InternLM2-1.8B on the serve path
    (2048, torch.float32, (512, 1)),
    (2056, torch.bfloat16, (512, 1)),
    (4096, torch.float32, (512, 2)),
    (6144, torch.float32, (512, 4)),
    (12288, torch.bfloat16, (512, 4)),
    (12288, torch.float32, (512, 6)),
])
def test_norm_plan_picks_the_body_by_width(cols, dtype, plan):
    got = layernorm.norm_plan(cols, dtype)
    assert got == plan
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    assert got.threads * got.vectors * vec >= cols


@pytest.mark.parametrize("cols,dtype", [(0, torch.float32),
                                        (2050, torch.float32),
                                        (12 * 1024 + 8, torch.bfloat16)])
def test_norm_plan_refuses_widths_outside_the_build(cols, dtype):
    with pytest.raises(ValueError, match="must be a multiple"):
        layernorm.norm_plan(cols, dtype)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_on_bf16_logits_match_reference(seed):
    """bf16 logits with many exact ties (3 * N(0, 1) has 128 bf16 values
    an octave), through the port's plain path, against the JAX package's
    `sample_tokens` on the same values as f32."""
    rng = np.random.default_rng(seed)
    b, v = 8, 2000
    logits = torch.from_numpy(
        (3 * rng.standard_normal((b, v))).astype(np.float32)).bfloat16()
    logits[3, :] = float("-inf")                # fewer than C finite
    logits[3, rng.choice(v, 10, replace=False)] = 1.0
    temp = np.array([0.0, 0.6, 1.0, 0.9, 0.9, 0.0, 2.0, 0.3], np.float32)
    top_k = np.array([0, 0, 10, 0, 1, 3, 500, 0], np.int32)
    top_p = np.array([1.0, 0.9, 1.0, 0.95, 1.0, 1.0, 0.95, 1.0], np.float32)
    seeds = rng.integers(0, 2 ** 31 - 1, b).astype(np.int32)
    steps = rng.integers(0, 64, b).astype(np.int32)
    args = dict(temperature=temp, top_k=top_k, top_p=top_p, seed=seeds,
                step=steps)
    got = sample_tokens(logits,
                        **{k: torch.from_numpy(a) for k, a in args.items()})
    want = jax_sample_tokens(jnp.asarray(logits.float().numpy()),
                             **{k: jnp.asarray(a) for k, a in args.items()})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got.dtype == torch.int32
