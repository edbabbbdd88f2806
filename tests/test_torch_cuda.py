"""The port's Hopper kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one (the kernels
have no CPU mode); the file imports torch and numpy only, so it runs on a
machine with a card and no JAX:

    PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py

Inputs are f32 unless a test says otherwise; the kernels and the plain
versions then differ only in summation order, hence the 1e-4 tolerances
(1e-5 for the softmax, whose rows are short sums of values below 1).
Sampling is compared token for token on shared noise.
"""
import weakref

import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda_lib, ops, ref


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the Hopper kernels have no CPU "
                    "mode")
    return torch.device("cuda")


def _gen(dev, seed=0):
    return torch.Generator(device=dev).manual_seed(seed)


def _norm_inputs(dev, rows, cols, dtype, seed=0):
    g = _gen(dev, seed)
    x = torch.randn((rows, cols), generator=g, device=dev).to(dtype)
    res = torch.randn((rows, cols), generator=g, device=dev).to(dtype)
    bias = torch.randn((cols,), generator=g, device=dev).to(dtype)
    gamma = (torch.rand((cols,), generator=g, device=dev) + 0.5).to(dtype)
    beta = torch.randn((cols,), generator=g, device=dev).to(dtype)
    return x, res, bias, gamma, beta


def _norm(rms, x, res, bias, gamma, beta, fn=ops):
    if rms:
        return fn.fused_rmsnorm(x, gamma, bias, res, return_residual=True)
    return fn.fused_layernorm(x, gamma, beta, bias, res,
                              return_residual=True)


# 2048: a block of 256 (bf16) or 512 (f32) threads a row, a vector each;
# 64: a warp a row, half its lanes idle; 4096 and 12288: 2 to 6 vectors a
# thread
@pytest.mark.parametrize("cols", [2048, 64, 4096, 12288])
@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_norm_matches_plain(cuda, rms, dtype, cols):
    x, res, bias, gamma, beta = _norm_inputs(cuda, 64, cols, dtype)
    # bf16 output: one ulp at |y| <= 8 is 3e-2
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == torch.float32 \
        else dict(rtol=2e-2, atol=3e-2)
    y, s = _norm(rms, x, res, bias, gamma, beta)
    if rms:
        y_ref, s_ref = ref.rmsnorm_ref(x, gamma, bias, res,
                                       return_residual=True)
    else:
        y_ref, s_ref = ref.layernorm_ref(x, gamma, beta, bias, res,
                                         return_residual=True)
    torch.testing.assert_close(y, y_ref, **tol)
    torch.testing.assert_close(s, s_ref, rtol=0, atol=0)


@pytest.mark.parametrize("rms", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_norm_row_alone_equals_row_in_batch(cuda, rms, dtype):
    """A row's bits do not depend on R: each row of a batch of 8192 (a B 8
    x 1024 prefill) equals the same row normalised alone."""
    x, res, bias, gamma, beta = _norm_inputs(cuda, 8192, 2048, dtype,
                                             seed=4)
    y, s = _norm(rms, x, res, bias, gamma, beta)
    for i in (0, 1, 4097, 8191):
        y1, s1 = _norm(rms, x[i:i + 1], res[i:i + 1], bias, gamma, beta)
        assert torch.equal(y1[0], y[i]) and torch.equal(s1[0], s[i]), i


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 100)])
def test_cuda_flash_attention_matches_plain(cuda, causal, sq, sk):
    g = _gen(cuda)
    q = torch.randn((2, 8, sq, 128), generator=g, device=cuda)
    k = torch.randn((2, 4, sk, 128), generator=g, device=cuda)
    v = torch.randn((2, 4, sk, 128), generator=g, device=cuda)
    lengths = torch.tensor([sk, sk - 20], dtype=torch.int32, device=cuda)
    got = ops.flash_attention(q, k, v, lengths, causal=causal)
    want = ref.flash_attention_ref(q, k, v, lengths, causal)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cuda_flash_attention_reads_strided_layout(cuda):
    g = _gen(cuda)
    q = torch.randn((2, 70, 16, 128), generator=g, device=cuda)
    k = torch.randn((2, 70, 8, 128), generator=g, device=cuda)
    v = torch.randn((2, 70, 8, 128), generator=g, device=cuda)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2))
    want = ops.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous())
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# bf16 runs the tensor-core body.  The kernel rounds the unnormalised
# probabilities to bf16 before P.V and divides by their f32 sum after, the
# plain version rounds the normalised weights, and both round the output
# to bf16: they sit a bf16 ulp or two apart (an ulp is 1.6e-2 at
# |x| in [2, 4)), hence 2e-2, the tolerance chip_smoke.py holds them to.
BF16_ATTN_TOL = dict(rtol=2e-2, atol=2e-2)


def _bf16_attention(dev, b, h, kv, sq, sk, seed=0):
    g = _gen(dev, seed)
    return [torch.randn(shape, generator=g, device=dev).bfloat16()
            for shape in ((b, h, sq, 128), (b, kv, sk, 128),
                          (b, kv, sk, 128))]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 100), (1024, 1024)])
def test_cuda_flash_attention_bf16_matches_plain(cuda, causal, sq, sk):
    """H/KV = 2 and ragged lengths, one of them 0 (that row gives 0)."""
    q, k, v = _bf16_attention(cuda, 3, 8, 4, sq, sk)
    lengths = torch.tensor([sk, sk - 20, 0], dtype=torch.int32, device=cuda)
    got = ops.flash_attention(q, k, v, lengths, causal=causal)
    want = ref.flash_attention_ref(q, k, v, lengths, causal)
    assert not bool(got[2].any())
    torch.testing.assert_close(got, want, **BF16_ATTN_TOL)


@pytest.mark.parametrize("sq,sk", [(256, 1293), (512, 3584)])
def test_cuda_flash_attention_bf16_suffix_alignment(cuda, sq, sk):
    """Queries as the last Sq of Sk keys, as a suffix prefill after Sk - Sq
    cached tokens gives them: at an offset off the 64-key tile (1037) and
    on it (3072), with the full width's 16 heads over 8 KV heads.  Each
    call counts as one suffix-aligned launch."""
    q, k, v = _bf16_attention(cuda, 2, 16, 8, sq, sk, seed=5)
    cuda_lib.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True)
    assert cuda_lib.LAUNCH_SHAPES[("flash_attention", "suffix")] == 1
    want = ref.flash_attention_ref(q, k, v, None, True)
    torch.testing.assert_close(got, want, **BF16_ATTN_TOL)


@pytest.mark.parametrize("h,kv", [(8, 8), (8, 2), (6, 2)])
def test_cuda_flash_attention_bf16_gqa_groups(cuda, h, kv):
    """Groups of 1, 4 and 3 query heads per KV head (query head h reads
    KV head h / (H / KV))."""
    q, k, v = _bf16_attention(cuda, 2, h, kv, 200, 200, seed=h * kv)
    lengths = torch.tensor([200, 131], dtype=torch.int32, device=cuda)
    got = ops.flash_attention(q, k, v, lengths)
    want = ref.flash_attention_ref(q, k, v, lengths)
    torch.testing.assert_close(got, want, **BF16_ATTN_TOL)


def test_cuda_flash_attention_bf16_reads_strided_layout(cuda):
    g = _gen(cuda)
    q, k, v = [torch.randn((2, 70, n, 128), generator=g,
                           device=cuda).bfloat16() for n in (16, 8, 8)]
    lengths = torch.tensor([70, 45], dtype=torch.int32, device=cuda)
    got = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), lengths)
    want = ops.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(), lengths)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_cuda_flash_attention_bf16_row_is_batch_invariant(cuda):
    """A row computed inside a batch of 8 equals the same row alone, bit
    for bit: the serve path's greedy streams are held against generate()
    alone."""
    g = _gen(cuda, 3)
    q, k, v = [torch.randn((8, 300, n, 128), generator=g,
                           device=cuda).bfloat16().transpose(1, 2)
               for n in (16, 8, 8)]
    lengths = torch.tensor([300, 1, 257, 64, 0, 299, 128, 200],
                           dtype=torch.int32, device=cuda)
    full = ops.flash_attention(q, k, v, lengths)
    for i in range(8):
        alone = ops.flash_attention(q[i:i + 1], k[i:i + 1], v[i:i + 1],
                                    lengths[i:i + 1])
        assert torch.equal(full[i:i + 1], alone), i


def test_cuda_flash_attention_bf16_refuses_misaligned_rows(cuda):
    """The tensor-core body copies 16-byte chunks: a row that does not
    start on 16 bytes is refused (no fallback to another body)."""
    q, k, v = _bf16_attention(cuda, 1, 2, 1, 16, 16)
    buf = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(q.shape)
    shifted.copy_(q)
    cuda_lib.reset_launches()
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.flash_attention(shifted, k, v)
    assert cuda_lib.LAUNCHES["flash_attention"] == 0


# ---------------------------------------------------------------------------
# flash attention, packed mode (segment ids and positions)
# ---------------------------------------------------------------------------

#: (fresh lengths, prefix lengths, pack width, prefix width): eight
#: tile-aligned segments of 1024; mixed lengths with a one-token segment,
#: boundaries inside tiles and padding (whole padding tiles at the end);
#: segments after 128, 256 and no prefix keys, the prefix region padded
PACKED_CASES = {
    "8x1024": ((1024,) * 8, (0,) * 8, 8192, 0),
    "mixed": ((1, 64, 200, 333, 512, 700, 960, 1024), (0,) * 8, 4096, 0),
    "prefix": ((300, 500, 700), (128, 256, 0), 2048, 512),
}


def _packed(dev, fresh, prefix, width, pre_width, h=16, kv=8, seed=0):
    """bf16 q (1, H, width, 128) and k, v (1, KV, pre_width + width, 128)
    as strided views of (1, S, heads, 128) activations, and the segment
    ids and positions (q_seg, k_seg, q_pos, k_pos) of the pack."""
    from repro_torch.runtime.engine import segment_labels
    q_seg, q_pos = segment_labels(fresh, prefix, width)
    p_seg, p_pos = segment_labels(prefix, [0] * len(prefix), pre_width)
    ids = [torch.from_numpy(a).to(dev) for a in
           (q_seg, np.concatenate([p_seg, q_seg]), q_pos,
            np.concatenate([p_pos, q_pos]))]
    g = _gen(dev, seed)
    q, k, v = [torch.randn((1, n, heads, 128), generator=g,
                           device=dev).bfloat16().transpose(1, 2)
               for n, heads in ((width, h), (pre_width + width, kv),
                                (pre_width + width, kv))]
    return q, k, v, ids


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_cuda_flash_attention_packed_matches_plain(cuda, case):
    """The packed mode against its plain version on real rows; every
    padding row finite, and a query tile of padding only exactly 0."""
    q, k, v, ids = _packed(cuda, *PACKED_CASES[case])
    cuda_lib.reset_launches()
    got = ops.flash_attention_packed(q, k, v, *ids)
    assert cuda_lib.LAUNCHES["flash_attention_packed"] == 1
    want = ref.flash_attention_packed_ref(q, k, v, *ids)
    real = ids[0] >= 0
    torch.testing.assert_close(got[:, :, real], want[:, :, real],
                               **BF16_ATTN_TOL)
    assert bool(torch.isfinite(got.float()).all())
    flat = int(real.sum())
    tail = (flat + 63) // 64 * 64           # first tile of padding only
    assert not bool(got[:, :, tail:].any())


def test_cuda_flash_attention_packed_segment_alone_equals_segment_in_pack(
        cuda):
    """A segment starting on a 64-key tile boundary gives the same bits in
    a pack as packed alone, and as the causal kernel on it alone: the same
    tiles are visited and masked alike (an extra visited tile adds exact
    zeros).  A segment starting inside a tile agrees with itself alone
    within the bf16 tolerance only: its keys fall into other tiles, so the
    online softmax groups its sums otherwise."""
    fresh = (256, 100, 192, 64)           # starts 0, 256, 356, 548
    q, k, v, ids = _packed(cuda, fresh, (0,) * 4, 640, 0, seed=9)
    full = ops.flash_attention_packed(q, k, v, *ids)
    at = 0
    for n in fresh:
        rows = slice(at, at + n)
        width = (n + 63) // 64 * 64
        one = torch.zeros(width, dtype=torch.int32, device=cuda)
        one[n:] = -1
        pos = torch.arange(width, dtype=torch.int32, device=cuda)
        pos[n:] = 0
        qa, ka, va = [torch.zeros((1, width, t.shape[1], 128),
                                  dtype=t.dtype, device=cuda)
                      for t in (q, k, v)]
        for dst, src in ((qa, q), (ka, k), (va, v)):
            dst[:, :n] = src[:, :, rows].transpose(1, 2)
        qa, ka, va = qa.transpose(1, 2), ka.transpose(1, 2), \
            va.transpose(1, 2)
        alone = ops.flash_attention_packed(qa, ka, va, one, one, pos, pos)
        if at % 64 == 0:
            assert torch.equal(full[:, :, rows], alone[:, :, :n]), at
            causal = ops.flash_attention(q[:, :, rows], k[:, :, rows],
                                         v[:, :, rows], causal=True)
            assert torch.equal(full[:, :, rows], causal), at
        else:
            torch.testing.assert_close(full[:, :, rows], alone[:, :, :n],
                                       **BF16_ATTN_TOL)
        at += n


def _random_ids(dev, seed, sq_max=700, extra=400):
    """Ids and positions drawn one by one (the fresh keys the queries'),
    no segment structure: (q_seg, k_seg, q_pos, k_pos)."""
    rng = np.random.default_rng(seed)
    sq = int(rng.integers(1, sq_max + 1))
    sk = sq + int(rng.integers(0, extra + 1))
    q_seg = rng.integers(-2, 5, sq).astype(np.int32)
    q_pos = rng.integers(0, 90, sq).astype(np.int32)
    k_seg = rng.integers(-2, 5, sk).astype(np.int32)
    k_pos = rng.integers(0, 90, sk).astype(np.int32)
    k_seg[sk - sq:], k_pos[sk - sq:] = q_seg, q_pos
    return [torch.from_numpy(a).to(dev) for a in (q_seg, k_seg, q_pos,
                                                  k_pos)]


@pytest.mark.parametrize("case", sorted(PACKED_CASES) +
                         [f"random{i}" for i in range(6)])
def test_cuda_packed_plan_equals_plain_plan(cuda, case):
    """The plan kernel writes the plain plan entry for entry: the count,
    the visited tiles in ascending order with their masked flags, -1
    after; one launch."""
    if case.startswith("random"):
        ids = _random_ids(cuda, int(case[6:]))
    else:
        ids = _packed(cuda, *PACKED_CASES[case])[3]
    cuda_lib.reset_launches()
    got = ops.flash_attention_packed_plan(*ids)
    assert cuda_lib.LAUNCHES["flash_attention_packed_plan"] == 1
    want = ref.flash_attention_packed_plan_ref(*ids)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", sorted(PACKED_CASES))
def test_cuda_packed_attention_with_a_given_plan_equals_its_own(cuda, case):
    """Attention over a plan built before gives the same bits as the call
    that builds its own (one plan launch and one attention launch)."""
    q, k, v, ids = _packed(cuda, *PACKED_CASES[case])
    plan = ops.flash_attention_packed_plan(*ids)
    cuda_lib.reset_launches()
    own = ops.flash_attention_packed(q, k, v, *ids)
    assert cuda_lib.LAUNCHES["flash_attention_packed_plan"] == 1
    given = ops.flash_attention_packed(q, k, v, *ids, plan=plan)
    assert cuda_lib.LAUNCHES["flash_attention_packed_plan"] == 1
    assert cuda_lib.LAUNCHES["flash_attention_packed"] == 2
    assert torch.equal(own, given)


@pytest.mark.parametrize("heads", [(3, 1), (8, 8), (6, 2)])
def test_cuda_packed_attention_any_group_matches_plain(cuda, heads):
    """A block serves two query heads of one KV head: groups of one, of
    three (the last block of a group with one head) and of three pairs
    against the plain version, on random ids and positions too."""
    h, kv = heads
    for ids in (_packed(cuda, (30, 1, 100, 64, 50), (0,) * 5, 320, 0)[3],
                _random_ids(cuda, h * 10 + kv)):
        sq, sk = ids[0].numel(), ids[1].numel()
        g = _gen(cuda, h)
        q, k, v = [torch.randn((1, n, m, 128), generator=g,
                               device=cuda).bfloat16().transpose(1, 2)
                   for n, m in ((sq, h), (sk, kv), (sk, kv))]
        got = ops.flash_attention_packed(q, k, v, *ids)
        want = ref.flash_attention_packed_ref(q, k, v, *ids)
        real = ids[0] >= 0
        torch.testing.assert_close(got[:, :, real], want[:, :, real],
                                   **BF16_ATTN_TOL)


def test_cuda_flash_attention_packed_refuses_f32_and_misaligned_rows(cuda):
    """The packed mode is built for bf16 only, and copies 16-byte chunks:
    f32 and a row that does not start on 16 bytes are refused, with no
    launch and no fallback."""
    q, k, v, ids = _packed(cuda, (40, 24), (0, 0), 64, 0, h=2, kv=1)
    cuda_lib.reset_launches()
    with pytest.raises(ValueError, match="bfloat16"):
        ops.flash_attention_packed(q.float(), k.float(), v.float(), *ids)
    qc = q.contiguous()
    buf = torch.zeros(qc.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = buf[1:].view(qc.shape)
    shifted.copy_(qc)
    with pytest.raises(RuntimeError, match="CUDA error"):
        ops.flash_attention_packed(shifted, k, v, *ids)
    assert cuda_lib.LAUNCHES["flash_attention_packed"] == 0


def _paged(dev, b=8, h=16, kv=8, dh=128, bs=16, mb=16, seed=5):
    rng = np.random.default_rng(seed)
    nb = b * mb + 1
    lengths = rng.integers(1, mb * bs + 1, b).astype(np.int32)
    lengths[0] = 1
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, mb), np.int32)
    used = 0
    for i, ln in enumerate(lengths):
        n = -(-int(ln) // bs)
        tables[i, :n] = perm[used:used + n]
        used += n
    kp = rng.standard_normal((nb, bs, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kv, dh)).astype(np.float32)
    kp[0] = vp[0] = np.nan                       # unwritten trash block
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    return [torch.from_numpy(a).to(dev)
            for a in (q, kp, vp, tables, lengths)]


@pytest.mark.parametrize("h,kv", [(16, 8), (8, 8), (32, 4), (16, 4)])
def test_cuda_paged_decode_matches_plain(cuda, h, kv):
    q, kp, vp, tables, lengths = _paged(cuda, h=h, kv=kv)
    got = ops.flash_decode_paged(q, kp, vp, tables, lengths)
    # the plain version gathers whole blocks, trash included: give it a
    # finite trash block (the kernel never reads it)
    kp[0] = vp[0] = 0
    want = ref.flash_decode_paged_ref(q, kp, vp, tables, lengths)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _sample_args(dev, logits, seed=0):
    """Per-row parameters cycling through a sampled row, a greedy one, a
    sampled row with a large top-k and a negative temperature (greedy),
    with noise from numpy."""
    rows, _ = logits.shape
    cands = min(64, logits.shape[1])
    rng = np.random.default_rng(seed)
    temp = np.resize(np.array([0.7, 0.0, 1.3, -1.0], np.float32), rows)
    top_k = np.resize(np.array([0, 5, 1000, 3], np.int32), rows)
    top_p = np.resize(np.array([0.9, 1.0, 0.8, 0.5], np.float32), rows)
    gumbel = rng.gumbel(size=(rows, cands)).astype(np.float32)
    return [logits.to(dev)] + [torch.from_numpy(a).to(dev)
                               for a in (temp, top_k, top_p, gumbel)]


def _all_sampled(args):
    """The same inputs with every row sampled at temperature 1."""
    return [args[0], torch.ones_like(args[1])] + args[2:]


# V 1001 and 12: the cluster of 8 does not divide the row, and the rows
# do not allow 16-byte loads; V 12 is below one vector a block
@pytest.mark.parametrize("rows,vocab,cands", [(8, 92544, 64), (3, 300, 16),
                                              (1, 5000, 64), (4, 1001, 64),
                                              (2, 12, 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sample_matches_plain(cuda, rows, vocab, cands, dtype):
    rng = np.random.default_rng(vocab)
    logits = (3 * rng.standard_normal((rows, vocab))).astype(np.float32)
    logits[0, 1:5] = logits[0].max() + 1         # ties at the top
    args = _sample_args(cuda, torch.from_numpy(logits).to(dtype), vocab)
    args[4] = args[4][:, :cands].contiguous()
    got = ops.fused_sample(*args)
    want = ref.sample_ref(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sample_ties_straddle_rank_c(cuda, dtype):
    """The C-th rank falls inside a run of equal values spread over every
    block of the cluster: the lower indices are kept, as the stable sort
    of the plain version keeps them.  Row 1 ties from rank 41 to 100 at
    one value; row 0's scaled values tie after the division too."""
    rng = np.random.default_rng(7)
    v = 92544
    logits = (3 * rng.standard_normal((4, v))).astype(np.float32)
    spread = rng.permutation(v)
    logits[1, spread[:40]] = 30.0
    logits[1, spread[40:100]] = 25.0
    logits[0, spread[:200]] = 20.0
    args = _all_sampled(_sample_args(cuda, torch.from_numpy(logits).to(
        dtype)))
    args[2] = torch.zeros_like(args[2])          # no top-k: all 64 kept
    args[3] = torch.ones_like(args[3])
    torch.testing.assert_close(ops.fused_sample(*args),
                               ref.sample_ref(*args), rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sample_row_with_fewer_finite_values_than_c(cuda, dtype):
    rng = np.random.default_rng(8)
    v = 92544
    logits = np.full((3, v), -np.inf, np.float32)
    for r, n in enumerate((20, 1, 63)):
        logits[r, rng.choice(v, n, replace=False)] = rng.standard_normal(n)
    args = _all_sampled(_sample_args(cuda, torch.from_numpy(logits).to(
        dtype)))
    torch.testing.assert_close(ops.fused_sample(*args),
                               ref.sample_ref(*args), rtol=0, atol=0)


def test_cuda_sample_is_one_launch_per_call(cuda):
    """One kernel per call, greedy and sampled rows alike, and no other
    device work (no scratch to clear)."""
    from torch.profiler import ProfilerActivity, profile
    rng = np.random.default_rng(9)
    logits = torch.from_numpy((3 * rng.standard_normal((8, 92544))).astype(
        np.float32)).bfloat16()
    args = _sample_args(cuda, logits)
    ops.fused_sample(*args)
    torch.cuda.synchronize()
    calls = 5
    for _ in range(2):         # the trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                ops.fused_sample(*args)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        if names:
            break
    assert len(names) == calls, names
    assert all("sample_kernel" in n for n in names), names


def test_cuda_sample_repeated_calls_give_same_tokens(cuda):
    rng = np.random.default_rng(10)
    logits = torch.from_numpy((3 * rng.standard_normal((8, 92544))).astype(
        np.float32)).bfloat16()
    args = _all_sampled(_sample_args(cuda, logits))
    first = ops.fused_sample(*args)
    for _ in range(50):
        assert torch.equal(ops.fused_sample(*args), first)
    torch.testing.assert_close(first, ref.sample_ref(*args), rtol=0, atol=0)


def test_cuda_paged_decode_clamps_lengths_past_the_table(cuda):
    """A length above MB * BS reads the row's whole table and nothing past
    it, as the plain version does: the last row's overrun would leave the
    tables' buffer, the first row's would reach the next row's table."""
    rng = np.random.default_rng(9)
    b, h, kv, dh, bs, mb = 3, 16, 8, 128, 16, 4
    nb = b * mb + 1
    tables = (rng.permutation(np.arange(1, nb)).reshape(b, mb)
              .astype(np.int32))
    lengths = np.array([mb * bs + 5, 7, 4 * mb * bs], np.int32)
    kp = rng.standard_normal((nb, bs, kv, dh)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, kv, dh)).astype(np.float32)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    args = [torch.from_numpy(a).to(cuda)
            for a in (q, kp, vp, tables, lengths)]
    got = ops.flash_decode_paged(*args)
    want = ref.flash_decode_paged_ref(*args)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def test_cuda_kernels_count_launches(cuda):
    q, kp, vp, tables, lengths = _paged(cuda, b=2, mb=4)
    cuda_lib.reset_launches()
    ops.flash_decode_paged(q, kp, vp, tables, lengths)
    ops.flash_decode_paged(q, kp, vp, tables, lengths)
    assert cuda_lib.LAUNCHES["flash_decode_paged"] == 2


def test_cuda_serving_matches_generate_alone(cuda):
    """Smoke-depth model at the full head dim (the kernels are built for
    dh = 128) on the card, in f32 over the per-group prefill (the packed
    mode is bf16 only: test_cuda_packed_serving_one_launch_per_layer_per_
    pack): continuous batching with mid-decode arrivals equals
    ``generate`` of each prompt alone, every kernel of the path launches,
    and nothing leaks."""
    import dataclasses

    from repro_torch.api import GenerationParams, TurboClient
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), d_head=128)
    engine = InferenceEngine(
        cfg, init_params(cfg, device=cuda),
        ladder=BucketLadder(seq_buckets=(32, 64, 128), batch_buckets=(4,)),
        device=cuda)
    client = TurboClient(ContinuousEngine(engine, max_slots=4, cap_new=16,
                                          packed_prefill=False))
    rng = np.random.default_rng(0)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (5, 40, 17, 60, 9, 33)]
    cuda_lib.reset_launches()
    handles = [client.submit(p, GenerationParams(max_new_tokens=12))
               for p in prompts[:4]]
    client.pump(max_ticks=3)
    handles.append(client.submit(prompts[4], GenerationParams(
        max_new_tokens=12, temperature=0.8, seed=3)))
    handles.append(client.submit(prompts[5],
                                 GenerationParams(max_new_tokens=12)))
    results = [h.result() for h in handles]
    for name in ("norm", "flash_attention", "flash_decode_paged", "sample"):
        assert cuda_lib.LAUNCHES[name] > 0, name
    for i in (0, 1, 2, 3, 5):
        alone = engine.generate([prompts[i]], max_new_tokens=12)[0]
        assert alone == results[i]
    assert client.backend.block_table.used_blocks == 0
    assert engine.kv_slab.live_bytes == 0


def test_cuda_packed_serving_one_launch_per_layer_per_pack(cuda):
    """The default (packed) admission path at the smoke depth in bf16 with
    the full head dim: every admission group is one packed dispatch, one
    plan launch and one packed-mode flash launch per layer and none of
    the causal one, no leak; and each prompt's last-token logits from one packed pass agree
    with its own prefill within a few bf16 ulps (the products run at
    other shapes and round otherwise)."""
    import dataclasses

    from repro_torch.api import GenerationParams, TurboClient
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params, prefill
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), d_head=128,
                              dtype="bfloat16")
    engine = InferenceEngine(
        cfg, init_params(cfg, device=cuda),
        ladder=BucketLadder(seq_buckets=(64, 128), batch_buckets=(4,)),
        device=cuda)
    ce = ContinuousEngine(engine, max_slots=4, cap_new=16)
    client = TurboClient(ce)
    rng = np.random.default_rng(2)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (5, 40, 17, 60, 9, 100)]
    cuda_lib.reset_launches()
    handles = [client.submit(p, GenerationParams(max_new_tokens=12))
               for p in prompts[:4]]
    client.pump(max_ticks=3)
    handles += [client.submit(p, GenerationParams(max_new_tokens=12))
                for p in prompts[4:]]
    results = [h.result() for h in handles]
    assert ce.pack_dispatches == ce.prefill_dispatches > 0
    assert cuda_lib.LAUNCHES["flash_attention_packed"] == \
        cfg.num_layers * ce.pack_dispatches
    assert cuda_lib.LAUNCHES["flash_attention_packed_plan"] == \
        ce.pack_dispatches
    assert cuda_lib.LAUNCHES["flash_attention"] == 0
    assert all(len(r) == len(p) + 12 for r, p in zip(results, prompts))
    assert ce.block_table.used_blocks == 0
    assert engine.kv_slab.live_bytes == 0
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, 128),
                        device=cuda)
    no_ids = torch.zeros((0,), dtype=torch.int32, device=cuda)
    logits, _ = engine.prefill_packed_flat(prompts[:4], [0] * 4, no_kv,
                                           no_kv, no_ids, no_ids)
    for i, p in enumerate(prompts[:4]):
        alone, _ = prefill(cfg, engine.params,
                           torch.tensor([p], device=cuda))
        torch.testing.assert_close(logits[i].float(), alone[0].float(),
                                   rtol=2e-2, atol=5e-2)


# ---------------------------------------------------------------------------
# masked softmax
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("cols", [1024, 512, 300, 7])
def test_cuda_softmax_matches_plain(cuda, dtype, cols):
    """Ragged lengths with empty rows and lengths past C, at the widest
    row the kernel takes (1024) and widths off the 16-byte path; columns
    past each length are exact zeros."""
    rng = np.random.default_rng(cols)
    rows = 300
    x = torch.from_numpy(
        (4 * rng.standard_normal((rows, cols))).astype(np.float32))
    lengths = rng.integers(-2, 2 * cols + 2, rows).astype(np.int32)
    lengths[:4] = [0, cols, cols + 1, 1]
    x, lens = x.to(cuda, dtype), torch.from_numpy(lengths).to(cuda)
    got = ops.fused_softmax(x, lens, scale=0.3)
    want = ref.softmax_ref(x, lens, 0.3)
    tol = dict(rtol=1e-5, atol=1e-6) if dtype == torch.float32 \
        else dict(rtol=8e-3, atol=1e-6)       # one bf16 ulp
    torch.testing.assert_close(got, want, **tol)
    past = torch.arange(cols, device=cuda)[None, :] >= lens[:, None]
    assert bool((got[past] == 0).all()) and bool(torch.isfinite(got).all())


def test_cuda_softmax_without_lengths_matches_plain(cuda):
    x = torch.randn((4096, 128), generator=_gen(cuda), device=cuda)
    torch.testing.assert_close(ops.fused_softmax(x), ref.softmax_ref(x),
                               rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# contiguous decode
# ---------------------------------------------------------------------------

def _contiguous(dev, b=6, h=16, kv=8, s=300, seed=3):
    """q, a strided (B, KV, S, dh) view of a (B, S, KV, dh) cache whose
    positions past each length are NaN, the same view with a zero tail,
    and the lengths."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, s + 1, b).astype(np.int32)
    lengths[0], lengths[-1] = 1, s
    kc = rng.standard_normal((b, s, kv, 128)).astype(np.float32)
    vc = rng.standard_normal((b, s, kv, 128)).astype(np.float32)
    past = np.arange(s)[None, :] >= lengths[:, None]
    kz, vz = kc.copy(), vc.copy()
    kz[past] = vz[past] = 0
    kc[past] = vc[past] = np.nan
    q = rng.standard_normal((b, h, 128)).astype(np.float32)
    t = [torch.from_numpy(a).to(dev) for a in (q, kc, vc, kz, vz, lengths)]
    q, kc, vc, kz, vz, lens = t
    return (q, kc.transpose(1, 2), vc.transpose(1, 2), kz.transpose(1, 2),
            vz.transpose(1, 2), lens)


@pytest.mark.parametrize("h,kv", [(16, 8), (8, 8), (32, 4), (16, 4)])
def test_cuda_contiguous_decode_matches_plain(cuda, h, kv):
    q, k, v, kz, vz, lens = _contiguous(cuda, h=h, kv=kv)
    assert not k.is_contiguous()
    got = ops.flash_decode(q, k, v, lens)
    want = ref.flash_decode_ref(q, kz, vz, lens)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    over = torch.full_like(lens, 10 ** 6)          # past S: all of it
    torch.testing.assert_close(ops.flash_decode(q, kz, vz, over),
                               ref.flash_decode_ref(q, kz, vz, over),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
def test_cuda_contiguous_decode_is_bit_equal_to_paged(cuda, qdtype):
    """The same keys laid into a pool (row r owns blocks 1 + r * MB, in
    order) give the same bits: both kernels split at 128 keys and merge
    in the same order."""
    b, s, bs = 6, 512, 16
    q, k, v, _, _, lens = _contiguous(cuda, b=b, s=s)
    q = q.to(qdtype)
    mb = s // bs

    def pool(x):
        rows = x.transpose(1, 2).reshape(b * mb, bs, 8, 128)
        return torch.cat([torch.zeros_like(rows[:1]), rows])
    tables = (1 + torch.arange(b * mb, dtype=torch.int32, device=cuda)
              ).reshape(b, mb)
    got = ops.flash_decode(q, k, v, lens)
    paged = ops.flash_decode_paged(q, pool(k), pool(v), tables, lens)
    assert torch.equal(got, paged)


def test_cuda_kernels_refuse_shapes_outside_the_built_set(cuda):
    x = torch.randn((4, 1025), device=cuda)
    with pytest.raises(ValueError, match="1 to 1024"):
        ops.fused_softmax(x)
    with pytest.raises(ValueError, match="unsupported dtype"):
        ops.fused_softmax(x[:, :64].half())
    q, k, v, _, _, lens = _contiguous(cuda, b=2, s=40)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_decode(q[..., :64], k[..., :64], v[..., :64], lens)
    with pytest.raises(ValueError, match="H/KV"):
        ops.flash_decode(q[:, :12], k[:, :2], v[:, :2], lens)   # group 6
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.flash_decode(q.half(), k, v, lens)
    with pytest.raises(ValueError, match="one layout"):
        ops.flash_decode(q, k, v.contiguous(), lens)


def test_cuda_contiguous_serving_matches_generate_alone(cuda):
    """The contiguous slot cache on the card: greedy streams equal
    ``generate`` alone (which decodes through the paged kernel), and every
    decode tick launches the contiguous kernel once per layer, as does
    the eager tick that warms each first-use capture of the tick's
    graph."""
    import dataclasses

    from repro_torch.api import GenerationParams, TurboClient
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), d_head=128)
    engine = InferenceEngine(
        cfg, init_params(cfg, device=cuda),
        ladder=BucketLadder(seq_buckets=(32, 64, 128), batch_buckets=(4,)),
        device=cuda)
    ce = ContinuousEngine(engine, max_slots=4, cap_new=16,
                          kv_layout="contiguous")
    client = TurboClient(ce)
    rng = np.random.default_rng(1)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (5, 40, 17, 60, 9, 100)]
    cuda_lib.reset_launches()
    handles = [client.submit(p, GenerationParams(max_new_tokens=12))
               for p in prompts[:4]]
    client.pump(max_ticks=3)
    handles += [client.submit(p, GenerationParams(max_new_tokens=12))
                for p in prompts[4:]]
    results = [h.result() for h in handles]
    assert cuda_lib.LAUNCHES["flash_decode"] == \
        cfg.num_layers * (ce.decode_ticks + ce.tick_cells.warm_ticks)
    assert cuda_lib.LAUNCHES["flash_decode_paged"] == 0
    for prompt, res in zip(prompts, results):
        assert engine.generate([prompt], max_new_tokens=12)[0] == res
    assert engine.kv_slab.live_bytes == 0


# ---------------------------------------------------------------------------
# decode: the edges of the staged key tiles and of the splits, and the
# split merge inside the launch
# ---------------------------------------------------------------------------

#: lengths at the edges of a 32-key tile, a 16-key pool block and a
#: 128-key split, and the empty row
EDGE_LENGTHS = (0, 1, 15, 16, 17, 127, 128, 129, 1024)


def _decode_rows(dev, lengths, group, qdtype, seed=11, s=1024, kv=8,
                 bs=16, dh=128):
    """q of H = KV * group heads; a (B, S, KV, dh) cache NaN past each
    length, seen as the kernel's strided (B, KV, S, dh) view; the same
    view with a zero tail for the plain version; the same keys in a pool
    (row r owns blocks 1 + r * S / BS, in order, block 0 NaN) with its
    tables; the lengths."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    lens = np.asarray(lengths, np.int32)
    kc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    vc = rng.standard_normal((b, s, kv, dh)).astype(np.float32)
    past = np.arange(s)[None, :] >= lens[:, None]
    kz, vz = kc.copy(), vc.copy()
    kz[past] = vz[past] = 0
    kc[past] = vc[past] = np.nan
    q = rng.standard_normal((b, kv * group, dh)).astype(np.float32)
    q, kc, vc, kz, vz, lens = [torch.from_numpy(a).to(dev)
                               for a in (q, kc, vc, kz, vz, lens)]
    mb = s // bs

    def pool(x):
        blocks = x.reshape(b * mb, bs, kv, dh)
        return torch.cat([torch.full_like(blocks[:1], float("nan")),
                          blocks])
    tables = (1 + torch.arange(b * mb, dtype=torch.int32, device=dev)
              ).reshape(b, mb)
    return dict(q=q.to(qdtype), k=kc.transpose(1, 2), v=vc.transpose(1, 2),
                kz=kz.transpose(1, 2), vz=vz.transpose(1, 2),
                k_pool=pool(kc), v_pool=pool(vc), tables=tables, lens=lens)


def _decode(layout, d, rows=slice(None)):
    """The layout's kernel on the rows ``rows`` of ``_decode_rows`` (q,
    tables and lengths copied, as the wrappers take 16-byte-aligned
    data; the cache stays a strided view)."""
    q, lens = d["q"][rows].clone(), d["lens"][rows].clone()
    if layout == "paged":
        return ops.flash_decode_paged(q, d["k_pool"], d["v_pool"],
                                      d["tables"][rows].clone(), lens)
    return ops.flash_decode(q, d["k"][rows], d["v"][rows], lens)


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 2, 4, 8])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_edge_lengths_match_plain(cuda, layout, group, qdtype):
    d = _decode_rows(cuda, EDGE_LENGTHS, group, qdtype)
    got = _decode(layout, d)
    want = ref.flash_decode_ref(d["q"], d["kz"], d["vz"], d["lens"])
    assert bool((got[0] == 0).all())               # the empty row
    # bf16 q: the plain version rounds the softmax weights to bf16 and
    # both round the output, a few of its ulps (as chip_smoke.py states)
    tol = dict(rtol=1e-4, atol=1e-4) if qdtype == torch.float32 \
        else dict(rtol=4e-3, atol=4e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_row_alone_equals_row_in_batch(cuda, layout):
    """A row's splits, tiles and merge order depend on its keys only, so
    it gives the same bits alone and in a batch of 8."""
    d = _decode_rows(cuda, (1, 17, 128, 129, 300, 777, 1000, 1024), 2,
                     torch.bfloat16)
    batch = _decode(layout, d)
    for r in range(8):
        assert torch.equal(_decode(layout, d, slice(r, r + 1))[0], batch[r])


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_repeated_calls_give_same_bits(cuda, layout):
    """The last block of a (row, KV head) resets its ticket, so 50 calls
    in a row merge the same way and leave the tickets at 0."""
    from repro_torch.kernels import flash_decode
    d = _decode_rows(cuda, (1, 129, 500, 1024, 1024, 640), 2, torch.float32)
    first = _decode(layout, d)
    for _ in range(50):
        assert torch.equal(_decode(layout, d), first)
    torch.cuda.synchronize()
    for buf in flash_decode._TICKETS.values():
        assert int(buf.abs().sum()) == 0


#: CUgraphNodeType's kernel node (cuda.h)
CU_GRAPH_NODE_TYPE_KERNEL = 0


def _graph_node_types(graph) -> list:
    """The type of every node of a captured graph (kept with
    ``keep_graph=True``), read through the driver API: cuGraphGetNodes,
    then cuGraphNodeGetType a node."""
    import ctypes
    drv = ctypes.CDLL("libcuda.so.1")
    handle = ctypes.c_void_p(int(graph.raw_cuda_graph()))
    n = ctypes.c_size_t(0)
    assert drv.cuGraphGetNodes(handle, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert drv.cuGraphGetNodes(handle, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes[:n.value]:
        kind = ctypes.c_int(-1)
        assert drv.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_is_one_launch_per_call(cuda, layout):
    """Splits are merged inside the launch: one device kernel per call.
    ``calls`` calls captured into one CUDA graph make exactly ``calls``
    nodes, every one a kernel node (the wrapper copies, fills and
    allocates nothing on the device); the launch counter rises by
    ``calls`` and the replay gives the eager calls' bits."""
    d = _decode_rows(cuda, (1, 300, 1024), 2, torch.bfloat16)
    q, lens = d["q"].clone(), d["lens"].clone()

    def call():
        if layout == "paged":
            return ops.flash_decode_paged(q, d["k_pool"], d["v_pool"],
                                          d["tables"], lens)
        return ops.flash_decode(q, d["k"], d["v"], lens)
    want = call()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        call()                 # the capture stream's merge tickets
    torch.cuda.synchronize()
    calls = 5
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with cuda_lib.recording() as rec:
        with torch.cuda.graph(graph, stream=stream):
            outs = [call() for _ in range(calls)]
    name = "flash_decode_paged" if layout == "paged" else "flash_decode"
    assert sum(rec.values()) == calls and \
        sum(n for (w, _), n in rec.items() if w == name) == calls, rec
    types = _graph_node_types(graph)
    assert types == [CU_GRAPH_NODE_TYPE_KERNEL] * calls, types
    cuda_lib.reset_launches()
    graph.replay()
    cuda_lib.add_launches(rec)
    torch.cuda.synchronize()
    assert cuda_lib.LAUNCHES == {name: calls}
    for out in outs:
        assert torch.equal(out, want)


def test_cuda_cow_copy_then_decode_write_keeps_the_cached_block(cuda):
    """The prefix cache on the card (smoke depth at the full head dim, f32,
    per-group prefill): a prompt whose partial tail block is donated to
    the cache copies that block before its first decode write, and a
    second prompt diverging inside the cached tail copies it at
    admission.  The cached block's bytes are the same after both
    requests' decode writes, and both streams equal ``generate`` of the
    prompt alone."""
    import dataclasses

    from repro_torch.api import GenerationParams, TurboClient
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
    cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"), d_head=128)
    engine = InferenceEngine(
        cfg, init_params(cfg, device=cuda),
        ladder=BucketLadder(seq_buckets=(32, 64, 128), batch_buckets=(4,)),
        device=cuda)
    ce = ContinuousEngine(engine, max_slots=4, cap_new=16,
                          packed_prefill=False, prefix_cache=True)
    client = TurboClient(ce)
    p1 = list(range(1, 21))                  # a block and 4 tokens
    h1 = client.submit(p1, GenerationParams(max_new_tokens=8))
    client.pump(max_ticks=1)                 # prefill: the tail is donated
    tail = ce.block_table.block_table(h1.req_id)[1]
    assert ce.block_table.ref_count(tail) == 2
    before = {key: ce.state.cache[key][:, tail].clone()
              for key in ("k", "v")}
    r1 = h1.result()
    assert ce.cow_blocks == 1                # the first decode write
    p2 = p1[:18] + [99, 98, 97]              # diverges inside the tail
    r2 = client.submit(p2, GenerationParams(max_new_tokens=8)).result()
    assert ce.cow_blocks >= 2                # the admission's copy
    for key in ("k", "v"):
        assert torch.equal(ce.state.cache[key][:, tail], before[key])
    assert r1 == engine.generate([p1], max_new_tokens=8)[0]
    assert r2 == engine.generate([p2], max_new_tokens=8)[0]
    btm = ce.block_table
    assert btm.used_blocks == ce.prefix_cache.cached_blocks


# ---------------------------------------------------------------------------
# the decode tick as CUDA graphs: replays against the eager tick
# ---------------------------------------------------------------------------

def _graph_engine(dev, arch="internlm2-1.8b", **kw):
    """Smoke depth at the full head dim, f32, per-group prefill (the
    packed mode is bf16 only), 4 slots."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
    cfg = dataclasses.replace(get_smoke_config(arch), d_head=128)
    engine = InferenceEngine(
        cfg, init_params(cfg, device=dev),
        ladder=BucketLadder(seq_buckets=(32, 64, 128), batch_buckets=(4,)),
        device=dev)
    return ContinuousEngine(engine, max_slots=4, cap_new=24,
                            packed_prefill=False, **kw)


def _clone_state(state):
    from repro_torch.runtime.engine import GenState
    from repro_torch.runtime.graphs import CONTROL
    return GenState(cache={k: v.clone() for k, v in state.cache.items()},
                    **{n: getattr(state, n).clone() for n in CONTROL},
                    sampling=state.sampling)


def _check_every_replay(ce):
    """Hold every tick's replay against ``decode_step_batch`` on a copy
    of the state, bit for bit; returns the list of ticks seen as
    (sampling, slot cache positions, captured)."""
    cells, eng = ce.tick_cells, ce.engine
    real = cells.run
    seen = []

    def checked(state):
        # the paged pool's trash block takes the KV writes of every free
        # or finished row, several rows to one slot, in no fixed order:
        # it is never read, and left out
        kv = slice(1, None) if "block_tables" in state.cache \
            else slice(None)
        want = eng.decode_step_batch(_clone_state(state))
        captured = real(state)
        assert torch.equal(state.cache["len"], want.cache["len"])
        # every state leaf: k/v, or an SSM model's conv window, scan
        # state and shared KV
        for key in [k for k in state.cache
                    if k not in ("len", "pos_offset", "block_tables")]:
            rows = kv if key in ("k", "v") else slice(None)
            assert torch.equal(state.cache[key][:, rows],
                               want.cache[key][:, rows]), \
                f"tick {len(seen)}: the graph's cache {key} differs"
        for name in ("cur", "emitted", "counts", "done"):
            assert torch.equal(getattr(state, name), getattr(want, name)), \
                f"tick {len(seen)}: the graph's {name} differs"
        seen.append((state.sampling, ce.max_len, captured))
        return captured

    cells.run = checked
    return seen


def _graph_workload(rng, sampled, n=10, first_len=None):
    from repro_torch.api import GenerationParams
    shared = [(7 * i) % 200 + 3 for i in range(20)]   # a block and 4
    out = []
    for i in range(n):
        if i % 3 == 0:
            prompt = shared + [int(t) for t in rng.integers(1, 256, 1 + i)]
        else:
            prompt = [int(t) for t in rng.integers(1, 256,
                                                   int(rng.integers(2, 30)))]
        budget = int(rng.integers(14, 25))
        if first_len is not None and i < 4:
            prompt = prompt[:first_len // 2]
            budget = min(budget, first_len - len(prompt))
        out.append((prompt, GenerationParams(
            max_new_tokens=budget,
            temperature=0.9 if sampled and i % 2 else 0.0,
            top_k=20, top_p=0.9, seed=500 + i)))
    return out


@pytest.mark.parametrize("arch,layout,sampled", [
    ("internlm2-1.8b", "paged", False), ("internlm2-1.8b", "paged", True),
    ("internlm2-1.8b", "contiguous", False), ("olmoe-1b-7b", "paged", False),
    ("olmoe-1b-7b", "paged", True)])
def test_cuda_graph_tick_is_bit_equal_to_the_eager_tick(cuda, arch, layout,
                                                        sampled):
    """Served with cells captured by ``warmup_aot``: every tick's replay
    leaves the state bit-equal to ``decode_step_batch`` on a copy of it,
    over admissions, finishes, block appends and copy-on-write (the paged
    layout with the prefix cache) between ticks; no cell is captured
    while serving.  The MoE tick (qk-norm, routing, dispatch, combine)
    too."""
    from repro_torch.api import TurboClient
    kw = dict(prefix_cache=True) if layout == "paged" \
        else dict(kv_layout="contiguous")
    ce = _graph_engine(cuda, arch, **kw)
    client = TurboClient(ce, warmup=True)
    assert len(ce.tick_cells) == 2 == ce.tick_cells.captures
    assert client.warmup_stats["compile_count"] == \
        2 + ce.engine.prefill_cells.captures
    seen = _check_every_replay(ce)
    work = _graph_workload(np.random.default_rng(20 + sampled), sampled)
    handles = [client.submit(p, g) for p, g in work[:4]]
    client.pump(max_ticks=4)
    handles += [client.submit(p, g) for p, g in work[4:]]
    results = [h.result() for h in handles]
    assert len(seen) >= 32
    assert not any(c for _, _, c in seen)
    # tick cells, and the prefill cells of the warm-up and of serving (a
    # cache hit's suffix cell is keyed by its exact cached length)
    assert ce.tick_cells.captures == 2
    assert ce.engine.compile_count == 2 + ce.engine.prefill_cells.captures
    assert any(s for s, _, _ in seen) == sampled
    if layout == "paged":
        assert ce.cow_blocks > 0
    assert [len(r) for r in results] == \
        [len(p) + g.max_new_tokens for p, g in work]


def test_cuda_graph_contiguous_grow_recaptures_its_cell(cuda):
    """The contiguous slot cache at 64 positions grows to the 128 bucket
    when a long prompt arrives mid-decode: both cells captured on the old
    cache are dropped, the next tick captures its cell anew (counted in
    ``compile_count``), and every replay stays bit-equal to the eager
    tick."""
    from repro_torch.api import GenerationParams, TurboClient
    ce = _graph_engine(cuda, kv_layout="contiguous", max_len=64)
    client = TurboClient(ce, warmup=True)
    assert ce.max_len == 64 and len(ce.tick_cells) == 2
    seen = _check_every_replay(ce)
    rng = np.random.default_rng(23)
    work = _graph_workload(rng, False, n=6, first_len=64)
    handles = [client.submit(p, g) for p, g in work[:4]]
    client.pump(max_ticks=4)
    long_prompt = [int(t) for t in rng.integers(1, 256, 80)]
    handles.append(client.submit(long_prompt,
                                 GenerationParams(max_new_tokens=20)))
    handles += [client.submit(p, g) for p, g in work[4:]]
    results = [h.result() for h in handles]
    assert ce.max_len == 128
    grew = [i for i, (_, n, _) in enumerate(seen) if n == 128]
    assert grew and seen[grew[0]][2] and not any(
        c for i, (_, _, c) in enumerate(seen) if i != grew[0])
    assert ce.tick_cells.captures == 3 and len(ce.tick_cells) == 1
    assert ce.engine.compile_count == 3 + ce.engine.prefill_cells.captures
    assert results[4] == ce.engine.generate([long_prompt],
                                            max_new_tokens=20)[0]


def test_cuda_graph_replays_count_one_eager_tick_each(cuda):
    """N replays add N times what one eager tick of the same state
    launches, by wrapper; the merge tickets the cells launch with are
    still the capture stream's buffer, never reallocated, and zero."""
    from repro_torch.kernels import flash_decode
    ce = _graph_engine(cuda)
    ce.warmup_aot()
    cells = ce.tick_cells
    key = (ce.state.cur.device, cells._stream.cuda_stream)
    tickets = flash_decode._TICKETS[key]
    for sampling in (False, True):
        ce.state.sampling = sampling
        cuda_lib.reset_launches()
        ce.engine.decode_step_inplace(_clone_state(ce.state))
        eager = dict(cuda_lib.LAUNCHES)
        cuda_lib.reset_launches()
        for _ in range(5):
            assert not cells.run(ce.state)
        assert dict(cuda_lib.LAUNCHES) == {k: 5 * v for k, v in
                                           eager.items()}
        assert eager["sample" if sampling else "norm"] > 0
    torch.cuda.synchronize()
    cell, _, _ = cells.cell(ce.state)
    assert flash_decode._TICKETS[key] is tickets
    assert cell.tickets.data_ptr() == tickets.data_ptr()
    assert int(tickets.abs().sum()) == 0


def test_cuda_tickets_too_few_under_capture_raise(cuda):
    """A capture whose stream has no merge tickets reserved raises; it
    does not allocate them inside the graph."""
    from repro_torch.kernels import flash_decode
    q, kp, vp, tables, lengths = _paged(cuda, b=2, mb=4)
    stream = torch.cuda.Stream()
    # PyTorch hands out streams from a pool, so this one may be a stream
    # an earlier capture (a tick graph of generate or of a backend)
    # reserved tickets on: start from none reserved
    flash_decode._TICKETS.pop((q.device, stream.cuda_stream), None)
    graph = torch.cuda.CUDAGraph()
    with pytest.raises(RuntimeError, match="merge tickets"):
        with cuda_lib.recording():
            with torch.cuda.graph(graph, stream=stream):
                ops.flash_decode_paged(q, kp, vp, tables, lengths)
    assert (q.device, stream.cuda_stream) not in flash_decode._TICKETS


# ---------------------------------------------------------------------------
# the classify and prefill cells as CUDA graphs: replays against the eager
# bodies, the outputs' lifetime, stale keys, the memory they hold
# ---------------------------------------------------------------------------

def _cell_engine(dev, cfg=None, **ladder):
    """Smoke depth at the full head dim in bf16 (the packed mode's
    dtype)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import InferenceEngine
    if cfg is None:
        cfg = dataclasses.replace(get_smoke_config("internlm2-1.8b"),
                                  d_head=128, dtype="bfloat16")
    ladder = ladder or dict(seq_buckets=(32, 64, 128),
                            batch_buckets=(1, 2, 4))
    return InferenceEngine(cfg, init_params(cfg, device=dev),
                           ladder=BucketLadder(**ladder), device=dev)


CELL_KINDS = ("classify", "per_group", "suffix", "packed")


def _cell_call(engine, kind, seed, table):
    """One call of ``kind``'s entry point (through ``table``, or the
    eager public body with ``table`` None) on prompts drawn from
    ``seed``: returns what the call returned."""
    cfg = engine.cfg
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (50, 27, 90)]
    if kind == "classify":
        return engine._classify(prompts, table)
    if kind == "per_group":
        return engine._prefill_batch(prompts, table, max_len=128,
                                     max_new_tokens=2)
    shape = (cfg.num_layers, 3, 21, cfg.num_kv_heads, cfg.head_dim)
    gen = _gen(engine.device, seed)
    pk = torch.randn(shape, generator=gen, device=engine.device)
    pv = torch.randn(shape, generator=gen, device=engine.device)
    if kind == "suffix":
        return engine._prefill_suffix_batch(
            prompts, table, prefix_k=pk, prefix_v=pv, prefix_len=21,
            max_new_tokens=2)
    # three segments after 7 cached tokens each: 21 prefix keys
    seg = np.repeat(np.arange(3, dtype=np.int32), 7)
    pos = np.tile(np.arange(7, dtype=np.int32), 3)
    return engine._prefill_packed_flat(prompts, [7, 7, 7], table,
                                       pk[:, 0], pv[:, 0], seg, pos)


def _cell_outputs(engine, fn):
    """The outputs of the one cell call ``fn`` makes, copied."""
    seen = []
    real = engine._run_cell

    def spy(*args):
        outs = real(*args)
        seen.append({k: v.clone() for k, v in outs.items()})
        return outs

    engine._run_cell = spy
    try:
        fn()
    finally:
        del engine._run_cell
    assert len(seen) == 1
    return seen[0]


def _same(a, b):
    return set(a) == set(b) and all(torch.equal(a[k], b[k]) for k in a)


def _moe_cell_cfg():
    import dataclasses

    from repro_torch.configs import get_smoke_config
    return dataclasses.replace(get_smoke_config("olmoe-1b-7b"), d_head=128,
                               dtype="bfloat16")


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "olmoe-1b-7b"])
@pytest.mark.parametrize("kind", CELL_KINDS)
def test_cuda_cell_replay_is_bit_equal_to_the_eager_body(cuda, kind, arch):
    """The first call of a key (the eager body on the capture stream)
    and every replay after it give the eager public body's logits and KV
    bit for bit, on other inputs between them too; the key is captured
    once, counted in ``compile_count``, and each replay adds the launches
    its capture recorded.  The MoE cells too."""
    engine = _cell_engine(cuda, _moe_cell_cfg() if arch == "olmoe-1b-7b"
                          else None)
    table = engine.classify_cells if kind == "classify" \
        else engine.prefill_cells
    want = [_cell_outputs(engine, lambda s=s: _cell_call(engine, kind, s,
                                                          None))
            for s in (0, 1)]
    cuda_lib.reset_launches()
    first = _cell_outputs(engine, lambda: _cell_call(engine, kind, 0, table))
    eager_launches = dict(cuda_lib.LAUNCHES)
    assert _same(first, want[0])
    assert table.captures == 1 == engine.compile_count == len(table)
    for seed in (1, 0, 1):
        cuda_lib.reset_launches()
        got = _cell_outputs(engine, lambda s=seed: _cell_call(
            engine, kind, s, table))
        assert _same(got, want[seed]), seed
        assert dict(cuda_lib.LAUNCHES) == eager_launches
    assert table.captures == 1 == engine.compile_count
    assert table.calls[table.keys()[0]] == 4


@pytest.mark.parametrize("kind", CELL_KINDS)
def test_cuda_public_result_outlives_later_calls(cuda, kind):
    """A public method's result is its own: later calls through the cell
    and the public method, on other inputs, leave it as it was.  The
    cell's own outputs are the next call's (valid until then)."""
    engine = _cell_engine(cuda)
    table = engine.classify_cells if kind == "classify" \
        else engine.prefill_cells

    def tensors(out):
        if kind == "classify":
            return {"logits": out}
        if kind == "packed":
            return {"logits": out[0], **out[1]}
        return {"cur": out.cur, **out.cache}

    kept = tensors(_cell_call(engine, kind, 0, None))
    copies = {k: v.clone() for k, v in kept.items()}
    graphed = tensors(_cell_call(engine, kind, 0, table))
    graphed_copy = {k: v.clone() for k, v in graphed.items()}
    for seed in (1, 2):
        _cell_call(engine, kind, seed, table)
        _cell_call(engine, kind, seed, None)
    assert _same(kept, copies)
    names = [k for k in graphed if k in ("logits", "k", "v")]
    assert any(not torch.equal(graphed[k], graphed_copy[k]) for k in names)


def test_cuda_cell_refuses_stale_weights_and_other_shapes(cuda):
    """A captured cell raises where the engine's weights are not those it
    was captured on, and where an input's shape or dtype differs from
    the one the key was made with; nothing runs eagerly instead."""
    from repro_torch.runtime.graphs import CellArena, CellTable
    engine = _cell_engine(cuda)
    _cell_call(engine, "classify", 0, engine.classify_cells)
    engine.params = {k: (v if k != "final_norm" else
                         {n: t.clone() for n, t in v.items()})
                     for k, v in engine.params.items()}
    cuda_lib.reset_launches()
    with pytest.raises(RuntimeError, match="stale cell"):
        _cell_call(engine, "classify", 0, engine.classify_cells)
    assert not cuda_lib.LAUNCHES

    table = CellTable(CellArena(cuda), lambda: ())

    def body(ins, outs):
        outs["y"].copy_(ins["x"] * 2)

    out = table.run("k", body, {"x": np.arange(4, dtype=np.float32)},
                    {"y": ((4,), torch.float32)})
    assert out["y"].tolist() == [0.0, 2.0, 4.0, 6.0]
    out = table.run("k", body, {"x": np.ones(4, np.float32)},
                    {"y": ((4,), torch.float32)})
    assert out["y"].tolist() == [2.0] * 4
    with pytest.raises(ValueError, match="differ from those"):
        table.run("k", body, {"x": np.ones(3, np.float32)},
                  {"y": ((4,), torch.float32)})
    with pytest.raises(ValueError, match="differ from those"):
        table.run("k", body, {"x": np.ones(4, np.float64)},
                  {"y": ((4,), torch.float32)})
    assert table.captures == 1


def test_cuda_cells_hold_memory_by_the_largest_cell(cuda):
    """After ``warmup_aot`` at full width (depth cut to 2 layers) over
    the serving ladder, the bytes the prefill cells hold (graph pool and
    static buffers) stay below four times the largest cell's static
    inputs and outputs plus twice what one eager run of that cell's
    body needs beyond them: a bound from the largest cell, whatever the
    number of cells."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.runtime.engine import ContinuousEngine
    cfg = dataclasses.replace(get_config("internlm2-1.8b"), num_layers=2)
    engine = _cell_engine(cuda, cfg, seq_buckets=(128, 256, 512, 1024),
                          batch_buckets=(1, 2, 4, 8))
    ce = ContinuousEngine(engine, max_slots=8, cap_new=64)
    stats = ce.warmup_aot()
    table, arena = engine.prefill_cells, engine.cell_arena
    sizes = table.static_bytes()
    assert stats["compile_count"] == 2 + len(sizes) and len(sizes) >= 8
    key = max(sizes, key=sizes.get)
    assert key[:2] == ("pack", 8192)
    # the largest cell's body run eagerly: its transient bytes
    zero = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads,
                        cfg.head_dim), device=cuda)
    ids = torch.zeros((0,), dtype=torch.int32, device=cuda)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(cuda)
    torch.cuda.reset_peak_memory_stats(cuda)
    out = engine.prefill_packed_flat([[1] * 1023] * 8, [0] * 8, zero, zero,
                                     ids, ids)
    torch.cuda.synchronize()
    eager = torch.cuda.max_memory_allocated(cuda) - base
    del out
    held = arena.pool_bytes() + arena.buffer_bytes()
    bound = 4 * sizes[key] + 2 * eager
    assert held <= bound, (held, arena.pool_bytes(), arena.buffer_bytes(),
                           sizes[key], eager, len(sizes))


def test_cuda_cells_capture_from_the_pump_thread(cuda):
    """With ``auto_pump="thread"`` the pump thread captures every prefill
    and tick cell it first meets, while the caller only waits; the greedy
    streams equal ``generate`` of each prompt alone (equal batch shapes,
    f32 per group)."""
    from repro_torch.api import GenerationParams, TurboClient
    ce = _graph_engine(cuda)
    eng = ce.engine
    rng = np.random.default_rng(31)
    prompts = [[int(t) for t in rng.integers(1, 256, n)]
               for n in (5, 40, 17, 60, 9, 100)]
    with TurboClient(ce, auto_pump="thread") as client:
        handles = [client.submit(p, GenerationParams(max_new_tokens=12))
                   for p in prompts]
        results = [h.result(timeout=120) for h in handles]
    assert eng.prefill_cells.captures > 0 and ce.tick_cells.captures > 0
    assert eng.compile_count == \
        eng.prefill_cells.captures + ce.tick_cells.captures
    for prompt, res in zip(prompts, results):
        assert eng.generate([prompt], max_new_tokens=12)[0] == res


def _as_meta(t):
    return tuple(t.shape), t.dtype, t.stride()


@pytest.mark.parametrize("case", ["softmax", "rmsnorm_residual",
                                  "layernorm", "flash_bf16"])
def test_cuda_traced_wrappers_allocate_as_the_kernels(cuda, case):
    """Each kernel wrapper traces to one custom-operator node whose fake
    outputs have the kernel's own shapes, dtypes and strides."""
    from repro_torch.core.usage_records import trace
    g = _gen(cuda)
    x = torch.randn((6, 256), generator=g, device=cuda)
    gamma = torch.ones(256, device=cuda)
    q = torch.randn((2, 4, 8, 128), generator=g, device=cuda).bfloat16()
    kv = torch.randn((2, 2, 8, 128), generator=g, device=cuda).bfloat16()
    lens = torch.full((6,), 100, dtype=torch.int32, device=cuda)
    name, args, kwargs = {
        "softmax": ("fused_softmax", (x, lens), {"scale": 0.5}),
        "rmsnorm_residual": ("fused_rmsnorm", (x, gamma, None, x * 2),
                             {"return_residual": True}),
        "layernorm": ("fused_layernorm", (x, gamma, gamma), {}),
        "flash_bf16": ("flash_attention", (q, kv, kv), {"causal": True}),
    }[case]
    want = getattr(ops, name)(*args, **kwargs)
    gm = trace(lambda *a: getattr(ops, name)(*a, **kwargs), *args)
    nodes = [n for n in gm.graph.nodes if n.op == "call_function"
             and "repro_torch" in str(n.target)]
    assert len(nodes) == 1
    got = nodes[0].meta["val"]
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, (tuple, list)) else (got,)
    assert [_as_meta(t) for t in got] == [_as_meta(t) for t in want]


def test_cuda_classify_records_equal_the_cpu_trace(cuda):
    """The smoke classify forward's usage records, traced with the weights
    on the card, equal those traced on the CPU: the CPU test sees the
    card's graph.  Tracing launches nothing."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import records_for_fn
    from repro_torch.models import init_params
    from repro_torch.models.transformer import forward_hidden, logits_at
    cfg = get_smoke_config("internlm2-1.8b")
    def classify_fn(params):
        def fwd(tokens, last):
            h, _ = forward_hidden(cfg, params, tokens, attn="naive")
            return logits_at(cfg, params, h, last)
        return fwd

    got = {}
    for dev in ("cpu", cuda):
        fwd = classify_fn(init_params(cfg, seed=0, device=dev))
        tokens = torch.ones((1, 45), dtype=torch.int32, device=dev)
        last = torch.tensor([44], dtype=torch.int32, device=dev)
        cuda_lib.reset_launches()
        got[str(dev)] = records_for_fn(fwd, tokens, last, min_size=1)
        assert not cuda_lib.LAUNCHES
    assert got["cpu"] == got[str(cuda)] and got["cpu"]


# ---------------------------------------------------------------------------
# the MoE layer at OLMoE-1B-7B's full width; captures beside garbage
# ---------------------------------------------------------------------------

def _olmoe_layer(dev, seed=0):
    """One MoE layer of full-width OLMoE-1B-7B (64 experts, top 8, d
    2048, f 1024) in bf16, its router f32, and 8 decode rows."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe as M
    cfg = get_config("olmoe-1b-7b")
    p = M.init_moe(cfg, _gen(dev, seed), torch.bfloat16, dev)
    x = torch.randn((8, 1, cfg.d_model), generator=_gen(dev, seed + 1),
                    device=dev).to(torch.bfloat16)
    return cfg, p, x


def test_cuda_moe_decode_row_alone_equals_row_in_batch(cuda):
    """At decode a row's MoE output does not depend on the batch: bucket
    1 and bucket 8 both give capacity 8, so the expert products run at
    one shape, and nothing drops; each of 8 rows alone is bit-equal to
    the same row in the batch."""
    from repro_torch.models import moe as M
    cfg, p, x = _olmoe_layer(cuda)
    assert M.expert_capacity(cfg, 1) == M.expert_capacity(cfg, 8) == 8
    batch, _ = M.apply_moe(cfg, p, x)
    for i in range(8):
        alone, _ = M.apply_moe(cfg, p, x[i:i + 1])
        assert torch.equal(alone[0], batch[i]), i


@pytest.mark.parametrize("tokens", [8, 1024])
def test_cuda_apply_moe_makes_no_host_sync(cuda, tokens):
    """``apply_moe`` at full width reads nothing back to the host (the
    sync debug mode raises on a sync), captures as a CUDA graph, and the
    replay equals the eager call bit for bit."""
    from repro_torch.models import moe as M
    cfg, p, _ = _olmoe_layer(cuda, seed=2)
    x = torch.randn((1, tokens, cfg.d_model), generator=_gen(cuda, 3),
                    device=cuda).to(torch.bfloat16)
    want, _ = M.apply_moe(cfg, p, x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        M.apply_moe(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        M.apply_moe(cfg, p, x)
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out, _ = M.apply_moe(cfg, p, x)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


class _Cycle:
    """A holder that refers to itself: only the cyclic collector frees
    it."""


def _graph_in_a_cycle_dropped(keep: list):
    """What a captured body does to reproduce the fault: the last
    reference to what ``keep`` holds (a captured graph, or an engine
    whose cells hold graphs) moves into a new reference cycle, which
    becomes garbage; container allocations follow, kept alive so each
    counts, any of which runs an automatic collection where the
    collector is on.  Returns a weak reference to the cycle and whether
    it outlived them."""
    holder = _Cycle()
    holder.held = keep.pop()
    holder.me = holder
    cycle = weakref.ref(holder)
    del holder
    grown = [[] for _ in range(200)]
    return cycle, cycle() is not None and len(grown) == 200


def _dropped_thing(dev, what):
    """A captured and replayed graph allocating in its private pool, or
    an engine whose classify cell is captured and replayed."""
    if what == "engine":
        engine = _cell_engine(dev)
        for _ in range(2):
            _cell_call(engine, "classify", 0, engine.classify_cells)
        torch.cuda.synchronize()
        return engine
    x = torch.arange(4, dtype=torch.float32, device=dev)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=side):
        y = x * 2
    torch.cuda.current_stream().wait_stream(side)
    graph.replay()
    torch.cuda.synchronize()
    del y
    return graph


@pytest.mark.parametrize("dropped", ["graph", "engine"])
@pytest.mark.parametrize("cell", ["prefill", "tick"])
def test_cuda_capture_survives_a_graph_in_a_garbage_cycle(cuda, cell,
                                                          dropped):
    """A captured body drops a captured graph (or an engine holding
    captured cells) into a garbage reference cycle, with the collector's
    thresholds at 1: the collector is held off during the capture, so
    nothing is collected (no graph destroyed) while the stream captures;
    the cell captures and replays right, and the cycle is collected
    after."""
    import dataclasses
    import gc

    from repro_torch.runtime import graphs
    keep = [_dropped_thing(cuda, dropped)]
    calls, cycles = [], []

    def body(ins, outs):
        calls.append(1)
        if len(calls) == 2:          # the captured call
            cycles.append(_graph_in_a_cycle_dropped(keep))
        outs["y"].copy_(ins["x"] * 2)

    thresholds = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        if cell == "prefill":
            table = graphs.CellTable(graphs.CellArena(cuda), lambda: ())
            spec = {"y": ((4,), torch.float32)}
            table.run("k", body, {"x": np.arange(4, dtype=np.float32)},
                      spec)
            out = table.run("k", body, {"x": np.ones(4, np.float32)}, spec)
            assert table.captures == 1
            assert out["y"].tolist() == [2.0] * 4
        else:
            @dataclasses.dataclass
            class State:
                cache: dict
                cur: torch.Tensor
                emitted: torch.Tensor
                counts: torch.Tensor
                done: torch.Tensor
                sampling: bool = False

            z = torch.zeros((2,), device=cuda)
            state = State({"k": torch.zeros((1, 1, 1, 2, 128), device=cuda),
                           "len": z.clone()}, z.clone(), z.clone(),
                          z.clone(), z.clone())
            ins = {"x": torch.ones(2, device=cuda)}
            ticks = graphs.TickCells(lambda st: body(ins, {"y": st.cur}))
            ticks._capture(state, ("tick",)).graph.replay()
            torch.cuda.synchronize()
            assert state.cur.tolist() == [2.0, 2.0]
    finally:
        gc.set_threshold(*thresholds)
    assert not keep and len(calls) == 2
    (cycle, survived), = cycles
    assert survived, "a collection ran inside the capture"
    gc.collect()
    assert cycle() is None


# ---------------------------------------------------------------------------
# the serving tier on the card: replicas, background warm-up, threads
# ---------------------------------------------------------------------------

def _alone(engine, prompts, params):
    return [engine.generate([p], max_new_tokens=g.max_new_tokens)[0]
            for p, g in zip(prompts, params)]


def _greedy_work(seed, n=8):
    from repro_torch.api import GenerationParams
    rng = np.random.default_rng(seed)
    prompts = [[int(t) for t in rng.integers(1, 256, int(k))]
               for k in rng.integers(3, 100, n)]
    return prompts, [GenerationParams(max_new_tokens=int(b))
                     for b in rng.integers(8, 24, n)]


def test_cuda_two_pumped_replicas_capture_while_the_other_serves(cuda):
    """Two thread-pumped replicas on one card, each over its own engine:
    replica 0 warmed (it serves from graphs and captures nothing), replica
    1 cold (its pump thread captures every cell at first use while
    replica 0 ticks).  Captures and the other thread's device calls are
    exclusive (`graphs.DEVICE_GATE`); every tick replay of both equals
    the eager tick bit for bit, and every greedy stream equals
    ``generate`` of its prompt alone."""
    from repro_torch.api import TurboClient
    from repro_torch.cluster import ReplicaPool
    from repro_torch.runtime import graphs
    warm, cold = _graph_engine(cuda), _graph_engine(cuda)
    clients = [TurboClient(warm, warmup=True, auto_pump="thread"),
               TurboClient(cold, auto_pump="thread")]
    warm_captures = warm.engine.compile_count
    seen = [_check_every_replay(ce) for ce in (warm, cold)]
    waited0 = graphs.DEVICE_GATE.captures_waited
    prompts, params = _greedy_work(41)
    with ReplicaPool(clients) as pool:
        handles = [pool.submit(p, g) for p, g in zip(prompts, params)]
        results = [h.result(timeout=300) for h in handles]
        placed = {h.replica for h in handles}
    assert placed == {0, 1}
    assert warm.engine.compile_count == warm_captures
    assert cold.engine.prefill_cells.captures > 0 and \
        cold.tick_cells.captures > 0
    assert len(seen[0]) > 0 and len(seen[1]) > 0
    assert not any(c for _, _, c in seen[0])
    assert results == _alone(warm.engine, prompts, params)
    print("captures that waited for the other replica:",
          graphs.DEVICE_GATE.captures_waited - waited0)


def test_cuda_background_warmup_while_serving(cuda):
    """``warmup="background"`` with a pump thread: four requests submitted
    before the warm-up ends are served (between its rounds, or after
    it), the warm-up ends with every round walked and no error, and every
    stream equals ``generate`` alone; every tick replay equals the eager
    tick."""
    from repro_torch.api import TurboClient
    ce = _graph_engine(cuda)
    seen = _check_every_replay(ce)
    prompts, params = _greedy_work(43, n=4)
    with TurboClient(ce, warmup="background", auto_pump="thread") as client:
        handles = [client.submit(p, g) for p, g in zip(prompts, params)]
        early = client.warmup_stats.get("rounds_completed")
        results = [h.result(timeout=300) for h in handles]
        stats = client.wait_warmup(timeout=300)
    assert stats["done"] and stats.get("error") is None
    assert stats["rounds_completed"] == stats["rounds"] > 0
    assert stats["compile_count"] > 0 and len(seen) > 0
    assert results == _alone(ce.engine, prompts, params)
    print("rounds done at the first submit:", early, "of", stats["rounds"])


def test_cuda_shared_engine_under_two_pump_threads(cuda):
    """Two thread-pumped backends over ONE InferenceEngine (as the JAX
    package's CLI builds its pool): the engine's lock holds each device
    call from its cells' input writes to the read of their outputs, so
    nothing is corrupted: every stream equals ``generate`` alone and
    every tick replay equals the eager tick."""
    from repro_torch.api import TurboClient
    from repro_torch.cluster import ReplicaPool
    from repro_torch.runtime.engine import ContinuousEngine
    first = _graph_engine(cuda)
    second = ContinuousEngine(first.engine, max_slots=4, cap_new=24,
                              packed_prefill=False)
    seen = [_check_every_replay(ce) for ce in (first, second)]
    prompts, params = _greedy_work(47, n=10)
    with ReplicaPool([TurboClient(ce, auto_pump="thread")
                      for ce in (first, second)]) as pool:
        handles = [pool.submit(p, g) for p, g in zip(prompts, params)]
        results = [h.result(timeout=300) for h in handles]
        assert {h.replica for h in handles} == {0, 1}
    assert len(seen[0]) > 0 and len(seen[1]) > 0
    assert results == _alone(first.engine, prompts, params)


def test_cuda_collector_hold_under_two_capturing_threads(cuda):
    """Two threads capture a cell each at once, each captured body
    dropping a captured graph into a garbage cycle, with the collector's
    thresholds at 1 and each thread's calls held as the engines hold
    them (`DEVICE_GATE.shared`): the captures take turns, no collection
    runs inside either, both cells replay right, and the collector is
    back on after the last."""
    import gc
    import threading
    import time

    from repro_torch.runtime import graphs
    keeps = [[_dropped_thing(cuda, "graph")] for _ in range(2)]
    cycles, outs, errors = [[], []], [None, None], []
    start = threading.Barrier(2)

    def worker(i):
        calls = []

        def body(ins, o):
            calls.append(1)
            if len(calls) == 2:          # the captured call
                cycles[i].append(_graph_in_a_cycle_dropped(keeps[i]))
                time.sleep(0.05)         # the other thread arrives
            o["y"].copy_(ins["x"] * (i + 2))

        try:
            table = graphs.CellTable(graphs.CellArena(cuda), lambda: ())
            spec = {"y": ((4,), torch.float32)}
            start.wait(5)
            for x in (np.arange(4, dtype=np.float32),
                      np.ones(4, np.float32)):
                with graphs.DEVICE_GATE.shared():
                    out = table.run("k", body, {"x": x}, spec)
                    outs[i] = out["y"].tolist()
            assert table.captures == 1 and len(calls) == 2
        except BaseException as e:       # reported by the main thread
            errors.append(e)

    thresholds = gc.get_threshold()
    waited0 = graphs.DEVICE_GATE.captures_waited
    gc.set_threshold(1, 1, 1)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
    finally:
        gc.set_threshold(*thresholds)
    assert not errors, errors
    assert outs == [[2.0] * 4, [3.0] * 4]
    assert gc.isenabled()
    print("captures that waited:",
          graphs.DEVICE_GATE.captures_waited - waited0)
    for (cycle, survived), in cycles:
        assert survived, "a collection ran inside a capture"
    gc.collect()
    assert all(c[0][0]() is None for c in cycles)


# ---------------------------------------------------------------------------
# the newer served models' shapes: decode at groups 7 and 12 (Qwen2-VL,
# StarCoder2) and at head dim 64 (MusicGen); the causal kernel at dh 64;
# the packed body at groups 7 and 12; the norm's LayerNorm mode at their
# widths; the sampler at Qwen2-VL's vocab
# ---------------------------------------------------------------------------

#: (group, head dim, KV heads) of the newer instantiations
MODEL_DECODE_SHAPES = ((7, 128, 4), (12, 128, 4), (1, 64, 32))


@pytest.mark.parametrize("qdtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group,dh,kv", MODEL_DECODE_SHAPES,
                         ids=["g7", "g12", "dh64"])
@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_model_groups_match_plain(cuda, layout, group, dh, kv,
                                              qdtype):
    """Both layouts at the edges of tiles, blocks and splits, counted at
    their instantiation's launch shape class, and the two layouts' bits
    equal on the same keys."""
    d = _decode_rows(cuda, EDGE_LENGTHS, group, qdtype, kv=kv, dh=dh)
    cuda_lib.reset_launches()
    got = _decode(layout, d)
    name = "flash_decode_paged" if layout == "paged" else "flash_decode"
    assert cuda_lib.LAUNCH_SHAPES[(name, f"g{group} dh{dh}")] == 1
    want = ref.flash_decode_ref(d["q"], d["kz"], d["vz"], d["lens"])
    assert bool((got[0] == 0).all())               # the empty row
    # bf16 q: both versions round the output to bf16 after rounding the
    # weights at other points, so an output may land one bf16 ulp away
    # (2**-7 relative), which 48 heads of values up to ~3 reach
    tol = dict(rtol=1e-4, atol=1e-4) if qdtype == torch.float32 \
        else dict(rtol=2 ** -7, atol=4e-3)
    torch.testing.assert_close(got.float(), want.float(), **tol)
    other = _decode("contiguous" if layout == "paged" else "paged", d)
    assert torch.equal(got, other)


def test_cuda_decode_model_groups_row_alone_equals_row_in_batch(cuda):
    for group, dh, kv in MODEL_DECODE_SHAPES:
        d = _decode_rows(cuda, (1, 17, 128, 129, 300, 777, 1000, 1024),
                         group, torch.bfloat16, kv=kv, dh=dh)
        batch = _decode("paged", d)
        for r in range(8):
            assert torch.equal(_decode("paged", d, slice(r, r + 1))[0],
                               batch[r])


def test_cuda_decode_uncovered_group_or_head_dim_raises(cuda):
    """Groups 3 and 16 at dh 128, and group 2 at dh 64, have no
    instantiation: the wrappers raise, they never reach a plain version."""
    for group, dh, kv in ((3, 128, 2), (16, 128, 1), (2, 64, 4)):
        d = _decode_rows(cuda, (5, 9), group, torch.bfloat16, s=64, kv=kv,
                         dh=dh)
        for layout in ("paged", "contiguous"):
            with pytest.raises(ValueError, match="not built"):
                _decode(layout, d)


@pytest.mark.parametrize("sq,sk", [(100, 100), (37, 100), (1024, 1024)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_flash_attention_dh64_matches_plain(cuda, sq, sk, dtype):
    """MusicGen's head dim (bf16 on the tensor cores, f32 on the FMA
    body): 32 heads over 32 KV heads and a GQA group of 4, ragged lengths
    with an empty row, each launch counted at its dh 64 shape class."""
    g = _gen(cuda, sq)
    for h, kv in ((32, 32), (8, 2)):
        q = torch.randn((3, h, sq, 64), generator=g, device=cuda).to(dtype)
        k = torch.randn((3, kv, sk, 64), generator=g, device=cuda).to(dtype)
        v = torch.randn((3, kv, sk, 64), generator=g, device=cuda).to(dtype)
        lengths = torch.tensor([sk, sk - 20, 0], dtype=torch.int32,
                               device=cuda)
        cuda_lib.reset_launches()
        got = ops.flash_attention(q, k, v, lengths, causal=True)
        shape = "suffix dh64" if sk > sq else "dh64"
        assert cuda_lib.LAUNCH_SHAPES[("flash_attention", shape)] == 1
        want = ref.flash_attention_ref(q, k, v, lengths, True)
        assert not bool(got[2].any())
        tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 \
            else BF16_ATTN_TOL
        torch.testing.assert_close(got, want, **tol)


def test_cuda_flash_attention_refuses_other_head_dims(cuda):
    for dh in (32, 96):
        q, k, v = [torch.randn((1, 2, 16, dh), device=cuda).bfloat16()
                   for _ in range(3)]
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_attention(q, k, v)
    # the packed mode is built at dh 128 only
    ids = _packed(cuda, (30, 20), (0, 0), 64, 0)[3]
    q, k, v = [torch.randn((1, 2, 64, 64), device=cuda).bfloat16()
               for _ in range(3)]
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_attention_packed(q, k, v, *ids)


@pytest.mark.parametrize("heads", [(28, 4), (48, 4)], ids=["g7", "g12"])
def test_cuda_packed_attention_model_groups_match_plain(cuda, heads):
    """Qwen2-VL's odd group (the last pair of each group one head) and
    StarCoder2's wide one, on a pack of mixed segments after prefix keys
    and on random ids and positions."""
    h, kv = heads
    for ids in (_packed(cuda, (30, 1, 100, 64, 50), (16, 0, 40, 0, 0), 320,
                        64)[3], _random_ids(cuda, h * 10 + kv)):
        sq, sk = ids[0].numel(), ids[1].numel()
        g = _gen(cuda, h)
        q, k, v = [torch.randn((1, n, m, 128), generator=g,
                               device=cuda).bfloat16().transpose(1, 2)
                   for n, m in ((sq, h), (sk, kv), (sk, kv))]
        got = ops.flash_attention_packed(q, k, v, *ids)
        want = ref.flash_attention_packed_ref(q, k, v, *ids)
        real = ids[0] >= 0
        torch.testing.assert_close(got[:, :, real], want[:, :, real],
                                   **BF16_ATTN_TOL)


class _PlainNorm:
    """The plain versions under the wrappers' names, for ``_norm``."""
    @staticmethod
    def fused_rmsnorm(x, gamma, bias, res, return_residual):
        return ref.rmsnorm_ref(x, gamma, bias, res, 1e-6, return_residual)

    @staticmethod
    def fused_layernorm(x, gamma, beta, bias, res, return_residual):
        return ref.layernorm_ref(x, gamma, beta, bias, res, 1e-6,
                                 return_residual)


@pytest.mark.parametrize("cols,rms", [(6144, False), (2048, False),
                                      (3584, True)])
@pytest.mark.parametrize("rows", [8, 1000])
def test_cuda_norm_model_widths_match_plain(cuda, cols, rms, rows):
    """StarCoder2's and MusicGen's LayerNorm with bias and residual, and
    Qwen2-VL's RMS width, in bf16: the residual bit for bit, and the
    LayerNorm launches counted in their mode."""
    x, res, bias, gamma, beta = _norm_inputs(cuda, rows, cols,
                                             torch.bfloat16)
    cuda_lib.reset_launches()
    y, s = _norm(rms, x, res, bias, gamma, beta)
    assert cuda_lib.LAUNCH_SHAPES[("norm", "layernorm")] == (0 if rms
                                                             else 1)
    y_ref, s_ref = _norm(rms, x, res, bias, gamma, beta, fn=_PlainNorm)
    torch.testing.assert_close(y, y_ref, rtol=2e-2, atol=3e-2)
    assert torch.equal(s, s_ref)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_sample_at_qwen2_vl_vocab_matches_plain(cuda, dtype):
    """V 152064: slices of 19008 values a block of the 8-block cluster,
    below MAX_SLICE, token for token on shared noise."""
    from repro_torch.kernels import sampling
    plan = sampling.sample_plan(8, 152064, 64)
    assert plan.slice_len <= sampling.MAX_SLICE
    g = _gen(cuda, 152)
    logits = 3 * torch.randn((8, 152064), generator=g, device=cuda)
    logits[1, 5000:5010] = logits[1].max() + 1          # a tie at the top
    args = _sample_args(cuda, logits.to(dtype))
    for a in (args, _all_sampled(args)):
        assert torch.equal(ops.fused_sample(*a), ref.sample_ref(*a))


def test_cuda_mrope_is_captured_in_a_graph(cuda):
    """M-RoPE builds its frequency-to-stream selector on the device: a
    CUDA graph captures it (a host-to-device copy fails a capture, as
    the packed prefill cell's did before) and replays it bit-equal to
    the eager call."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import layers as L
    cfg = get_smoke_config("qwen2-vl-7b")
    x = torch.randn((2, 24, 4, 128), generator=_gen(cuda, 9),
                    device=cuda).bfloat16()
    pos = L.positions_for(cfg, (2, 24), 16, device=cuda)
    want = L.apply_mrope(x, pos, cfg.rope_theta)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        out = L.apply_mrope(x, pos, cfg.rope_theta)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# the SSM and hybrid families: Zamba2's shared block prefills a prompt at
# its exact length; the mamba state decodes in place under graphs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 63, 937, 1000])
def test_cuda_flash_attention_dh64_exact_lengths_match_plain(cuda, s):
    """Zamba2's shared block (H 32 over KV 32 at dh 64, bf16, the SSM
    serve phases' batch of 4): a prompt's own length, not a bucket's,
    one token and lengths off the 64-key tile among them; each row alone
    equals the row in the batch."""
    g = _gen(cuda, s)
    q, k, v = (torch.randn((4, 32, s, 64), generator=g,
                           device=cuda).bfloat16() for _ in range(3))
    cuda_lib.reset_launches()
    got = ops.flash_attention(q, k, v, causal=True)
    assert cuda_lib.LAUNCH_SHAPES[("flash_attention", "dh64")] == 1
    want = ref.flash_attention_ref(q, k, v, None, True)
    torch.testing.assert_close(got, want, **BF16_ATTN_TOL)
    for r in (0, 3):
        one = ops.flash_attention(q[r:r + 1].clone(), k[r:r + 1].clone(),
                                  v[r:r + 1].clone(), causal=True)
        assert torch.equal(one[0], got[r])


def test_cuda_generate_graph_lives_for_its_call_and_is_not_counted(cuda):
    """The planned departure: ``generate`` captures its tick's graph on
    its own state, replays it for the call and drops it (the reference
    compiles its tick once an engine); two calls build two graphs and
    leave ``compile_count`` as it was, and give the same tokens."""
    from repro_torch.runtime import engine as port_engine
    engine = _graph_engine(cuda).engine
    built = []

    class Recorded(port_engine.TickCells):
        def __init__(self, tick):
            super().__init__(tick)
            built.append(self)

    real = port_engine.TickCells
    port_engine.TickCells = Recorded
    try:
        prompts = [[5, 9, 3, 7], list(range(10, 30))]
        count = engine.compile_count
        first = engine.generate(prompts, max_new_tokens=8)
        second = engine.generate(prompts, max_new_tokens=8)
    finally:
        port_engine.TickCells = real
    assert first == second
    assert engine.compile_count == count
    assert len(built) == 2 and built[0] is not built[1]
    assert [c.captures for c in built] == [1, 1]


def _ssm_engine(dev, arch, slots=4, **kw):
    """An SSM or hybrid smoke config in f32 (the hybrid's shared block at
    dh 64, an instantiated decode and causal shape), contiguous, with
    one batch bucket of ``slots``."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import ContinuousEngine, InferenceEngine
    cfg = get_smoke_config(arch)
    if cfg.attn_every:
        cfg = dataclasses.replace(cfg, d_head=64)
    engine = InferenceEngine(
        cfg, init_params(cfg, device=dev),
        ladder=BucketLadder(seq_buckets=(32, 64, 128),
                            batch_buckets=(slots,)), device=dev)
    return ContinuousEngine(engine, max_slots=slots, cap_new=24,
                            kv_layout="contiguous", **kw)


SSM_ARCHS = ("falcon-mamba-7b", "zamba2-1.2b")


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cuda_ssm_graph_tick_is_bit_equal_to_the_eager_tick(cuda, arch):
    """Served from a slot cache of 64 positions grown to 128 mid-decode:
    every tick's replay leaves every cache leaf (conv window, scan state,
    the shared block's KV) and the control state bit-equal to
    ``decode_step_batch`` on a copy; the grow re-captures the tick's
    cell only where the cache has a sequence axis (the hybrid's shared
    KV); greedy streams equal ``generate`` alone."""
    from repro_torch.api import GenerationParams, TurboClient
    ce = _ssm_engine(cuda, arch, max_len=64)
    client = TurboClient(ce, warmup=True)
    assert len(ce.tick_cells) == 2 == ce.tick_cells.captures
    seen = _check_every_replay(ce)
    rng = np.random.default_rng(31)
    work = _graph_workload(rng, False, n=6, first_len=64)
    handles = [client.submit(p, g) for p, g in work[:4]]
    client.pump(max_ticks=4)
    long_prompt = [int(t) for t in rng.integers(1, 256, 80)]
    handles.append(client.submit(long_prompt,
                                 GenerationParams(max_new_tokens=20)))
    handles += [client.submit(p, g) for p, g in work[4:]]
    results = [h.result() for h in handles]
    assert ce.max_len == 128 and len(seen) >= 20
    recaptured = sum(c for _, _, c in seen)
    assert recaptured == (1 if arch == "zamba2-1.2b" else 0)
    alone = [ce.engine.generate([p], max_new_tokens=g.max_new_tokens)[0]
             for p, g in work[:4] + [(long_prompt,
                                      GenerationParams(max_new_tokens=20))]
             + work[4:]]
    assert results == alone
    assert ce.engine.kv_slab.live_bytes == 0


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_cuda_ssm_prefill_cell_replay_is_bit_equal_to_the_eager_body(cuda,
                                                                     arch):
    """A per-group prefill cell of one exact prompt length: its first
    call and its replays give the eager public body's logits and every
    state leaf bit for bit, on other prompts of that length too; each
    new length is a new cell."""
    engine = _ssm_engine(cuda, arch).engine
    table = engine.prefill_cells

    def call(seed, n, tab):
        rng = np.random.default_rng(seed)
        prompts = [[int(t) for t in rng.integers(1, 256, n)]
                   for _ in range(3)]
        return engine._prefill_batch(prompts, tab, max_len=64,
                                     max_new_tokens=2)

    def leaves(st):
        return {k: v.clone() for k, v in st.cache.items()}
    for n in (37, 5):
        want = [leaves(call(s, n, None)) for s in (0, 1)]
        for s in (0, 1, 0):
            got = leaves(call(s, n, table))
            assert set(got) == set(want[s])
            for k in got:
                assert torch.equal(got[k], want[s][k]), (n, s, k)
    assert table.captures == 2 == engine.compile_count
    assert sorted(table.keys()) == [(64, 4, 5), (64, 4, 37)]


def test_cuda_hybrid_decode_launches_per_tick(cuda):
    """Zamba2's tick launches the contiguous decode kernel once per
    shared-block application and the norm once per mamba layer, twice
    per application and once at the end; Falcon-Mamba's launches no
    attention kernel."""
    from repro_torch.api import GenerationParams, TurboClient
    for arch in SSM_ARCHS:
        ce = _ssm_engine(cuda, arch)
        client = TurboClient(ce)
        cfg = ce.engine.cfg
        apps = cfg.num_layers // cfg.attn_every if cfg.attn_every else 0
        cuda_lib.reset_launches()
        client.submit([3, 1, 4, 1, 5, 9, 2, 6],
                      GenerationParams(max_new_tokens=10)).result()
        steps = ce.decode_ticks + ce.tick_cells.warm_ticks
        assert cuda_lib.LAUNCHES["flash_decode"] == apps * steps
        assert cuda_lib.LAUNCHES["flash_attention"] == \
            apps * ce.prefill_dispatches
        assert cuda_lib.LAUNCHES["norm"] == \
            (cfg.num_layers + 2 * apps + 1) * (steps + ce.prefill_dispatches)


# ---------------------------------------------------------------------------
# Training: the kernels' gradients and a deterministic train step
# ---------------------------------------------------------------------------


def _grad_of(fn, inputs, up):
    out = fn(*inputs)
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * u).sum() for o, u in zip(outs, up))
    return torch.autograd.grad(loss, [t for t in inputs if t is not None])


@pytest.mark.parametrize("rms", [True, False])
def test_cuda_norm_gradient_matches_plain(cuda, rms):
    """The norm's Function on the card (forward: the kernel) against
    autograd through the plain version: bf16 rows of 2048 with a
    residual and the sum returned.  The Function's backward computes in
    f32 from the inputs and rounds once; autograd rounds at each bf16 op
    of the plain version: within two bf16 ulps of the largest gradient."""
    x, res, bias, gamma, beta = _norm_inputs(cuda, 256, 2048, torch.bfloat16,
                                             seed=7)
    inputs = [t.clone().requires_grad_(True)
              for t in ((x, gamma, bias, res) if rms
                        else (x, gamma, beta, bias, res))]
    g = _gen(cuda, 8)
    up = [torch.randn((256, 2048), generator=g, device=cuda)
          for _ in range(2)]
    if rms:
        kern = lambda x, gm, b, r: ops.fused_rmsnorm(  # noqa: E731
            x, gm, b, r, return_residual=True)
        plain = lambda x, gm, b, r: ref.rmsnorm_ref(  # noqa: E731
            x, gm, b, r, 1e-6, True)
    else:
        kern = lambda x, gm, bt, b, r: ops.fused_layernorm(  # noqa: E731
            x, gm, bt, b, r, return_residual=True)
        plain = lambda x, gm, bt, b, r: ref.layernorm_ref(  # noqa: E731
            x, gm, bt, b, r, 1e-6, True)
    cuda_lib.reset_launches()
    got = _grad_of(kern, inputs, up)
    assert cuda_lib.LAUNCHES["norm"] == 1
    want = _grad_of(plain, inputs, up)
    for a, w in zip(got, want):
        top = float(w.float().abs().max())
        torch.testing.assert_close(a.float(), w.float(), rtol=2 ** -7,
                                   atol=2 * top * 2 ** -8)


def test_cuda_softmax_gradient_matches_plain(cuda):
    """The masked softmax's Function on the card against autograd
    through the plain version: f32 rows of 512 with causal lengths (one
    empty), a scale; the kernel's weights and the plain ones differ in
    summation order only, hence 1e-5."""
    g = _gen(cuda, 9)
    r, c = 1024, 512
    x = (torch.randn((r, c), generator=g, device=cuda) * 4).requires_grad_()
    lengths = (torch.arange(r, device=cuda, dtype=torch.int32) % (c + 1))
    up = [torch.randn((r, c), generator=g, device=cuda)]
    cuda_lib.reset_launches()
    (got,) = _grad_of(lambda t: ops.fused_softmax(t, lengths, scale=0.088),
                      [x], up)
    assert cuda_lib.LAUNCHES["softmax"] == 1
    (want,) = _grad_of(lambda t: ref.softmax_ref(t, lengths, 0.088), [x], up)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert not bool(got[0].any())


def test_cuda_train_steps_are_bit_equal(cuda):
    """Two identical runs of two train steps (the smoke InternLM2, bf16
    compute, AdamW) from the same state on the same batch end in the
    same bits: no atomic adds in the gradient (the embedding's gather
    sums by segment), and every step launches the norm and softmax
    kernels (2L + 1 and L a microbatch)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.data import TokenStream
    from repro_torch.training import TrainConfig, init_state, make_train_step
    cfg = get_smoke_config("internlm2-1.8b")
    tc = TrainConfig()
    batch = TokenStream(cfg, 4, 64, seed=1, device=cuda).batch(0)
    runs = []
    for _ in range(2):
        state = init_state(cfg, tc, seed=0, device=cuda)
        step = make_train_step(cfg, tc)
        cuda_lib.reset_launches()
        for _ in range(2):
            state, metrics = step(state, batch)
        assert cuda_lib.LAUNCHES["norm"] == 2 * (2 * cfg.num_layers + 1)
        assert cuda_lib.LAUNCHES["softmax"] == 2 * cfg.num_layers
        runs.append((state, float(metrics["loss"])))
    (a, la), (b, lb) = runs
    assert la == lb

    def leaves(tree):
        if isinstance(tree, dict):
            return [x for k in sorted(tree) for x in leaves(tree[k])]
        return [tree]
    for x, y in zip(leaves(a), leaves(b)):
        assert torch.equal(x, y)
