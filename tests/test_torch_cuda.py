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


@pytest.mark.parametrize("h,kv", [(16, 8), (8, 8), (32, 4)])
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
    packed-mode flash launch per layer and none of the causal one, no
    leak; and each prompt's last-token logits from one packed pass agree
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


@pytest.mark.parametrize("h,kv", [(16, 8), (8, 8), (32, 4)])
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
        ops.flash_decode(q[:, :12], k[:, :3], v[:, :3], lens)
    with pytest.raises(ValueError, match="f32 or bf16"):
        ops.flash_decode(q.half(), k, v, lens)
    with pytest.raises(ValueError, match="one layout"):
        ops.flash_decode(q, k, v.contiguous(), lens)


def test_cuda_contiguous_serving_matches_generate_alone(cuda):
    """The contiguous slot cache on the card: greedy streams equal
    ``generate`` alone (which decodes through the paged kernel), and every
    decode tick launches the contiguous kernel once per layer."""
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
        cfg.num_layers * ce.decode_ticks
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
                 bs=16):
    """q of H = KV * group heads; a (B, S, KV, dh) cache NaN past each
    length, seen as the kernel's strided (B, KV, S, dh) view; the same
    view with a zero tail for the plain version; the same keys in a pool
    (row r owns blocks 1 + r * S / BS, in order, block 0 NaN) with its
    tables; the lengths."""
    rng = np.random.default_rng(seed)
    b = len(lengths)
    lens = np.asarray(lengths, np.int32)
    kc = rng.standard_normal((b, s, kv, 128)).astype(np.float32)
    vc = rng.standard_normal((b, s, kv, 128)).astype(np.float32)
    past = np.arange(s)[None, :] >= lens[:, None]
    kz, vz = kc.copy(), vc.copy()
    kz[past] = vz[past] = 0
    kc[past] = vc[past] = np.nan
    q = rng.standard_normal((b, kv * group, 128)).astype(np.float32)
    q, kc, vc, kz, vz, lens = [torch.from_numpy(a).to(dev)
                               for a in (q, kc, vc, kz, vz, lens)]
    mb = s // bs

    def pool(x):
        blocks = x.reshape(b * mb, bs, kv, 128)
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
@pytest.mark.parametrize("group", [1, 2, 8])
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


@pytest.mark.parametrize("layout", ["paged", "contiguous"])
def test_cuda_decode_is_one_launch_per_call(cuda, layout):
    """Splits are merged inside the launch: one device kernel per call."""
    from torch.profiler import ProfilerActivity, profile
    d = _decode_rows(cuda, (1, 300, 1024), 2, torch.bfloat16)
    _decode(layout, d)
    torch.cuda.synchronize()
    calls = 5
    for _ in range(2):         # the trace now and then comes back empty
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                _decode(layout, d)
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA and
                 "repro" in e.name]
        if names:
            break
    assert len(names) == calls, names
    assert all("decode_kernel" in n for n in names), names
