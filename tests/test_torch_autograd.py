"""The gradients of the kernels the train path runs, on the CPU.

`repro_torch.kernels.autograd` gives the norm and softmax wrappers of
`repro_torch.kernels.ops` a ``torch.autograd.Function`` (forward: the
wrapper's dispatch; backward: plain PyTorch in f32).  Each is held here
against autograd through the kernel's plain version (`kernels.ref`) on
the same inputs: in f32 the two backwards differ only in the order of
their sums (1e-5); in bf16 the Function computes in f32 and rounds once
where autograd rounds at every bf16 step of the plain version, so a
bf16 ulp of the largest gradient apart (an ulp is 2^-7 relative).  The
wrappers without a backward (flash, decode, sampling) raise when an
input needs a gradient, and every wrapper keeps its plain dispatch (no
``grad_fn``) where none does.  The embedding's and the MoE's gather
(`layers.gather_rows`) is held to autograd's own lookup.
"""
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.models import layers as L

F32_TOL = dict(rtol=1e-5, atol=1e-5)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _bf16_tol(want):
    top = max(float(want.float().abs().max()), 1e-30)
    return dict(rtol=2 ** -7, atol=2 * top * 2 ** -8)


def _leaf(shape, dtype, g, scale=1.0, shift=0.0):
    t = torch.randn(shape, generator=g) * scale + shift
    return t.to(dtype).requires_grad_(True)


def _grads(out, inputs, upstream):
    outs = out if isinstance(out, tuple) else (out,)
    loss = sum((o.float() * u).sum() for o, u in zip(outs, upstream))
    return torch.autograd.grad(loss, [t for t in inputs if t is not None])


def _norm_case(rms, dtype, bias, residual, return_residual, seed=0):
    g = _gen(seed)
    r, c = 12, 64
    x = _leaf((r, c), dtype, g)
    gamma = _leaf((c,), dtype, g, 0.3, 1.0)
    beta = None if rms else _leaf((c,), dtype, g, 0.2)
    b = _leaf((c,), dtype, g, 0.1) if bias else None
    res = _leaf((r, c), dtype, g) if residual else None
    up = [torch.randn((r, c), generator=g)
          for _ in range(2 if return_residual else 1)]
    return x, gamma, beta, b, res, up


def _norm_pair(rms, x, gamma, beta, b, res, rr):
    if rms:
        got = ops.fused_rmsnorm(x, gamma, b, res, return_residual=rr)
        want = ref.rmsnorm_ref(x, gamma, b, res, 1e-6, rr)
    else:
        got = ops.fused_layernorm(x, gamma, beta, b, res,
                                  return_residual=rr)
        want = ref.layernorm_ref(x, gamma, beta, b, res, 1e-6, rr)
    return got, want


@pytest.mark.parametrize("rms", [True, False], ids=["rms", "layernorm"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("bias,residual,rr", [
    (False, False, False), (False, True, True), (True, True, True),
    (True, False, False), (False, True, False)])
def test_norm_backward_matches_autograd_through_plain(rms, dtype, bias,
                                                      residual, rr):
    x, gamma, beta, b, res, up = _norm_case(rms, dtype, bias, residual, rr)
    inputs = (x, gamma, beta, b, res)
    got, want = _norm_pair(rms, x, gamma, beta, b, res, rr)
    outs = got if rr else (got,)
    assert all(o.grad_fn is not None for o in outs)
    for o, w in zip(outs, want if rr else (want,)):
        torch.testing.assert_close(o, w, rtol=0, atol=0)
    g_got = _grads(got, inputs, up)
    g_want = _grads(want, inputs, up)
    for a, w in zip(g_got, g_want):
        assert a.dtype == w.dtype
        tol = F32_TOL if dtype == torch.float32 else _bf16_tol(w)
        torch.testing.assert_close(a, w, **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("masked", [True, False])
def test_softmax_backward_matches_autograd_through_plain(dtype, masked):
    """Causal lengths with an empty row (length 0) and one past C, a
    scale; masked columns and the empty row get no gradient."""
    g = _gen(1)
    r, c = 9, 24
    x = _leaf((r, c), dtype, g, 3.0)
    lengths = torch.tensor([0, 1, 5, 24, 30, 7, 12, 3, 24],
                           dtype=torch.int32) if masked else None
    up = [torch.randn((r, c), generator=g)]
    got = ops.fused_softmax(x, lengths, scale=0.125)
    want = ref.softmax_ref(x, lengths, 0.125)
    assert got.grad_fn is not None
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    (gx,) = _grads(got, (x,), up)
    (wx,) = _grads(want, (x,), up)
    tol = F32_TOL if dtype == torch.float32 else _bf16_tol(wx)
    torch.testing.assert_close(gx, wx, **tol)
    if masked:
        assert not bool(gx[0].any())
        col = torch.arange(c)[None, :]
        assert not bool(gx[col >= lengths[:, None].long()].any())


def test_wrappers_keep_their_dispatch_without_grad():
    """No input needs a gradient, or grad mode is off: the plain dispatch,
    no Function node (serving keeps its launches and bits)."""
    g = _gen(2)
    x = torch.randn((4, 64), generator=g)
    gamma = torch.ones(64)
    assert ops.fused_rmsnorm(x, gamma).grad_fn is None
    assert ops.fused_softmax(x).grad_fn is None
    xg = x.clone().requires_grad_(True)
    with torch.no_grad():
        assert ops.fused_rmsnorm(xg, gamma).grad_fn is None
        assert ops.fused_layernorm(xg, gamma, gamma).grad_fn is None
        assert ops.fused_softmax(xg).grad_fn is None


def _flash_inputs(g):
    q = torch.randn((1, 4, 8, 16), generator=g)
    k = torch.randn((1, 2, 8, 16), generator=g)
    return q, k, k.clone()


@pytest.mark.parametrize("wrapper", ["flash_attention",
                                     "flash_attention_packed",
                                     "flash_decode", "flash_decode_paged",
                                     "fused_sample"])
def test_wrappers_without_backward_raise_under_grad(wrapper):
    g = _gen(3)
    q, k, v = _flash_inputs(g)
    ids = torch.zeros(8, dtype=torch.int32)
    pos = torch.arange(8, dtype=torch.int32)
    pool = torch.randn((3, 4, 2, 16), generator=g)
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([5], dtype=torch.int32)
    logits = torch.randn((1, 50), generator=g)
    one = torch.ones(1)
    calls = {
        "flash_attention": lambda t: ops.flash_attention(t, k, v),
        "flash_attention_packed": lambda t: ops.flash_attention_packed(
            t, k, v, ids, ids, pos, pos),
        "flash_decode": lambda t: ops.flash_decode(t[:, :, 0], k, v, lens),
        "flash_decode_paged": lambda t: ops.flash_decode_paged(
            t[:, :, 0], pool, pool, tables, lens),
        "fused_sample": lambda t: ops.fused_sample(
            t, one, torch.zeros(1, dtype=torch.int32), one,
            torch.zeros((1, 8))),
    }
    arg = logits if wrapper == "fused_sample" else q
    calls[wrapper](arg)                       # no input needs a gradient
    with pytest.raises(RuntimeError, match="no backward"):
        calls[wrapper](arg.clone().requires_grad_(True))
    with torch.no_grad():
        calls[wrapper](arg.clone().requires_grad_(True))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_gather_rows_backward_matches_indexing(dtype):
    """Repeated rows (the MoE's overflow slot, a token seen twice) sum in
    f32 and round once; autograd's lookup adds in the table's dtype."""
    g = _gen(4)
    table = torch.randn((30, 8), generator=g).to(dtype).requires_grad_()
    idx = torch.randint(0, 30, (5, 7), generator=g)
    idx[0, :4] = 3
    up = torch.randn((5, 7, 8), generator=g)
    out = L.gather_rows(table, idx)
    torch.testing.assert_close(out, table[idx], rtol=0, atol=0)
    (got,) = torch.autograd.grad((out.float() * up).sum(), table)
    (want,) = torch.autograd.grad((table[idx].float() * up).sum(), table)
    tol = F32_TOL if dtype == torch.float32 else _bf16_tol(want)
    torch.testing.assert_close(got, want, **tol)
    assert not bool(got[[i for i in range(30)
                         if i not in idx.flatten().tolist()]].any())
