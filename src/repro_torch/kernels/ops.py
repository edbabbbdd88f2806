"""Dispatch between the Hopper kernels and their plain versions.

Every wrapper routes on the device of the tensors it is given: tensors on
the CPU go to the plain PyTorch version (`repro_torch.kernels.ref`), CUDA
tensors go to the kernel, and anything else raises.  There is no fallback:
a CUDA tensor that the kernel refuses raises, it never reaches the plain
version.  Launches are counted in `repro_torch.kernels.cuda_lib.LAUNCHES`.

Where grad mode is on and an input requires grad, the norm and softmax
wrappers run the same dispatch inside a ``torch.autograd.Function`` with
a plain-PyTorch backward (`repro_torch.kernels.autograd`), and the
attention, decode and sampling wrappers, which have none, raise.

Over a mesh the wrappers take ``DTensor`` inputs and call their kernel on
this rank's shard (the kernels launch on raw pointers, which a DTensor
does not have).  Each takes only the placements its kernel can compute
shard by shard, and raises on any other; it never gathers quietly:

- the norm and the softmax: rows sharded (any dim but the last), the
  normalised dim whole, the vectors replicated;
- flash attention and decode: the batch, and the heads, sharded.  Where
  the query heads are sharded over a mesh dim that replicates the kv
  heads, each rank reads the kv heads of its own query heads, ``(offset
  + h) // G``, and every local group must be one the kernel is built for;
- the sampler and the packed and paged attention serve the
  single-device engines and refuse DTensors.

A replicated input read by sharded rows (a norm's scale, the kv heads of
sharded query heads) gets a partial gradient on those mesh dims.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.distributed.sharding import (from_local_like, head_slices,
                                              is_dtensor, need_dtensor,
                                              refuse_placement, to_local)
from repro_torch.kernels import autograd as _ag
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import layernorm as _ln
from repro_torch.kernels import ref
from repro_torch.kernels import sampling as _smp
from repro_torch.kernels import softmax as _sm


def on_cpu(name: str, *tensors: Optional[torch.Tensor]) -> bool:
    """True when every tensor lies on the CPU, False when every one lies
    on a CUDA device; raises on a mix or on any other device."""
    kinds = {t.device.type for t in tensors if t is not None}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"{name}: tensors on {sorted(kinds)}; expected all on "
                     "the CPU or all on CUDA")


# ---------------------------------------------------------------------------
# DTensor inputs: the kernel on this rank's shard
# ---------------------------------------------------------------------------


def _any_dt(*tensors) -> bool:
    return any(is_dtensor(t) for t in tensors)


def _single_device(name: str, *tensors) -> None:
    """The serving engines' kernels (the sampler, the packed and paged
    attention) run on one device, as the engines do: a DTensor raises."""
    if _any_dt(*tensors):
        raise ValueError(f"{name}: a DTensor input; this kernel serves the "
                         "single-device engines (no mesh placement)")


def _rowwise(name: str, fn, x, rowed=(), vectors=(), **kw):
    """A row-wise kernel on the shard: ``x`` (..., C) may be sharded on
    any dim but the last; ``rowed`` tensors (a residual, lengths: one
    entry a row of ``x``) must be placed as ``x`` (lengths as ``x``'s
    leading dims); ``vectors`` (scale, shift, bias) replicated.  Returns
    ``fn``'s output(s) placed as ``x``."""
    from torch.distributed.tensor import Replicate, Shard
    need_dtensor(name, "x", x)
    rows_dims = []
    for i, p in enumerate(x.placements):
        if isinstance(p, Shard) and p.dim < x.dim() - 1:
            rows_dims.append(i)
        elif not isinstance(p, Replicate):
            refuse_placement(name, "x", x, i,
                             "Shard of a row dim or Replicate")
    for t in rowed:
        need_dtensor(name, "a row input", t)
        if t is not None and tuple(t.placements) != tuple(x.placements):
            raise ValueError(f"{name}: a row input is placed "
                             f"{t.placements}, x {x.placements}; they "
                             "must match")
    for t in vectors:
        need_dtensor(name, "a vector", t)
        if t is not None and not all(isinstance(p, Replicate)
                                     for p in t.placements):
            refuse_placement(name, "a vector", t, next(
                i for i, p in enumerate(t.placements)
                if not isinstance(p, Replicate)), "Replicate")
    xl = x.to_local()
    shape = xl.shape
    out = fn(xl.reshape(-1, shape[-1]),
             *[None if t is None else to_local(t).reshape(-1, *t.shape[
                 x.dim() - 1:]) for t in rowed],
             *[to_local(t, rows_dims) for t in vectors], **kw)
    wrap = lambda o: from_local_like(o.reshape(shape), x)  # noqa: E731
    return tuple(map(wrap, out)) if isinstance(out, tuple) else wrap(out)


def _softmax(x, lengths=None, *, scale: float = 1.0):
    if on_cpu("fused_softmax", x, lengths):
        return ref.softmax_ref(x, lengths, scale)
    return _sm.softmax_cuda(x, lengths, scale=scale)


def fused_softmax(x, lengths=None, *, scale: float = 1.0):
    """Masked scaled softmax over the last dim of (R, C) ``x``; columns
    at or past each row's length are zero."""
    if _any_dt(x, lengths):
        return _rowwise("fused_softmax", fused_softmax, x, (lengths,),
                        scale=scale)
    if _ag.needs_grad(x):
        return _ag.softmax(_softmax, x, lengths, scale=scale)
    return _softmax(x, lengths, scale=scale)


def _rmsnorm(x, gamma, bias=None, residual=None, *, eps: float = 1e-6,
             return_residual: bool = False):
    if on_cpu("fused_rmsnorm", x, gamma, bias, residual):
        return ref.rmsnorm_ref(x, gamma, bias, residual, eps,
                               return_residual)
    return _ln.norm_cuda(x, gamma, None, bias, residual, rms=True, eps=eps,
                         return_residual=return_residual)


def fused_rmsnorm(x, gamma, bias=None, residual=None, *, eps: float = 1e-6,
                  return_residual: bool = False):
    """AddBias + Residual + RMSNorm over the last dim of (R, C) ``x``
    (over a mesh, DTensors of any rank (..., C))."""
    if _any_dt(x, gamma, bias, residual):
        return _rowwise("fused_rmsnorm",
                        lambda x_, r_, g_, b_, **kw: fused_rmsnorm(
                            x_, g_, b_, r_, **kw),
                        x, (residual,), (gamma, bias), eps=eps,
                        return_residual=return_residual)
    if _ag.needs_grad(x, gamma, bias, residual):
        return _ag.rmsnorm(_rmsnorm, x, gamma, bias, residual, eps=eps,
                           return_residual=return_residual)
    return _rmsnorm(x, gamma, bias, residual, eps=eps,
                    return_residual=return_residual)


def _layernorm(x, gamma, beta, bias=None, residual=None, *,
               eps: float = 1e-6, return_residual: bool = False):
    if on_cpu("fused_layernorm", x, gamma, beta, bias, residual):
        return ref.layernorm_ref(x, gamma, beta, bias, residual, eps,
                                 return_residual)
    return _ln.norm_cuda(x, gamma, beta, bias, residual, rms=False, eps=eps,
                         return_residual=return_residual)


def fused_layernorm(x, gamma, beta, bias=None, residual=None, *,
                    eps: float = 1e-6, return_residual: bool = False):
    """AddBias + Residual + LayerNorm (paper Eq. 1) over (R, C) ``x``
    (over a mesh, DTensors of any rank (..., C))."""
    if _any_dt(x, gamma, beta, bias, residual):
        return _rowwise("fused_layernorm",
                        lambda x_, r_, g_, s_, b_, **kw: fused_layernorm(
                            x_, g_, s_, b_, r_, **kw),
                        x, (residual,), (gamma, beta, bias), eps=eps,
                        return_residual=return_residual)
    if _ag.needs_grad(x, gamma, beta, bias, residual):
        return _ag.layernorm(_layernorm, x, gamma, beta, bias, residual,
                             eps=eps, return_residual=return_residual)
    return _layernorm(x, gamma, beta, bias, residual, eps=eps,
                      return_residual=return_residual)


def fused_sample(logits, temperature, top_k, top_p, gumbel):
    """Temperature / top-k / top-p / Gumbel sampling over (B, V) logits;
    (B,) int32 tokens, argmax for rows with temperature <= 0."""
    _ag.refuse_grad("fused_sample", logits)
    _single_device("fused_sample", logits, temperature, top_k, top_p, gumbel)
    if on_cpu("fused_sample", logits, temperature, top_k, top_p, gumbel):
        return ref.sample_ref(logits, temperature, top_k, top_p, gumbel)
    return _smp.sample_cuda(logits, temperature, top_k, top_p, gumbel)


def flash_attention(q, k, v, lengths=None, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B,H,Sq,dh); k, v: (B,KV,Sk,dh) -> (B,H,Sq,dh)."""
    _ag.refuse_grad("flash_attention", q, k, v, lengths)
    if _any_dt(q, k, v, lengths):
        ql, (kl, vl), (ll,) = head_slices("flash_attention", q, (k, v),
                                          (lengths,), q_head=1, kv_head=1)
        out = torch.empty_like(ql) if ql.shape[1] == 0 else flash_attention(
            ql, kl, vl, ll, causal=causal, scale=scale)
        return from_local_like(out, q)
    if on_cpu("flash_attention", q, k, v, lengths):
        return ref.flash_attention_ref(q, k, v, lengths, causal, scale)
    return _fa.flash_attention_cuda(q, k, v, lengths, causal=causal,
                                    scale=scale)


def flash_attention_packed(q, k, v, q_seg, k_seg, q_pos, k_pos, *,
                           scale: Optional[float] = None,
                           plan: Optional[torch.Tensor] = None):
    """Segment-masked attention of a packed prefill: q (1,H,Sq,dh); k, v
    (1,KV,Sk,dh), the queries at the last Sq keys; segment ids and
    positions (Sq,) / (Sk,) int32 -> (1,H,Sq,dh).  ``plan`` is the pack's
    tile plan (:func:`flash_attention_packed_plan`); without one the card
    builds it first (one more launch) and the CPU ignores the tiles."""
    _ag.refuse_grad("flash_attention_packed", q, k, v)
    _single_device("flash_attention_packed", q, k, v, q_seg, k_seg, q_pos,
                   k_pos, plan)
    if on_cpu("flash_attention_packed", q, k, v, q_seg, k_seg, q_pos,
              k_pos, plan):
        return ref.flash_attention_packed_ref(q, k, v, q_seg, k_seg, q_pos,
                                              k_pos, scale, plan)
    return _fa.flash_attention_packed_cuda(q, k, v, q_seg, k_seg, q_pos,
                                           k_pos, scale=scale, plan=plan)


def flash_attention_packed_plan(q_seg, k_seg, q_pos, k_pos):
    """The tile plan of a packed attention over these ids and positions
    ((Sq,) / (Sk,) int32): one per pack, read by every head and layer."""
    if on_cpu("flash_attention_packed_plan", q_seg, k_seg, q_pos, k_pos):
        return ref.flash_attention_packed_plan_ref(q_seg, k_seg, q_pos,
                                                   k_pos)
    return _fa.flash_attention_packed_plan_cuda(q_seg, k_seg, q_pos, k_pos)


def flash_decode(q, k, v, lengths=None, *, scale: Optional[float] = None):
    """Split-K decode attention over a contiguous cache: q (B,H,dh); k, v
    (B,KV,S,dh), strided views allowed -> (B,H,dh)."""
    _ag.refuse_grad("flash_decode", q, k, v, lengths)
    if _any_dt(q, k, v, lengths):
        ql, (kl, vl), (ll,) = head_slices("flash_decode", q, (k, v),
                                          (lengths,), q_head=1, kv_head=1)
        out = torch.empty_like(ql) if ql.shape[1] == 0 else flash_decode(
            ql, kl, vl, ll, scale=scale)
        return from_local_like(out, q)
    if on_cpu("flash_decode", q, k, v, lengths):
        return ref.flash_decode_ref(q, k, v, lengths, scale)
    return _fd.flash_decode_cuda(q, k, v, lengths, scale=scale)


def flash_decode_paged(q, k_pool, v_pool, block_tables, lengths=None, *,
                       scale: Optional[float] = None):
    """Decode attention over a block-table pool: q (B,H,dh); pools
    (NB,BS,KV,dh); block_tables (B,MB) -> (B,H,dh)."""
    _ag.refuse_grad("flash_decode_paged", q, k_pool, v_pool)
    _single_device("flash_decode_paged", q, k_pool, v_pool, block_tables,
                   lengths)
    if on_cpu("flash_decode_paged", q, k_pool, v_pool, block_tables,
              lengths):
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, block_tables,
                                          lengths, scale)
    return _fd.flash_decode_paged_cuda(q, k_pool, v_pool, block_tables,
                                       lengths, scale=scale)
