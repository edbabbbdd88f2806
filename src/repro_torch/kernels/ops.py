"""Dispatch between the Hopper kernels and their plain versions.

Every wrapper routes on the device of the tensors it is given: tensors on
the CPU go to the plain PyTorch version (`repro_torch.kernels.ref`), CUDA
tensors go to the kernel, and anything else raises.  There is no fallback:
a CUDA tensor that the kernel refuses raises, it never reaches the plain
version.  Launches are counted in `repro_torch.kernels.cuda_lib.LAUNCHES`.
"""
from __future__ import annotations

from typing import Optional

import torch

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


def fused_softmax(x, lengths=None, *, scale: float = 1.0):
    """Masked scaled softmax over the last dim of (R, C) ``x``; columns
    at or past each row's length are zero."""
    if on_cpu("fused_softmax", x, lengths):
        return ref.softmax_ref(x, lengths, scale)
    return _sm.softmax_cuda(x, lengths, scale=scale)


def fused_rmsnorm(x, gamma, bias=None, residual=None, *, eps: float = 1e-6,
                  return_residual: bool = False):
    """AddBias + Residual + RMSNorm over the last dim of (R, C) ``x``."""
    if on_cpu("fused_rmsnorm", x, gamma, bias, residual):
        return ref.rmsnorm_ref(x, gamma, bias, residual, eps,
                               return_residual)
    return _ln.norm_cuda(x, gamma, None, bias, residual, rms=True, eps=eps,
                         return_residual=return_residual)


def fused_layernorm(x, gamma, beta, bias=None, residual=None, *,
                    eps: float = 1e-6, return_residual: bool = False):
    """AddBias + Residual + LayerNorm (paper Eq. 1) over (R, C) ``x``."""
    if on_cpu("fused_layernorm", x, gamma, beta, bias, residual):
        return ref.layernorm_ref(x, gamma, beta, bias, residual, eps,
                                 return_residual)
    return _ln.norm_cuda(x, gamma, beta, bias, residual, rms=False, eps=eps,
                         return_residual=return_residual)


def fused_sample(logits, temperature, top_k, top_p, gumbel):
    """Temperature / top-k / top-p / Gumbel sampling over (B, V) logits;
    (B,) int32 tokens, argmax for rows with temperature <= 0."""
    if on_cpu("fused_sample", logits, temperature, top_k, top_p, gumbel):
        return ref.sample_ref(logits, temperature, top_k, top_p, gumbel)
    return _smp.sample_cuda(logits, temperature, top_k, top_p, gumbel)


def flash_attention(q, k, v, lengths=None, *, causal: bool = True,
                    scale: Optional[float] = None):
    """q: (B,H,Sq,dh); k, v: (B,KV,Sk,dh) -> (B,H,Sq,dh)."""
    if on_cpu("flash_attention", q, k, v, lengths):
        return ref.flash_attention_ref(q, k, v, lengths, causal, scale)
    return _fa.flash_attention_cuda(q, k, v, lengths, causal=causal,
                                    scale=scale)


def flash_attention_packed(q, k, v, q_seg, k_seg, q_pos, k_pos, *,
                           scale: Optional[float] = None):
    """Segment-masked attention of a packed prefill: q (1,H,Sq,dh); k, v
    (1,KV,Sk,dh), the queries at the last Sq keys; segment ids and
    positions (Sq,) / (Sk,) int32 -> (1,H,Sq,dh)."""
    if on_cpu("flash_attention_packed", q, k, v, q_seg, k_seg, q_pos,
              k_pos):
        return ref.flash_attention_packed_ref(q, k, v, q_seg, k_seg, q_pos,
                                              k_pos, scale)
    return _fa.flash_attention_packed_cuda(q, k, v, q_seg, k_seg, q_pos,
                                           k_pos, scale=scale)


def flash_decode(q, k, v, lengths=None, *, scale: Optional[float] = None):
    """Split-K decode attention over a contiguous cache: q (B,H,dh); k, v
    (B,KV,S,dh), strided views allowed -> (B,H,dh)."""
    if on_cpu("flash_decode", q, k, v, lengths):
        return ref.flash_decode_ref(q, k, v, lengths, scale)
    return _fd.flash_decode_cuda(q, k, v, lengths, scale=scale)


def flash_decode_paged(q, k_pool, v_pool, block_tables, lengths=None, *,
                       scale: Optional[float] = None):
    """Decode attention over a block-table pool: q (B,H,dh); pools
    (NB,BS,KV,dh); block_tables (B,MB) -> (B,H,dh)."""
    if on_cpu("flash_decode_paged", q, k_pool, v_pool, block_tables,
              lengths):
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, block_tables,
                                          lengths, scale)
    return _fd.flash_decode_paged_cuda(q, k_pool, v_pool, block_tables,
                                       lengths, scale=scale)
