"""Tiled (flash) attention for prompt prefill: the Hopper kernel's wrapper.

Replaces the JAX package's `flash_attention_pallas`
(src/repro/kernels/flash_attention.py).  The kernel is
``csrc/flash_attention.cu``; its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`, re-exported here.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention_cuda", "flash_attention_ref"]

HEAD_DIM = 128      # the one head dim csrc/flash_attention.cu is built for


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         lengths: Optional[torch.Tensor] = None, *,
                         causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,dh); k, v: (B,KV,Sk,dh); lengths: (B,) int32 valid kv
    lengths.  Any strides with a contiguous last dim are read in place
    (a (B,S,H,dh) activation viewed as (B,H,S,dh) costs no copy).  The
    result is a (B,H,Sq,dh) view of (B,Sq,H,dh) storage, so transposing
    it back to the model's layout is free."""
    name = "flash_attention"
    cuda_lib.require_cuda(name, q, k, v, lengths, aligned=False)
    b, h, sq, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, sk, dh) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} / "
                         f"{tuple(v.shape)} does not fit q {tuple(q.shape)}")
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: H={h} is not a multiple of KV={kv}")
    if dh != HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} is not {HEAD_DIM}")
    if q.dtype not in cuda_lib.DTYPE_CODES or k.dtype != q.dtype or \
            v.dtype != q.dtype:
        raise ValueError(f"{name}: q/k/v must share one of "
                         f"{list(cuda_lib.DTYPE_CODES)}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")
    if lengths is not None and (lengths.dtype != torch.int32 or
                                tuple(lengths.shape) != (b,) or
                                not lengths.is_contiguous()):
        raise ValueError(f"{name}: lengths must be contiguous (B,) int32")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    lib = cuda_lib.library()
    out = torch.empty((b, sq, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if b == 0 or sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    rc = lib.repro_flash_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if lengths is None else lengths.data_ptr(), out.data_ptr(),
        b, h, kv, sq, sk, dh, ctypes.cast(strides, ctypes.c_void_p),
        int(causal), float(scale), cuda_lib.DTYPE_CODES[q.dtype],
        cuda_lib.stream_ptr(q))
    cuda_lib.check(rc, name)
    cuda_lib.count_launch("flash_attention")
    return out
