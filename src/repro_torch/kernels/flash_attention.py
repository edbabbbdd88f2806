"""Tiled (flash) attention for prompt prefill: the Hopper kernel's wrapper.

Replaces the JAX package's `flash_attention_pallas`
(src/repro/kernels/flash_attention.py), in two modes: causal prompt
prefill (:func:`flash_attention_cuda`) and the segment-masked attention
of a packed prefill (:func:`flash_attention_packed_cuda`, the JAX
package's ``attention_packed``).  The kernels are in
``csrc/flash_attention.cu``; their plain versions are
:func:`repro_torch.kernels.ref.flash_attention_ref` and
:func:`~repro_torch.kernels.ref.flash_attention_packed_ref`, re-exported
here.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import (flash_attention_packed_ref,
                                     flash_attention_ref)

__all__ = ["flash_attention_cuda", "flash_attention_packed_cuda",
           "flash_attention_packed_ref", "flash_attention_ref"]

HEAD_DIM = 128      # the one head dim csrc/flash_attention.cu is built for
#: the most keys the packed mode takes (its per-block list of visited key
#: tiles holds kMaxTiles = 2048 tiles of 64 keys)
PACKED_MAX_KEYS = 2048 * 64


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


def flash_attention_packed_cuda(q: torch.Tensor, k: torch.Tensor,
                                v: torch.Tensor, q_seg: torch.Tensor,
                                k_seg: torch.Tensor, q_pos: torch.Tensor,
                                k_pos: torch.Tensor, *,
                                scale: Optional[float] = None
                                ) -> torch.Tensor:
    """Segment-masked attention of one packed row.  q: (1,H,Sq,dh); k, v:
    (1,KV,Sk,dh), Sk >= Sq, the queries at the last Sq keys; q_seg, q_pos
    (Sq,) and k_seg, k_pos (Sk,) contiguous, 16-byte-aligned int32.  bf16
    only (the serving path's dtype); strided q/k/v as in
    :func:`flash_attention_cuda`, and the result is likewise a
    (1,H,Sq,dh) view of (1,Sq,H,dh) storage.  Rows of query tiles that
    hold only padding (negative ids) come back as zeros."""
    name = "flash_attention_packed"
    ids = (q_seg, k_seg, q_pos, k_pos)
    cuda_lib.require_cuda(name, q, k, v, *ids, aligned=False)
    cuda_lib.require_cuda(name, *ids)          # 16-byte vector reads
    b, h, sq, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if b != 1 or tuple(k.shape) != (1, kv, sk, dh) or v.shape != k.shape:
        raise ValueError(f"{name}: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}: expected one flat row")
    if not sq <= sk <= PACKED_MAX_KEYS:
        raise ValueError(f"{name}: need Sq <= Sk <= {PACKED_MAX_KEYS}, got "
                         f"Sq {sq}, Sk {sk}")
    if kv == 0 or h % kv:
        raise ValueError(f"{name}: H={h} is not a multiple of KV={kv}")
    if dh != HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} is not {HEAD_DIM}")
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise ValueError(f"{name}: q/k/v must be bfloat16 (the packed mode "
                         "is built for the serving path's dtype only)")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"{name}: the head dim must be contiguous")
    for t, n in zip(ids, (sq, sk, sq, sk)):
        if t.dtype != torch.int32 or tuple(t.shape) != (n,) or \
                not t.is_contiguous():
            raise ValueError(f"{name}: segment ids and positions must be "
                             "contiguous int32 of shape (Sq,) / (Sk,)")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    lib = cuda_lib.library()
    out = torch.empty((1, sq, h, dh), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    if sq == 0:
        return out
    strides = (ctypes.c_longlong * 12)(
        *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
        *out.stride()[:3])
    rc = lib.repro_flash_attention_packed(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_seg.data_ptr(),
        q_pos.data_ptr(), k_seg.data_ptr(), k_pos.data_ptr(),
        out.data_ptr(), h, kv, sq, sk, dh,
        ctypes.cast(strides, ctypes.c_void_p), float(scale),
        cuda_lib.DTYPE_CODES[q.dtype], cuda_lib.stream_ptr(q))
    cuda_lib.check(rc, name)
    cuda_lib.count_launch(name)
    return out
