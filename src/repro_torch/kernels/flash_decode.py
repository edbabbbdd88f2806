"""Paged split-K decode attention: the Hopper kernel's wrapper.

Replaces the JAX package's `flash_decode_paged_pallas`
(src/repro/kernels/flash_decode.py).  The kernel is
``csrc/flash_decode.cu``; its plain version is
:func:`repro_torch.kernels.ref.flash_decode_paged_ref`, re-exported here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import flash_decode_paged_ref

__all__ = ["flash_decode_paged_cuda", "flash_decode_paged_ref"]

# what the kernel is instantiated for (csrc/flash_decode.cu)
HEAD_DIM = 128
GROUPS = (1, 2, 8)
Q_DTYPES = (torch.float32, torch.bfloat16)
#: logical KV blocks per split (128 positions at the block size of 16),
#: kSplitBlocks in csrc/flash_decode.cu
BLOCKS_PER_SPLIT = 8


def num_splits(max_blocks: int) -> int:
    """Splits per (row, KV head): split s owns logical blocks
    [8 s, 8 s + 8) of every row, so a row's keys are merged in the same
    order whatever the batch or the table's width, and choosing the count
    reads nothing back from the device."""
    return max(1, -(-max_blocks // BLOCKS_PER_SPLIT))


def flash_decode_paged_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                            v_pool: torch.Tensor,
                            block_tables: torch.Tensor,
                            lengths: Optional[torch.Tensor] = None, *,
                            scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,dh) f32 or bf16; k_pool, v_pool: (NB,BS,KV,dh) f32;
    block_tables: (B,MB) int32; lengths: (B,) int32 valid kv lengths
    (None = MB * BS; a length past MB * BS reads the whole table).
    Returns (B,H,dh) in q's dtype."""
    name = "flash_decode_paged"
    cuda_lib.require_cuda(name, q, k_pool, v_pool, block_tables, lengths)
    b, h, dh = q.shape
    nb, bs, kv = k_pool.shape[:3]
    mb = block_tables.shape[1]
    if tuple(k_pool.shape) != (nb, bs, kv, dh) or v_pool.shape != k_pool.shape:
        raise ValueError(f"{name}: pool shape {tuple(k_pool.shape)} does "
                         f"not fit q {tuple(q.shape)}")
    if kv == 0 or h % kv or h // kv not in GROUPS:
        raise ValueError(f"{name}: H/KV = {h}/{kv} must be one of {GROUPS}")
    if dh != HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} is not {HEAD_DIM}")
    if q.dtype not in Q_DTYPES or k_pool.dtype != torch.float32 or \
            v_pool.dtype != torch.float32:
        raise ValueError(f"{name}: q must be f32 or bf16 and the pool f32, "
                         f"got {q.dtype} / {k_pool.dtype} / {v_pool.dtype}")
    if block_tables.dtype != torch.int32 or block_tables.shape[0] != b:
        raise ValueError(f"{name}: block_tables must be (B, MB) int32")
    lib = cuda_lib.library()
    if lengths is None:
        lengths = torch.full((b,), mb * bs, dtype=torch.int32,
                             device=q.device)
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,):
        raise ValueError(f"{name}: lengths must be (B,) int32")
    for t in (q, k_pool, v_pool, block_tables, lengths):
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    splits = num_splits(mb)
    out = torch.empty_like(q)
    if b == 0:
        return out
    part_o = torch.empty((b, h, splits, dh), dtype=torch.float32,
                         device=q.device)
    part_m = torch.empty((b, h, splits), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    rc = lib.repro_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), part_o.data_ptr(),
        part_m.data_ptr(), part_l.data_ptr(), out.data_ptr(), b, kv,
        h // kv, dh, bs, mb, splits, float(scale),
        cuda_lib.DTYPE_CODES[q.dtype], cuda_lib.stream_ptr(q))
    cuda_lib.check(rc, name)
    cuda_lib.count_launch("flash_decode_paged")
    return out
