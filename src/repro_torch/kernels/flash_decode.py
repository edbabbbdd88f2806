"""Split-K decode attention over a paged pool or a contiguous cache: the
Hopper kernel's wrappers.

Replace the JAX package's `flash_decode_paged_pallas` and
`flash_decode_pallas` (src/repro/kernels/flash_decode.py).  Both launch
``csrc/flash_decode.cu``; their plain versions are
:func:`repro_torch.kernels.ref.flash_decode_paged_ref` and
:func:`~repro_torch.kernels.ref.flash_decode_ref`, re-exported here.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import flash_decode_paged_ref, flash_decode_ref

__all__ = ["flash_decode_cuda", "flash_decode_paged_cuda",
           "flash_decode_paged_ref", "flash_decode_ref"]

# what the kernel is instantiated for (csrc/flash_decode.cu)
HEAD_DIM = 128
GROUPS = (1, 2, 8)
Q_DTYPES = (torch.float32, torch.bfloat16)
#: logical KV blocks per split (128 positions at the block size of 16),
#: kSplitBlocks in csrc/flash_decode.cu
BLOCKS_PER_SPLIT = 8
#: keys per split of the contiguous layout (kSplitKeys): the keys of 8
#: blocks of 16, so both layouts split a row at the same keys
SPLIT_KEYS = 128


def num_splits(max_blocks: int) -> int:
    """Splits per (row, KV head): split s owns logical blocks
    [8 s, 8 s + 8) of every row, so a row's keys are merged in the same
    order whatever the batch or the table's width, and choosing the count
    reads nothing back from the device."""
    return max(1, -(-max_blocks // BLOCKS_PER_SPLIT))


def _check_heads(name: str, q: torch.Tensor, kv: int, dh: int) -> None:
    h = q.shape[1]
    if kv == 0 or h % kv or h // kv not in GROUPS:
        raise ValueError(f"{name}: H/KV = {h}/{kv} must be one of {GROUPS}")
    if dh != HEAD_DIM:
        raise ValueError(f"{name}: head dim {dh} is not {HEAD_DIM}")


#: per (device, stream): the zeroed int32 tickets of the in-launch split
#: merge, one per (row, KV head); the kernel leaves them 0 again
_TICKETS: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def _tickets(q: torch.Tensor, n: int) -> torch.Tensor:
    """At least ``n`` zeroed tickets for q's device and current stream,
    allocated once and grown on demand (the kernel resets what it takes,
    so a captured launch finds them zero on replay)."""
    key = (q.device, cuda_lib.stream_ptr(q))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < n:
        size = max(n, 1024, 2 * buf.numel() if buf is not None else 0)
        buf = torch.zeros(size, dtype=torch.int32, device=q.device)
        _TICKETS[key] = buf
    return buf


def _launch_buffers(q: torch.Tensor, kv: int, splits: int):
    """The output, one scratch of per-split partials (unnormalised output,
    max and sum of each query head) and the tickets."""
    b, h, dh = q.shape
    out = torch.empty_like(q)
    part = torch.empty(b * kv * splits * (h // kv) * (dh + 2),
                       dtype=torch.float32, device=q.device)
    return out, part, _tickets(q, b * kv)


def flash_decode_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      lengths: Optional[torch.Tensor] = None, *,
                      scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,dh) f32 or bf16, contiguous; k, v: (B,KV,S,dh) f32 views
    with one shared layout, any strides with the head dim unit-stride and
    every dh-vector 16-byte aligned (the cache's (B,S,KV,dh) layer slice
    transposed is such a view: it is read in place, never copied);
    lengths: (B,) int32 valid kv lengths (None = S; a length past S reads
    the whole cache).  Returns (B,H,dh) in q's dtype."""
    name = "flash_decode"
    cuda_lib.require_cuda(name, q, k, v, lengths)
    b, h, dh = q.shape
    kv, s = k.shape[1], k.shape[2]
    if tuple(k.shape) != (b, kv, s, dh) or v.shape != k.shape:
        raise ValueError(f"{name}: k/v shape {tuple(k.shape)} does not "
                         f"fit q {tuple(q.shape)}")
    _check_heads(name, q, kv, dh)
    if q.dtype not in Q_DTYPES or k.dtype != torch.float32 or \
            v.dtype != torch.float32:
        raise ValueError(f"{name}: q must be f32 or bf16 and k/v f32, "
                         f"got {q.dtype} / {k.dtype} / {v.dtype}")
    if k.stride() != v.stride() or k.stride(3) != 1 or \
            any(st % 4 for st in k.stride()[:3]):
        raise ValueError(f"{name}: k and v must share one layout with a "
                         f"unit-stride head dim and 16-byte rows, got "
                         f"strides {k.stride()} / {v.stride()}")
    if not q.is_contiguous():
        raise ValueError(f"{name}: q must be contiguous")
    lib = cuda_lib.library()
    if lengths is None:
        lengths = torch.full((b,), s, dtype=torch.int32, device=q.device)
    if lengths.dtype != torch.int32 or tuple(lengths.shape) != (b,) or \
            not lengths.is_contiguous():
        raise ValueError(f"{name}: lengths must be (B,) int32")
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    splits = max(1, -(-s // SPLIT_KEYS))
    out, part, tickets = _launch_buffers(q, kv, splits)
    if b == 0:
        return out
    sb, sh, ss = k.stride()[:3]
    rc = lib.repro_contiguous_decode(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
        part.data_ptr(), tickets.data_ptr(), out.data_ptr(), b, kv,
        h // kv, dh, s, sb, sh, ss, splits,
        float(scale), cuda_lib.DTYPE_CODES[q.dtype], cuda_lib.stream_ptr(q))
    cuda_lib.check(rc, name)
    cuda_lib.count_launch("flash_decode")
    return out


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
    _check_heads(name, q, kv, dh)
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
    out, part, tickets = _launch_buffers(q, kv, splits)
    if b == 0:
        return out
    rc = lib.repro_paged_decode(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lengths.data_ptr(), part.data_ptr(),
        tickets.data_ptr(), out.data_ptr(), b, kv, h // kv, dh, bs, mb,
        splits, float(scale),
        cuda_lib.DTYPE_CODES[q.dtype], cuda_lib.stream_ptr(q))
    cuda_lib.check(rc, name)
    cuda_lib.count_launch("flash_decode_paged")
    return out
