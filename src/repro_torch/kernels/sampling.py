"""Fused temperature / top-k / top-p / Gumbel sampling: the Hopper
kernel's wrapper.

Replaces the JAX package's `sample_pallas` (src/repro/kernels/sampling.py).
The kernel is ``csrc/sampling.cu``; its plain version is
:func:`repro_torch.kernels.ref.sample_ref`, re-exported here.  As in the
JAX package, the Gumbel noise is drawn outside the kernel
(`repro_torch.runtime.sampling`), so both versions consume identical
randomness.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import sample_ref

__all__ = ["MAX_CANDIDATES", "sample_chunks", "sample_cuda", "sample_ref"]

#: candidate slots per row the kernel can keep
MAX_CANDIDATES = 1024
#: blocks to aim for in the first launch: two per SM of an H100
TARGET_BLOCKS = 264
#: shared memory one block may take on Hopper (227 KB)
SMEM_LIMIT = 232448


def sample_chunks(rows: int, vocab: int, cands: int):
    """(chunks, chunk_len): how many slices each row is cut into.  Enough
    blocks to fill the card, but no more slices than ``sqrt(V / C)``
    (where the first launch peels ``V / chunks`` values per pass and the
    merge ``chunks * C``, the two balance), and both launches' shared
    memory (8 bytes per slice value, and 8 per candidate of every slice
    plus the merged set) within one block's limit.  Fixed by shapes
    alone."""
    max_len = SMEM_LIMIT // 8
    lo = -(-vocab // max_len)
    hi = max(SMEM_LIMIT // (8 * cands) - 1, 1)
    want = -(-TARGET_BLOCKS // max(rows, 1))
    chunks = min(want, math.ceil(math.sqrt(vocab / cands)))
    chunks = max(lo, min(chunks, hi))
    if chunks > hi:
        raise ValueError(f"fused_sample: V={vocab} with C={cands} "
                         "candidates does not fit one block's shared "
                         "memory")
    chunk_len = -(-vocab // chunks)
    return -(-vocab // chunk_len), chunk_len


def sample_cuda(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor,
                gumbel: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) f32; temperature, top_p: (B,) f32; top_k: (B,)
    int32; gumbel: (B, C) f32.  Returns (B,) int32 tokens."""
    name = "fused_sample"
    cuda_lib.require_cuda(name, logits, temperature, top_k, top_p, gumbel,
                          aligned=False)
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (B, V)")
    b, v = logits.shape
    c = gumbel.shape[-1]
    expect = ((logits, (b, v), torch.float32),
              (temperature, (b,), torch.float32),
              (top_k, (b,), torch.int32), (top_p, (b,), torch.float32),
              (gumbel, (b, c), torch.float32))
    for t, shape, dtype in expect:
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name}: expected {shape} {dtype}, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if not 1 <= c <= min(v, MAX_CANDIDATES):
        raise ValueError(f"{name}: C={c} candidates must be in "
                         f"[1, min(V, {MAX_CANDIDATES})]")
    lib = cuda_lib.library()
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    if b:
        chunks, chunk_len = sample_chunks(b, v, c)
        dev = logits.device
        part_v = torch.empty((b, chunks, c), dtype=torch.float32, device=dev)
        part_i = torch.empty((b, chunks, c), dtype=torch.int32, device=dev)
        greedy_v = torch.empty((b, chunks), dtype=torch.float32, device=dev)
        greedy_i = torch.empty((b, chunks), dtype=torch.int32, device=dev)
        rc = lib.repro_sample(logits.data_ptr(), temperature.data_ptr(),
                              top_k.data_ptr(), top_p.data_ptr(),
                              gumbel.data_ptr(), out.data_ptr(),
                              part_v.data_ptr(), part_i.data_ptr(),
                              greedy_v.data_ptr(), greedy_i.data_ptr(), b, v,
                              c, chunks, chunk_len,
                              cuda_lib.stream_ptr(logits))
        cuda_lib.check(rc, name)
        cuda_lib.count_launch("sample")
    return out
