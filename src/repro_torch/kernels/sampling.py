"""Fused temperature / top-k / top-p / Gumbel sampling: the Hopper
kernel's wrapper.

Replaces the JAX package's `sample_pallas` (src/repro/kernels/sampling.py).
The kernel is ``csrc/sampling.cu``: one launch, one thread-block cluster
per row, a radix select of the C-th largest scaled logit through
distributed shared memory.  Its plain version is
:func:`repro_torch.kernels.ref.sample_ref`, re-exported here.  As in the
JAX package, the Gumbel noise is drawn outside the kernel
(`repro_torch.runtime.sampling`), so both versions consume identical
randomness.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import sample_ref

__all__ = ["MAX_CANDIDATES", "SamplePlan", "sample_cuda", "sample_plan",
           "sample_ref"]

#: candidate slots per row the kernel can keep
MAX_CANDIDATES = 1024
#: blocks in one row's cluster, 8 the portable size, and the radix digit
#: width (``kCluster`` and ``kDigitBits`` in csrc/sampling.cu)
CLUSTER = 8
DIGIT_BITS = 8
#: dynamic shared memory a block may ask for: Hopper's 227 KB a block,
#: less 1 KB kept for the kernel's static shared memory
SMEM_LIMIT = 232448 - 1024
#: a block's slice length must stay below 2**16 (packed 16-bit counts)
MAX_SLICE = 65535


class SamplePlan(NamedTuple):
    """How the kernel covers (rows, vocab): grid (cluster, rows), each
    block a slice of ``slice_len`` values, ``smem_bytes`` of dynamic
    shared memory a block (the slice's uint32 keys and uint16 positions,
    two histograms of ``2**DIGIT_BITS`` counts, and, for the candidates
    padded to a power of two, their values and indices, sorted values and
    indices, and noise)."""
    rows: int
    cluster: int
    slice_len: int
    smem_bytes: int


def sample_plan(rows: int, vocab: int, cands: int) -> SamplePlan:
    """The kernel's plan for ``rows`` rows of ``vocab`` logits keeping
    ``cands`` candidates, fixed by shapes alone.  The slice length is a
    multiple of 8 elements, so every slice starts 16-byte aligned in f32
    and bf16.  Raises where a slice does not fit one block."""
    cluster = CLUSTER
    per = -(-vocab // cluster)
    slice_len = -(-per // 8) * 8
    pow2 = 1 << max(cands - 1, 0).bit_length()
    smem = slice_len * 6 + 2 * (1 << DIGIT_BITS) * 4 + pow2 * 20
    if smem > SMEM_LIMIT or slice_len > MAX_SLICE:
        raise ValueError(f"fused_sample: V={vocab} over a cluster of "
                         f"{cluster} gives slices of {slice_len} values "
                         f"({smem} bytes of shared memory), more than one "
                         f"block holds ({SMEM_LIMIT})")
    return SamplePlan(rows, cluster, slice_len, smem)


def sample_cuda(logits: torch.Tensor, temperature: torch.Tensor,
                top_k: torch.Tensor, top_p: torch.Tensor,
                gumbel: torch.Tensor) -> torch.Tensor:
    """logits: (B, V) f32 or bf16; temperature, top_p: (B,) f32; top_k:
    (B,) int32; gumbel: (B, C) f32.  Returns (B,) int32 tokens."""
    name = "fused_sample"
    cuda_lib.require_cuda(name, logits, temperature, top_k, top_p, gumbel,
                          aligned=False)
    if logits.dim() != 2:
        raise ValueError(f"{name}: logits must be (B, V)")
    if logits.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"{name}: logits must be f32 or bf16, got "
                         f"{logits.dtype}")
    b, v = logits.shape
    c = gumbel.shape[-1]
    expect = ((logits, (b, v), logits.dtype),
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
    plan = sample_plan(b, v, c)
    lib = cuda_lib.library()
    out = torch.empty((b,), dtype=torch.int32, device=logits.device)
    if b:
        rc = lib.repro_sample(logits.data_ptr(), temperature.data_ptr(),
                              top_k.data_ptr(), top_p.data_ptr(),
                              gumbel.data_ptr(), out.data_ptr(), b, v, c,
                              plan.slice_len, plan.smem_bytes,
                              cuda_lib.DTYPE_CODES[logits.dtype],
                              cuda_lib.stream_ptr(logits))
        cuda_lib.check(rc, name)
        cuda_lib.count_launch("sample")
    return out
