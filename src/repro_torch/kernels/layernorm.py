"""Fused AddBias + Residual + {RMS,Layer}Norm: the Hopper kernel's wrapper.

Replaces the JAX package's `norm_pallas` (src/repro/kernels/layernorm.py).
The kernel is ``csrc/norm.cu`` (the row in registers, one 16-byte vector a
thread, a block a row); its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref` /
:func:`~repro_torch.kernels.ref.layernorm_ref`, re-exported here.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import layernorm_ref, rmsnorm_ref

__all__ = ["NormPlan", "layernorm_ref", "norm_cuda", "norm_plan",
           "rmsnorm_ref"]

#: widest row the kernel is built for
MAX_COLS = 12288
#: most threads a row, and the vectors a thread of rows wider than those
#: threads cover, as built
MAX_THREADS = 512
WIDE_VECTORS = (2, 4, 6)


class NormPlan(NamedTuple):
    """Which body of csrc/norm.cu covers a row: one block of ``threads``
    threads a row and ``vectors`` 16-byte vectors a thread."""
    threads: int
    vectors: int


def norm_plan(cols: int, dtype: torch.dtype) -> NormPlan:
    """The body for rows of ``cols`` elements of ``dtype``, by C alone
    (so a row's bits never depend on R): one 16-byte vector a thread,
    the threads a power of two from 32 to :data:`MAX_THREADS`; wider rows
    take 2, 4 or 6 vectors a thread.  Raises on a width the kernel is not
    built for."""
    vec = 16 // torch.empty((), dtype=dtype).element_size()
    if cols % vec or not 0 < cols <= MAX_COLS:
        raise ValueError(f"fused norm: C={cols} must be a multiple of "
                         f"{vec} and at most {MAX_COLS}")
    vectors = cols // vec
    threads = max(32, 1 << (vectors - 1).bit_length())
    if threads <= MAX_THREADS:
        return NormPlan(threads, 1)
    nv = next(n for n in WIDE_VECTORS if MAX_THREADS * n >= vectors)
    return NormPlan(MAX_THREADS, nv)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def norm_cuda(x: torch.Tensor, gamma: torch.Tensor,
              beta: Optional[torch.Tensor] = None,
              bias: Optional[torch.Tensor] = None,
              residual: Optional[torch.Tensor] = None, *, rms: bool,
              eps: float = 1e-6, return_residual: bool = False):
    """x, residual: (R, C); gamma, beta, bias: (C,), all one dtype (f32 or
    bf16) on one CUDA device.  Returns y, or (y, x + bias + residual)."""
    name = "fused_rmsnorm" if rms else "fused_layernorm"
    cuda_lib.require_cuda(name, x, gamma, beta, bias, residual)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (R, C), got {tuple(x.shape)}")
    r, c = x.shape
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if not rms and beta is None:
        raise ValueError("fused_layernorm needs beta")
    plan = norm_plan(c, x.dtype)
    for label, t, shape in (("gamma", gamma, (c,)),
                            ("beta", None if rms else beta, (c,)),
                            ("bias", bias, (c,)),
                            ("residual", residual, (r, c))):
        if t is None:
            continue
        if tuple(t.shape) != shape or t.dtype != x.dtype:
            raise ValueError(f"{name}: {label} must be {shape} "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    for t in (x, gamma, beta, bias, residual):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    lib = cuda_lib.library()
    y = torch.empty_like(x)
    s = torch.empty_like(x) if return_residual else None
    if r:
        rc = lib.repro_norm(x.data_ptr(), gamma.data_ptr(),
                            None if rms else beta.data_ptr(), _ptr(bias),
                            _ptr(residual), y.data_ptr(), _ptr(s), r, c,
                            float(eps), int(rms),
                            cuda_lib.DTYPE_CODES[x.dtype], plan.threads,
                            plan.vectors, cuda_lib.stream_ptr(x))
        cuda_lib.check(rc, name)
        cuda_lib.count_launch("norm")
    return (y, s) if return_residual else y
