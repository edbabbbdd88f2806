"""Masked, scaled row softmax: the Hopper kernel's wrapper.

Replaces the JAX package's `softmax_pallas`
(src/repro/kernels/softmax.py).  The kernel is ``csrc/softmax.cu``; its
plain version is :func:`repro_torch.kernels.ref.softmax_ref`, re-exported
here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import softmax_ref

__all__ = ["softmax_cuda", "softmax_ref"]

#: the widest row the kernel takes (one warp per row, values in registers)
MAX_COLS = 1024


def softmax_cuda(x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                 *, scale: float = 1.0) -> torch.Tensor:
    """x: (R, C) f32 or bf16, C <= 1024, contiguous; lengths: (R,) int32
    valid columns (None = all; a length past C keeps every column).
    Returns softmax(x * scale) over the valid columns, zeros past them, in
    x's dtype."""
    name = "fused_softmax"
    cuda_lib.require_cuda(name, x, lengths, aligned=False)
    if x.dim() != 2:
        raise ValueError(f"{name}: x must be (R, C), got {tuple(x.shape)}")
    r, c = x.shape
    if x.dtype not in cuda_lib.DTYPE_CODES:
        raise ValueError(f"{name}: unsupported dtype {x.dtype}")
    if not 0 < c <= MAX_COLS:
        raise ValueError(f"{name}: rows of {c} columns; the kernel takes "
                         f"1 to {MAX_COLS}")
    if lengths is not None and (lengths.dtype != torch.int32 or
                                tuple(lengths.shape) != (r,)):
        raise ValueError(f"{name}: lengths must be (R,) int32")
    for t in (x, lengths):
        if t is not None and not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    lib = cuda_lib.library()
    out = torch.empty_like(x)
    if r:
        # 16-byte accesses when every row starts on a 16-byte boundary
        vec = int(c * x.element_size() % 16 == 0 and x.data_ptr() % 16 == 0
                  and out.data_ptr() % 16 == 0)
        rc = lib.repro_softmax(
            x.data_ptr(), None if lengths is None else lengths.data_ptr(),
            out.data_ptr(), r, c, float(scale),
            cuda_lib.DTYPE_CODES[x.dtype], vec, cuda_lib.stream_ptr(x))
        cuda_lib.check(rc, name)
        cuda_lib.count_launch("softmax")
    return out
