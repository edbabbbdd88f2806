"""Fused AddBias + Residual + {RMS,Layer}Norm: the Hopper kernel's wrapper.

Replaces the JAX package's `norm_pallas` (src/repro/kernels/layernorm.py).
The kernel is ``csrc/norm.cu``; its plain version is
:func:`repro_torch.kernels.ref.rmsnorm_ref` /
:func:`~repro_torch.kernels.ref.layernorm_ref`, re-exported here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import cuda_lib
from repro_torch.kernels.ref import layernorm_ref, rmsnorm_ref

__all__ = ["layernorm_ref", "norm_cuda", "rmsnorm_ref"]

#: shared memory the kernel parks one f32 row in (the default 48 KB)
MAX_COLS = 48 * 1024 // 4


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
    vec = 16 // x.element_size()
    if c % vec or c > MAX_COLS:
        raise ValueError(f"{name}: C={c} must be a multiple of {vec} and "
                         f"at most {MAX_COLS}")
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
                            cuda_lib.DTYPE_CODES[x.dtype],
                            cuda_lib.stream_ptr(x))
        cuda_lib.check(rc, name)
        cuda_lib.count_launch("norm")
    return (y, s) if return_residual else y
