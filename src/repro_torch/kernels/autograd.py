"""Gradients for the kernels that the train path runs.

The Hopper kernels are called through ``ctypes`` with raw pointers, so
their outputs carry no ``grad_fn``: a model trained through them would
silently leave every parameter upstream of a norm without a gradient.
The JAX package has no backward kernel either (it trains through jnp).
So each kernel the train path runs gets a ``torch.autograd.Function``
whose forward is the kernel's own dispatch (the kernel on CUDA, the
plain version on the CPU) and whose backward is plain PyTorch in f32:

- the norms (AddBias + Residual + RMSNorm or LayerNorm, paper Eq. 1):
  with ``s = x + bias + residual``, ``r = rsqrt(mean(s²) + eps)`` and
  ``u = g·γ`` the incoming gradient times the scale, RMSNorm's is
  ``ds = r·u − s·r³·mean(s·u)`` and LayerNorm's the usual ``x̂`` form;
  the gradient of the returned sum ``s`` (``return_residual``) is added
  to ``ds``, which is then the gradient of ``x``, of ``residual`` and,
  summed over rows, of ``bias``;
- the masked, scaled softmax: ``dx = scale · w · (g − Σ g·w)``, which is
  0 at masked columns and on empty rows, where ``w`` is 0.

`repro_torch.kernels.ops` takes a Function only when grad mode is on and
an input requires grad, so serving keeps its launches, graphs and bits.
Each backward runs in a profiler range (``repro_torch.norm_backward``,
``repro_torch.softmax_backward``), so a trace of a train step can list
their device time apart from the other elementwise kernels.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch


def needs_grad(*tensors: Optional[torch.Tensor]) -> bool:
    """Grad mode is on and some tensor requires grad."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)


def _sum_rows(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return t.sum(dim=0).to(like.dtype)


class _Norm(torch.autograd.Function):
    """``forward`` is the wrapper's own dispatch, called with the tensors
    and keyword arguments as given; ``return_residual`` outputs
    ``(y, s)``."""

    @staticmethod
    def forward(ctx, forward: Callable, rms: bool, eps: float,
                return_residual: bool, x, gamma, beta, bias, residual):
        ctx.rms, ctx.eps, ctx.rr = rms, eps, return_residual
        ctx.save_for_backward(x, gamma, beta, bias, residual)
        if rms:
            return forward(x, gamma, bias, residual, eps=eps,
                           return_residual=return_residual)
        return forward(x, gamma, beta, bias, residual, eps=eps,
                       return_residual=return_residual)

    @staticmethod
    @torch.profiler.record_function("repro_torch.norm_backward")
    def backward(ctx, gy, gs=None):
        x, gamma, beta, bias, residual = ctx.saved_tensors
        s = x.float()
        if bias is not None:
            s = s + bias.float()
        if residual is not None:
            s = s + residual.float()
        gyf = gy.float()
        u = gyf * gamma.float()
        if ctx.rms:
            r = torch.rsqrt((s * s).mean(dim=-1, keepdim=True) + ctx.eps)
            xhat = s * r
            ds = r * u - s * (r * r * r) * (s * u).mean(dim=-1, keepdim=True)
        else:
            mean = s.mean(dim=-1, keepdim=True)
            var = torch.clamp((s * s).mean(dim=-1, keepdim=True) -
                              mean * mean, min=0.0)
            r = torch.rsqrt(var + ctx.eps)
            xhat = (s - mean) * r
            ds = r * (u - u.mean(dim=-1, keepdim=True) -
                      xhat * (u * xhat).mean(dim=-1, keepdim=True))
        if ctx.rr and gs is not None:
            ds = ds + gs.float()
        need = ctx.needs_input_grad
        gx = ds.to(x.dtype) if need[4] else None
        ggamma = _sum_rows(gyf * xhat, gamma) if need[5] else None
        gbeta = _sum_rows(gyf, beta) if beta is not None and need[6] \
            else None
        gbias = _sum_rows(ds, bias) if bias is not None and need[7] \
            else None
        gres = ds.to(residual.dtype) if residual is not None and need[8] \
            else None
        return None, None, None, None, gx, ggamma, gbeta, gbias, gres


def rmsnorm(forward: Callable, x, gamma, bias=None, residual=None, *,
            eps: float = 1e-6, return_residual: bool = False):
    """``forward`` (the wrapper's dispatch, taking
    ``(x, gamma, bias, residual, eps=, return_residual=)``) with the
    gradient above."""
    return _Norm.apply(forward, True, eps, return_residual, x, gamma, None,
                       bias, residual)


def layernorm(forward: Callable, x, gamma, beta, bias=None, residual=None,
              *, eps: float = 1e-6, return_residual: bool = False):
    """As :func:`rmsnorm`, ``forward`` taking ``(x, gamma, beta, bias,
    residual, eps=, return_residual=)``."""
    return _Norm.apply(forward, False, eps, return_residual, x, gamma, beta,
                       bias, residual)


class _Softmax(torch.autograd.Function):

    @staticmethod
    def forward(ctx, forward: Callable, scale: float, x, lengths):
        w = forward(x, lengths, scale=scale)
        ctx.scale = scale
        ctx.save_for_backward(w)
        return w

    @staticmethod
    @torch.profiler.record_function("repro_torch.softmax_backward")
    def backward(ctx, g):
        (w,) = ctx.saved_tensors
        wf, gf = w.float(), g.float()
        dx = ctx.scale * wf * (gf - (gf * wf).sum(dim=-1, keepdim=True))
        return None, None, dx.to(w.dtype), None


def softmax(forward: Callable, x, lengths=None, *, scale: float = 1.0):
    """``forward`` (the wrapper's dispatch, taking ``(x, lengths,
    scale=)``) with the gradient above."""
    return _Softmax.apply(forward, scale, x, lengths)


def refuse_grad(name: str, *tensors: Optional[torch.Tensor]) -> None:
    """Raise where a wrapper without a gradient is called on inputs that
    need one: its output would silently carry none."""
    if needs_grad(*tensors):
        raise RuntimeError(
            f"{name} has no backward: its kernel's output would carry no "
            "gradient; the train path attends through attention_naive or "
            "attention_chunked_train")
