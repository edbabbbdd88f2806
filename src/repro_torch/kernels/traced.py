"""The kernel wrappers of `repro_torch.kernels.ops` as one graph node each.

A trace of the port's model (``make_fx``) sees through a wrapper: on the
CPU into its plain version's ATen ops, on the card into the ``torch.empty``
of its output alone, since the kernel is a ``ctypes`` call that no tracer
sees.  Inside :func:`traced_kernels` every wrapper of ``ops`` is replaced
by a call to a custom operator ``repro_torch::<name>`` that takes all the
wrapper's inputs and returns its outputs.  The operator's fake
implementation allocates the outputs as the card's wrapper does (the same
shapes, dtypes and strides on either device), so a trace on the CPU holds
the card's graph; its real implementation is the wrapper itself.  Under
grad the norm and softmax nodes run inside the same
``torch.autograd.Function`` as the wrappers
(`repro_torch.kernels.autograd`), so a traced train step carries their
plain-PyTorch gradients.

Only tracing enters this module: serving and classify call ``ops``
directly.  While a trace is open anywhere in the process, the names in
``ops`` are stand-ins that take the operator only on a thread inside
:func:`traced_kernels`, and the wrapper itself on every other thread.
Autograd runs a CUDA backward on a device thread of its own, so there a
checkpoint's recompute calls the wrappers themselves: a dispatch mode
(``FlopCounterMode``) over a card's step with ``remat`` sees the
recomputed kernels as no node.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, Iterator, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.distributed.sharding import is_dtensor
from repro_torch.kernels import autograd as _ag
from repro_torch.kernels import ops
from repro_torch.kernels.ref import PACKED_TILE, packed_plan_width

#: the wrappers of ``ops`` that launch a kernel, as ``ops`` defines them
WRAPPERS = ("fused_softmax", "fused_rmsnorm", "fused_layernorm",
            "fused_sample", "flash_attention", "flash_attention_packed",
            "flash_attention_packed_plan", "flash_decode",
            "flash_decode_paged")
NAMESPACE = "repro_torch"

_PLAIN = {name: getattr(ops, name) for name in WRAPPERS}
_LOCK = threading.Lock()
_OPS: Dict[str, object] = {}
_STATE = {"open": 0}               # traces open in the process
_LOCAL = threading.local()         # .depth: traces open on this thread


def _heads_major(q: Tensor) -> Tensor:
    """(B, Sq, H, dh) storage seen as q's (B, H, Sq, dh), as the flash
    kernels return their output."""
    b, h, sq, dh = q.shape
    return q.new_empty((b, sq, h, dh)).transpose(1, 2)


def _norm(x: Tensor, gamma: Tensor, beta: Optional[Tensor],
          bias: Optional[Tensor], residual: Optional[Tensor], eps: float,
          return_residual: bool):
    if beta is None:
        return _PLAIN["fused_rmsnorm"](x, gamma, bias, residual, eps=eps,
                                       return_residual=return_residual)
    return _PLAIN["fused_layernorm"](x, gamma, beta, bias, residual,
                                     eps=eps, return_residual=return_residual)


def _define() -> Dict[str, object]:
    """Register the custom operators once a process (on first use, never
    at import)."""
    lib = NAMESPACE

    @torch.library.custom_op(f"{lib}::fused_softmax", mutates_args=())
    def fused_softmax(x: Tensor, lengths: Optional[Tensor],
                      scale: float) -> Tensor:
        return _PLAIN["fused_softmax"](x, lengths, scale=scale)

    @fused_softmax.register_fake
    def _(x, lengths, scale):
        return torch.empty_like(x)

    @torch.library.custom_op(f"{lib}::fused_norm", mutates_args=())
    def fused_norm(x: Tensor, gamma: Tensor, beta: Optional[Tensor],
                   bias: Optional[Tensor], residual: Optional[Tensor],
                   eps: float) -> Tensor:
        return _norm(x, gamma, beta, bias, residual, eps, False)

    @fused_norm.register_fake
    def _(x, gamma, beta, bias, residual, eps):
        return torch.empty_like(x)

    @torch.library.custom_op(f"{lib}::fused_norm_residual", mutates_args=())
    def fused_norm_residual(x: Tensor, gamma: Tensor, beta: Optional[Tensor],
                            bias: Optional[Tensor], residual: Optional[Tensor],
                            eps: float) -> Tuple[Tensor, Tensor]:
        return _norm(x, gamma, beta, bias, residual, eps, True)

    @fused_norm_residual.register_fake
    def _(x, gamma, beta, bias, residual, eps):
        return torch.empty_like(x), torch.empty_like(x)

    @torch.library.custom_op(f"{lib}::fused_sample", mutates_args=())
    def fused_sample(logits: Tensor, temperature: Tensor, top_k: Tensor,
                     top_p: Tensor, gumbel: Tensor) -> Tensor:
        return _PLAIN["fused_sample"](logits, temperature, top_k, top_p,
                                      gumbel)

    @fused_sample.register_fake
    def _(logits, temperature, top_k, top_p, gumbel):
        return logits.new_empty((logits.shape[0],), dtype=torch.int32)

    @torch.library.custom_op(f"{lib}::flash_attention", mutates_args=())
    def flash_attention(q: Tensor, k: Tensor, v: Tensor,
                        lengths: Optional[Tensor], causal: bool,
                        scale: Optional[float]) -> Tensor:
        return _PLAIN["flash_attention"](q, k, v, lengths, causal=causal,
                                         scale=scale)

    @flash_attention.register_fake
    def _(q, k, v, lengths, causal, scale):
        return _heads_major(q)

    @torch.library.custom_op(f"{lib}::flash_attention_packed",
                             mutates_args=())
    def flash_attention_packed(q: Tensor, k: Tensor, v: Tensor,
                               q_seg: Tensor, k_seg: Tensor, q_pos: Tensor,
                               k_pos: Tensor, scale: Optional[float],
                               plan: Optional[Tensor]) -> Tensor:
        return _PLAIN["flash_attention_packed"](
            q, k, v, q_seg, k_seg, q_pos, k_pos, scale=scale, plan=plan)

    @flash_attention_packed.register_fake
    def _(q, k, v, q_seg, k_seg, q_pos, k_pos, scale, plan):
        return _heads_major(q)

    @torch.library.custom_op(f"{lib}::flash_attention_packed_plan",
                             mutates_args=())
    def flash_attention_packed_plan(q_seg: Tensor, k_seg: Tensor,
                                    q_pos: Tensor, k_pos: Tensor) -> Tensor:
        return _PLAIN["flash_attention_packed_plan"](q_seg, k_seg, q_pos,
                                                     k_pos)

    @flash_attention_packed_plan.register_fake
    def _(q_seg, k_seg, q_pos, k_pos):
        sq, sk = q_seg.shape[0], k_seg.shape[0]
        return q_seg.new_empty((-(-sq // PACKED_TILE), packed_plan_width(sk)),
                               dtype=torch.int32)

    @torch.library.custom_op(f"{lib}::flash_decode", mutates_args=())
    def flash_decode(q: Tensor, k: Tensor, v: Tensor,
                     lengths: Optional[Tensor],
                     scale: Optional[float]) -> Tensor:
        return _PLAIN["flash_decode"](q, k, v, lengths, scale=scale)

    @flash_decode.register_fake
    def _(q, k, v, lengths, scale):
        return torch.empty_like(q)

    @torch.library.custom_op(f"{lib}::flash_decode_paged", mutates_args=())
    def flash_decode_paged(q: Tensor, k_pool: Tensor, v_pool: Tensor,
                           block_tables: Tensor, lengths: Optional[Tensor],
                           scale: Optional[float]) -> Tensor:
        return _PLAIN["flash_decode_paged"](q, k_pool, v_pool, block_tables,
                                            lengths, scale=scale)

    @flash_decode_paged.register_fake
    def _(q, k_pool, v_pool, block_tables, lengths, scale):
        return torch.empty_like(q)

    return {"fused_softmax": fused_softmax, "fused_norm": fused_norm,
            "fused_norm_residual": fused_norm_residual,
            "fused_sample": fused_sample, "flash_attention": flash_attention,
            "flash_attention_packed": flash_attention_packed,
            "flash_attention_packed_plan": flash_attention_packed_plan,
            "flash_decode": flash_decode,
            "flash_decode_paged": flash_decode_paged}


def operators() -> Dict[str, object]:
    """The custom operators by name, registered at the first call."""
    with _LOCK:
        if not _OPS:
            _OPS.update(_define())
    return _OPS


def _as_nodes(o: Dict[str, object]) -> Dict[str, object]:
    """The wrappers of ``ops``, with their signatures, each as one call of
    its operator."""

    def softmax_node(x, lengths=None, *, scale: float = 1.0):
        return o["fused_softmax"](x, lengths, float(scale))

    def rmsnorm_node(x, gamma, bias=None, residual=None, *,
                     eps: float = 1e-6, return_residual: bool = False):
        op = o["fused_norm_residual" if return_residual else "fused_norm"]
        return op(x, gamma, None, bias, residual, float(eps))

    def layernorm_node(x, gamma, beta, bias=None, residual=None, *,
                       eps: float = 1e-6, return_residual: bool = False):
        op = o["fused_norm_residual" if return_residual else "fused_norm"]
        return op(x, gamma, beta, bias, residual, float(eps))

    # under grad the nodes run inside the wrappers' own Functions, so a
    # traced train step has ops' gradients (plain PyTorch, as in ``ops``)
    def fused_softmax(x, lengths=None, *, scale: float = 1.0):
        if _ag.needs_grad(x):
            return _ag.softmax(softmax_node, x, lengths, scale=scale)
        return softmax_node(x, lengths, scale=scale)

    def fused_rmsnorm(x, gamma, bias=None, residual=None, *,
                      eps: float = 1e-6, return_residual: bool = False):
        if _ag.needs_grad(x, gamma, bias, residual):
            return _ag.rmsnorm(rmsnorm_node, x, gamma, bias, residual,
                               eps=eps, return_residual=return_residual)
        return rmsnorm_node(x, gamma, bias, residual, eps=eps,
                            return_residual=return_residual)

    def fused_layernorm(x, gamma, beta, bias=None, residual=None, *,
                        eps: float = 1e-6, return_residual: bool = False):
        if _ag.needs_grad(x, gamma, beta, bias, residual):
            return _ag.layernorm(layernorm_node, x, gamma, beta, bias,
                                 residual, eps=eps,
                                 return_residual=return_residual)
        return layernorm_node(x, gamma, beta, bias, residual, eps=eps,
                              return_residual=return_residual)

    def fused_sample(logits, temperature, top_k, top_p, gumbel):
        return o["fused_sample"](logits, temperature, top_k, top_p, gumbel)

    def flash_attention(q, k, v, lengths=None, *, causal: bool = True,
                        scale: Optional[float] = None):
        return o["flash_attention"](q, k, v, lengths, bool(causal), scale)

    def flash_attention_packed(q, k, v, q_seg, k_seg, q_pos, k_pos, *,
                               scale: Optional[float] = None, plan=None):
        return o["flash_attention_packed"](q, k, v, q_seg, k_seg, q_pos,
                                           k_pos, scale, plan)

    def flash_attention_packed_plan(q_seg, k_seg, q_pos, k_pos):
        return o["flash_attention_packed_plan"](q_seg, k_seg, q_pos, k_pos)

    def flash_decode(q, k, v, lengths=None, *, scale=None):
        return o["flash_decode"](q, k, v, lengths, scale)

    def flash_decode_paged(q, k_pool, v_pool, block_tables, lengths=None, *,
                           scale=None):
        return o["flash_decode_paged"](q, k_pool, v_pool, block_tables,
                                       lengths, scale)

    return {name: fn for name, fn in locals().items() if name in WRAPPERS}


def _stand_in(name: str, via_operator):
    plain = _PLAIN[name]

    def fn(*args, **kwargs):
        # DTensors take the wrapper's own path, which calls the (stood-in)
        # wrapper again on each rank's shard
        if getattr(_LOCAL, "depth", 0) and not any(
                is_dtensor(a) for a in list(args) + list(kwargs.values())):
            return via_operator(*args, **kwargs)
        return plain(*args, **kwargs)
    fn.__name__ = fn.__qualname__ = name
    fn.__doc__ = plain.__doc__
    return fn


@contextlib.contextmanager
def traced_kernels() -> Iterator[None]:
    """While open, every kernel wrapper of ``ops`` called on this thread
    is one custom-operator call, so a trace records it as one node that
    reads all its inputs."""
    via = _as_nodes(operators())
    with _LOCK:
        if not _STATE["open"]:
            for name, fn in via.items():
                setattr(ops, name, _stand_in(name, fn))
        _STATE["open"] += 1
    _LOCAL.depth = getattr(_LOCAL, "depth", 0) + 1
    try:
        yield
    finally:
        _LOCAL.depth -= 1
        with _LOCK:
            _STATE["open"] -= 1
            if not _STATE["open"]:
                for name, fn in _PLAIN.items():
                    setattr(ops, name, fn)
