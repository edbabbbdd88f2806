"""Optimizers: AdamW and Adafactor, with global-norm clipping.

Counterpart of `repro.training.optimizer`, with its formulas, its
defaults and its state trees (nested dicts of tensors: AdamW's ``m`` and
``v`` in ``state_dtype`` and an int32 ``step``; Adafactor's factored
second moments ``vr`` / ``vc`` of each matrix, or ``v`` of a vector, in
f32), so a state checkpoints through `repro_torch.runtime.checkpoint` in
the JAX package's leaves.  ``torch.optim`` is not used: its AdamW and
Adafactor order their arithmetic differently.

Where the JAX package returns new trees, :func:`apply_optimizer` writes
the new parameters and moments into the tensors it is given, under
``no_grad``, and returns the same trees; each leaf's update is
computed in f32 from the old values first, as there.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch

from repro_torch.distributed.sharding import constrain, is_dtensor


@dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"               # adamw | adafactor
    learning_rate: float = 3e-4
    weight_decay: float = 0.01
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    grad_clip_norm: float = 1.0
    # adafactor
    decay_rate: float = 0.8
    epsilon1: float = 1e-30
    epsilon2: float = 1e-3
    # memory knob: dtype of (m, v) moments for adamw
    state_dtype: str = "float32"


_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """Leaves of a nested dict in sorted-key order (the JAX package's
    flattening order)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Any, *rest: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def global_norm(tree: Any) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.float()))
    return torch.sqrt(total)


@torch.no_grad()
def clip_by_global_norm(tree: Any, max_norm: float
                        ) -> Tuple[Any, torch.Tensor]:
    """Scale ``tree``'s leaves in place to a global norm of at most
    ``max_norm``; returns the tree and its norm before."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    for g in tree_leaves(tree):
        g.mul_(scale.to(g.dtype))
    return tree, norm


def _step_f32(step: torch.Tensor) -> torch.Tensor:
    return step.to(torch.float32)


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def adamw_init(params: Any, cfg: OptimizerConfig) -> Dict[str, Any]:
    dt = _DTYPES[cfg.state_dtype]
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    leaf = tree_leaves(params)[0]
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


@torch.no_grad()
def adamw_update(params: Any, grads: Any, state: Dict[str, Any],
                 cfg: OptimizerConfig, lr=None):
    step = state["step"] + 1
    lr = cfg.learning_rate if lr is None else lr
    b1, b2 = cfg.beta1, cfg.beta2
    c1 = 1.0 - torch.pow(b1, _step_f32(step))
    c2 = 1.0 - torch.pow(b2, _step_f32(step))

    def upd(p, g, m, v):
        gf = g.float()
        m_new = b1 * m.float() + (1 - b1) * gf
        v_new = b2 * v.float() + (1 - b2) * gf * gf
        mhat = m_new / c1
        vhat = v_new / c2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)

    tree_map(upd, params, grads, state["m"], state["v"])
    state["step"].copy_(step)
    return params, state


# ---------------------------------------------------------------------------
# Adafactor
# ---------------------------------------------------------------------------


def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params: Any, cfg: OptimizerConfig) -> Dict[str, Any]:
    def init_leaf(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    leaf = tree_leaves(params)[0]
    return {"factored": tree_map(init_leaf, params),
            "step": torch.zeros((), dtype=torch.int32, device=leaf.device)}


def _placed_as(t: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``t`` redistributed to ``like``'s placements where both are
    DTensors (a pending sum reduced); else ``t``."""
    if is_dtensor(t) and is_dtensor(like) and \
            tuple(t.placements) != tuple(like.placements):
        return t.redistribute(like.device_mesh, like.placements)
    return t


@torch.no_grad()
def adafactor_update(params: Any, grads: Any, state: Dict[str, Any],
                     cfg: OptimizerConfig, lr=None):
    step = state["step"] + 1
    t = _step_f32(step)
    beta2t = 1.0 - torch.pow(t, -cfg.decay_rate)
    lr = cfg.learning_rate if lr is None else lr
    eps1 = cfg.epsilon1

    def upd(p, g, v):
        gf = g.float()
        g2 = gf * gf + eps1
        if _factored(p.shape):
            # over a mesh the statistics keep their own placements and
            # the row mean is replicated: each is a pending sum, which
            # DTensor would otherwise scatter over the stacked layer dim
            # (a dim the rules never shard), unevenly where it does not
            # divide
            vr = _placed_as(beta2t * v["vr"] + (1 - beta2t) * torch.mean(
                g2, dim=-1), v["vr"])
            vc = _placed_as(beta2t * v["vc"] + (1 - beta2t) * torch.mean(
                g2, dim=-2), v["vc"])
            denom = torch.clamp(constrain(
                torch.mean(vr, dim=-1, keepdim=True),
                *([None] * vr.dim())), min=eps1)
            vhat = (vr[..., None] * vc[..., None, :]) / denom[..., None]
            update = gf / torch.sqrt(vhat + eps1)
            v["vr"].copy_(vr)
            v["vc"].copy_(vc)
        else:
            vfull = beta2t * v["v"] + (1 - beta2t) * g2
            update = gf / torch.sqrt(vfull + eps1)
            v["v"].copy_(vfull)
        # relative step-size clipping (Adafactor's d=1 trick)
        rms = torch.sqrt(torch.mean(update * update) + eps1)
        update = update / torch.clamp(rms, min=1.0)
        pf = p.float()
        scale = lr * torch.clamp(torch.sqrt(torch.mean(torch.square(pf))),
                                 min=cfg.epsilon2)
        p.copy_(pf - scale * update - lr * cfg.weight_decay * pf)

    tree_map(upd, params, grads, state["factored"])
    state["step"].copy_(step)
    return params, state


# ---------------------------------------------------------------------------
# Uniform interface
# ---------------------------------------------------------------------------


def init_optimizer(params: Any, cfg: OptimizerConfig) -> Dict[str, Any]:
    if cfg.name == "adamw":
        return adamw_init(params, cfg)
    if cfg.name == "adafactor":
        return adafactor_init(params, cfg)
    raise ValueError(cfg.name)


def apply_optimizer(params: Any, grads: Any, state: Dict[str, Any],
                    cfg: OptimizerConfig, lr: Optional[Any] = None):
    """Clip ``grads`` (in place, where ``grad_clip_norm``), update
    ``params`` and ``state`` in place; returns ``(params, state, the
    gradients' global norm before clipping)``.  Runs in the profiler
    range ``repro_torch.optimizer``."""
    with torch.profiler.record_function("repro_torch.optimizer"):
        if cfg.grad_clip_norm:
            grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip_norm)
        else:
            with torch.no_grad():
                gnorm = global_norm(grads)
        if cfg.name == "adamw":
            params, state = adamw_update(params, grads, state, cfg, lr)
        else:
            params, state = adafactor_update(params, grads, state, cfg, lr)
    return params, state, gnorm
