"""Concrete sharding plans per (arch x input shape x mesh).

Counterpart of `repro.distributed.plan`: every parameter, optimizer
state, input and cache leaf gets a spec (a tuple of per-dim entries, see
`repro_torch.distributed.sharding`) under the logical rules:

 - TP over ``model``: attention heads, FFN hidden, vocab, experts (EP),
   mamba d_inner;
 - FSDP over ``data``: the d_model dim of every weight matrix (ZeRO-3
   parameter and optimizer-state sharding);
 - DP over (``pod``, ``data``) for batch dims;
 - decode caches: batch over ``data`` when it divides, kv heads over
   ``model`` when they divide, else the head dim (``kv_dh_shard``), else
   the *sequence* over the remaining dims (context parallelism).

Every spec passes through :func:`_fit`, which drops entries that do not
divide their dim (28 heads on model 16 replicate), so one table covers
every architecture.  The trees are the port's nested dicts, whose keys
are the JAX package's; :func:`to_shardings` turns a spec tree into
``(mesh, placements)`` leaves and :func:`distribute` places a tree of
tensors by one.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Tuple

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (ShardingRules, axes_size,
                                              placements)

Axis = Any
Spec = Tuple[Any, ...]


def _fit(rules: ShardingRules, shape: Tuple[int, ...], *logical: Axis
         ) -> Spec:
    """Logical axes -> spec, dropping entries that do not divide their
    dim exactly (these specs place arguments, not activations, so
    ``rules.uneven`` does not apply) or that reuse a mesh dim."""
    spec = rules.spec(*logical)
    fixed = []
    used = set()
    for dim, part in zip(shape, spec):
        size = axes_size(rules.mesh, part)
        names = part if isinstance(part, tuple) else (part,)
        keep = (part is not None and size > 1 and dim % size == 0 and
                not any(a in used for a in names))
        if keep:
            fixed.append(part)
            used.update(names)
        else:
            fixed.append(None)
    return tuple(fixed)


# ---------------------------------------------------------------------------
# Parameter specs (leaf name -> logical axes)
# ---------------------------------------------------------------------------

# leaf name -> logical axes for its *unstacked* rank
_PARAM_AXES = {
    "tok": (None, "vocab", "fsdp"),            # (K, V, d)
    "head": (None, "fsdp", "vocab"),           # (K, d, V)
    "wq": ("fsdp", "heads", None),             # (d, H, dh)
    "wk": ("fsdp", "kv_heads", None),
    "wv": ("fsdp", "kv_heads", None),
    "wo": ("heads", None, "fsdp"),             # (H, dh, d)
    "q_norm": (None,),
    "k_norm": (None,),
    "w_gate": ("fsdp", "mlp"),                 # (d, f)
    "w_up": ("fsdp", "mlp"),
    "w_down": ("mlp", "fsdp"),                 # (f, d)
    "b_up": ("mlp",),
    "b_down": (None,),
    "router": ("fsdp", "expert"),              # (d, E)
    "scale": (None,),
    "bias": (None,),
    "in_proj": ("fsdp", "ssm_inner"),          # (d, 2di)
    "conv_w": (None, "ssm_inner"),             # (k, di)
    "conv_b": ("ssm_inner",),
    "out_proj": ("ssm_inner", "fsdp"),         # (di, d)
    "x_proj": ("ssm_inner", None),             # (di, r+2n)
    "dt_proj": (None, "ssm_inner"),            # (r, di)
    "dt_w": ("ssm_inner", None),               # (di, H)
    "dt_bias": (None,),
    "A_log": (None, None),                     # (di, n) replicated (small)
    "D": (None,),
}

# MoE expert tensors carry a leading E dim (EP) instead of TP on f.
_MOE_AXES = {
    "w_gate": ("expert", "fsdp", None),        # (E, d, f)
    "w_up": ("expert", "fsdp", None),
    "w_down": ("expert", None, "fsdp"),        # (E, f, d)
}


def _param_logical(path: Tuple[str, ...], ndim: int) -> Tuple[Axis, ...]:
    name = path[-1]
    if "moe" in path and name in _MOE_AXES:
        axes = _MOE_AXES[name]
    elif name in _PARAM_AXES:
        axes = _PARAM_AXES[name]
    else:
        axes = (None,) * ndim
    if "layers" in path:
        axes = (None,) + tuple(axes)
    # pad/trim to rank (mamba's A_log (di, n) against mamba2's (H,))
    if len(axes) < ndim:
        axes = tuple(axes) + (None,) * (ndim - len(axes))
    return tuple(axes[:ndim])


def _map_with_path(fn: Callable, tree: Any, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    return fn(path, tree)


def _leaves_with_path(tree: Any, path: Tuple[str, ...] = ()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, path + (str(k),))
    else:
        yield path, tree


def param_specs(rules: ShardingRules, abstract_params: Any) -> Any:
    """The spec of every parameter leaf (any tree of tensors, meta ones
    included: only shapes are read)."""
    return _map_with_path(
        lambda path, leaf: _fit(rules, tuple(leaf.shape),
                                *_param_logical(path, len(leaf.shape))),
        abstract_params)


def state_specs(rules: ShardingRules, abstract_state: Any) -> Any:
    """Train-state (params + optimizer) specs: AdamW's moments take their
    parameter's spec; Adafactor's ``vr`` / ``vc`` drop its last / second
    to last entry, each kept only where it still divides."""
    flat_param = {"/".join(p): s for p, s in _leaves_with_path(
        param_specs(rules, abstract_state["params"]))}

    def spec(path, leaf):
        if path[0] == "params":
            return flat_param["/".join(path[1:])]
        if path[0] == "opt":
            if path[1] in ("m", "v"):
                return flat_param["/".join(path[2:])]
            if path[1] == "factored":
                kind = path[-1]            # vr | vc | v
                pspec = flat_param.get("/".join(path[2:-1]))
                if pspec is None:
                    return ()
                parts = list(pspec)
                if kind == "vr":
                    parts = parts[:-1]
                elif kind == "vc":
                    parts = parts[:-2] + parts[-1:]
                return tuple(
                    p if (p is not None and
                          dim % axes_size(rules.mesh, p) == 0) else None
                    for dim, p in zip(leaf.shape, parts))
        return ()
    return _map_with_path(spec, abstract_state)


# ---------------------------------------------------------------------------
# Input / cache specs
# ---------------------------------------------------------------------------


def batch_specs(rules: ShardingRules, specs_tree: Any) -> Any:
    """Train / prefill batch inputs: dim 0 (the global batch) over DP."""
    return _map_with_path(
        lambda _, leaf: _fit(rules, tuple(leaf.shape), "batch",
                             *([None] * (len(leaf.shape) - 1))),
        specs_tree)


def decode_specs(rules: ShardingRules, cfg: ModelConfig, cache_tree: Any,
                 tok_spec: Any) -> Tuple[Any, Any]:
    """Cache and token specs of a decode step.  K/V (L, B, S, KV, dh):
    batch x kv heads where both divide; else batch x the head dim under
    ``kv_dh_shard``; else batch x ``kv_seq``; without a batch shard,
    context parallelism: the sequence over every mesh dim."""
    mesh = rules.mesh
    data = axes_size(mesh, rules.physical("batch"))
    model = axes_size(mesh, rules.physical("heads"))

    def spec(path, leaf):
        name = path[-1]
        shape = tuple(leaf.shape)
        if name in ("len", "pos_offset"):
            return _fit(rules, shape, "batch")
        if name in ("k", "v", "shared_k", "shared_v"):
            b, s, kv, dh = shape[1], shape[2], shape[3], shape[4]
            batch_ok = b % max(data, 1) == 0 and data > 1
            heads_ok = model > 1 and kv % max(model, 1) == 0
            if batch_ok and heads_ok:
                return _fit(rules, shape, None, "batch", None, "kv_heads",
                            None)
            if batch_ok and model > 1 and dh % model == 0 and \
                    rules.rules.get("kv_dh_shard"):
                # the head dim: a decode write stays shard-local
                return (None, rules.spec("batch")[0], None, None,
                        rules.physical("heads"))
            if batch_ok:
                return _fit(rules, shape, None, "batch", "kv_seq", None,
                            None)
            seq_axes = tuple(mesh.mesh_dim_names)
            total = math.prod(axes_size(mesh, a) for a in seq_axes)
            if s % total == 0:
                return (None, None, seq_axes, None, None)
            return _fit(rules, shape, None, None, None, None, None)
        if name == "conv":
            return _fit(rules, shape, None, "batch", None, "ssm_inner")
        if name == "state":
            if cfg.ssm and cfg.ssm.variant == "mamba1":
                return _fit(rules, shape, None, "batch", "ssm_inner", None)
            return _fit(rules, shape, None, "batch", "heads", None, None)
        return _fit(rules, shape, *([None] * len(shape)))

    cache_spec = _map_with_path(spec, cache_tree)
    tspec = _map_with_path(
        lambda _, leaf: _fit(rules, tuple(leaf.shape), "batch",
                             *([None] * (len(leaf.shape) - 1))), tok_spec)
    return cache_spec, tspec


def to_shardings(rules: ShardingRules, spec_tree: Any) -> Any:
    """A spec tree -> a tree of ``(mesh, placements)``."""
    if isinstance(spec_tree, dict):
        return {k: to_shardings(rules, v) for k, v in spec_tree.items()}
    return rules.mesh, placements(rules.mesh, spec_tree)


def distribute(tree: Any, shardings: Any) -> Any:
    """Each tensor of ``tree`` as a DTensor placed by the matching
    ``(mesh, placements)`` of ``shardings`` (:func:`to_shardings`).  The
    tensor is the global value, the same on every rank; a DTensor is
    redistributed instead."""
    from torch.distributed.tensor import DTensor, distribute_tensor
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    mesh, pl = shardings
    if isinstance(tree, DTensor):
        return tree.redistribute(mesh, pl)
    return distribute_tensor(tree, mesh, pl)


def gather(tree: Any) -> Any:
    """Each DTensor of ``tree`` as its full tensor (plain tensors pass)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: gather(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    return tree


def local(tree: Any) -> Any:
    """Each DTensor of ``tree`` as this rank's shard (plain tensors
    pass)."""
    from torch.distributed.tensor import DTensor
    if isinstance(tree, dict):
        return {k: local(v) for k, v in tree.items()}
    if isinstance(tree, DTensor):
        return tree.to_local()
    return tree
