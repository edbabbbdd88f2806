"""Top-k MoE with capacity-bounded sort-based dispatch.

Counterpart of `repro.models.moe` with the same names, parameter dict
(``router`` (d, E) in f32 whatever the model's dtype, ``w_gate``/``w_up``
(E, d, f), ``w_down`` (E, f, d)) and results.  Assignments are ranked
within their expert by a stable sort of the flat (token, k) order, so
earlier tokens win; those past the expert's capacity are dropped, and
the (E, cap, d) expert batch is built by a gather.  The tokens are split
into ``G`` dispatch groups with a capacity each, GShard's grouped
dispatch: ``G`` is the size of the mesh dims the batch is sharded over
(`repro_torch.distributed.axis_size`), 1 where that does not divide the
tokens and off a mesh, as in the JAX package.  Over a mesh the sort, the
scatters and the gathers run on each rank's own tokens (its groups), each
rank computes its shard of the experts, and the expert outputs are
gathered over the expert dim before the combine
(:func:`_apply_moe_sharded`).

Every shape here follows from the input's shape alone and nothing reads
a value back to the host, so the decode tick and the prefill cells
capture it as CUDA graphs.  Nothing adds in an unspecified order: the
combine sums each token's k contributions in k order in the activations'
dtype, as the JAX package's sequential scatter-add does, so a replay is
bit-equal to its eager body; in a training forward the two gathers
(tokens into the expert batch, expert rows back to tokens) go through
``gather_rows``, whose gradient adds without atomics.  The expert
products are plain batched matrix products, which the JAX package leaves
to XLA outside any Pallas kernel.

At decode a tick of B <= 8 rows never drops: the capacity is at least 8
(:func:`expert_capacity`) and each token picks k distinct experts, so no
expert gets more than B assignments.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import axis_size, constrain, is_dtensor
from repro_torch.models.layers import dense_init, gather_rows

Params = Dict[str, torch.Tensor]


def init_moe(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> Params:
    """The router in f32 (its logits are f32 products), the experts in
    ``dtype``."""
    if cfg.moe is None:
        raise ValueError(f"{cfg.name}: init_moe needs a MoE config")
    e, d, f = cfg.moe.num_experts, cfg.d_model, cfg.d_ff
    return {
        "router": dense_init(gen, (d, e), d, torch.float32, device),
        "w_gate": dense_init(gen, (e, d, f), d, dtype, device),
        "w_up": dense_init(gen, (e, d, f), d, dtype, device),
        "w_down": dense_init(gen, (e, f, d), f, dtype, device),
    }


def expert_capacity(cfg: ModelConfig, num_tokens: int) -> int:
    moe = cfg.moe
    cap = int(num_tokens * moe.top_k / moe.num_experts * moe.capacity_factor)
    return max(8, -(-cap // 8) * 8)   # round up to multiple of 8


def route(cfg: ModelConfig, p: Params, x2d: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x2d: (T, d) -> (weights (T,k) f32, expert_idx (T,k), aux_loss).

    The top k come from a stable descending sort, so tied probabilities
    go to the lower expert first, as ``lax.top_k`` orders them."""
    weights, idx, me, ce = _route_terms(cfg, p["router"], x2d)
    return weights, idx, _aux_loss(cfg, me, ce)


def _route_terms(cfg: ModelConfig, router: torch.Tensor, x2d: torch.Tensor):
    """(weights (T,k), expert_idx (T,k), mean router probability per
    expert, mean assignments per expert) of the tokens ``x2d``."""
    moe = cfg.moe
    logits = torch.matmul(x2d.float(), router.float())
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top.values[:, :moe.top_k]
    idx = top.indices[:, :moe.top_k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    experts = torch.arange(moe.num_experts, device=idx.device)
    ce = (idx[..., None] == experts).sum(dim=1).float().mean(dim=0)
    return weights, idx, probs.mean(dim=0), ce


def _aux_loss(cfg: ModelConfig, me: torch.Tensor, ce: torch.Tensor):
    """The load-balancing auxiliary loss (Switch-style)."""
    moe = cfg.moe
    return moe.num_experts * torch.sum(me * ce) / moe.top_k


def _dispatch_group(x2d: torch.Tensor, idx: torch.Tensor,
                    weights: torch.Tensor, e: int, cap: int,
                    dtype: torch.dtype):
    """One dispatch group: tokens (Tg,d) routed to an (E, cap) buffer.

    Returns (xin (E,cap,d), slot (Tg*k,), flat_token, flat_weight, keep).
    Dropped assignments all point at the overflow slot ``E*cap``; the
    table's entry there is written by several of them in no fixed order
    and is discarded."""
    tg, k = idx.shape
    n = tg * k
    dev = x2d.device
    flat_expert = idx.reshape(n)
    flat_weight = weights.reshape(n).to(dtype)
    flat_token = torch.arange(tg, device=dev)[:, None].expand(tg, k) \
        .reshape(n)
    # rank within expert via stable sort + cummax of run starts
    order = torch.sort(flat_expert, stable=True).indices
    sorted_expert = flat_expert[order]
    i = torch.arange(n, device=dev)
    is_start = torch.ones((n,), dtype=torch.bool, device=dev)
    is_start[1:] = sorted_expert[1:] != sorted_expert[:-1]
    run_start = torch.cummax(torch.where(is_start, i, 0), dim=0).values
    rank = torch.empty_like(i)
    rank[order] = i - run_start            # order is a permutation
    keep = rank < cap
    slot = torch.where(keep, flat_expert * cap + rank, e * cap)
    table = torch.full((e * cap + 1,), n, dtype=torch.long, device=dev)
    table[slot] = i
    table = table[:-1].reshape(e, cap)
    valid = table < n
    tok_for_slot = flat_token[torch.where(valid, table, 0)]
    xin = gather_rows(x2d, tok_for_slot) * valid[..., None].to(dtype)
    return xin, slot, flat_token, flat_weight, keep


def _combine_group(yflat: torch.Tensor, slot: torch.Tensor,
                   flat_token: torch.Tensor, flat_weight: torch.Tensor,
                   keep: torch.Tensor, tg: int, d: int,
                   dtype: torch.dtype) -> torch.Tensor:
    """Each token's k contributions, weighted, summed in k order in
    ``dtype``.  ``flat_token`` is ``repeat(arange(tg), k)``: token t's
    contributions are rows t*k .. t*k+k-1, so the JAX package's
    scatter-add over it is this sum, without an atomic."""
    contrib = gather_rows(yflat, slot) * flat_weight[:, None] * \
        keep.to(dtype)[:, None]
    contrib = contrib.reshape(tg, -1, d)
    out = contrib[:, 0]
    for j in range(1, contrib.shape[1]):
        out = out + contrib[:, j]
    return out


def _experts(w_gate, w_up, w_down, xin: torch.Tensor) -> torch.Tensor:
    """The SwiGLU experts over (E, G, cap, d) slots -> (E, G, cap, d):
    one batched product an expert over all its groups' slots."""
    e, g_, cap, d = xin.shape
    x3 = xin.reshape(e, g_ * cap, d)
    h = F.silu(torch.bmm(x3, w_gate)) * torch.bmm(x3, w_up)
    return torch.bmm(h, w_down).reshape(e, g_, cap, d)


def _dispatch_combine(cfg: ModelConfig, x2d: torch.Tensor,
                      idx: torch.Tensor, weights: torch.Tensor, groups: int,
                      experts) -> torch.Tensor:
    """Tokens (T, d) in ``groups`` equal groups, each dispatched to its
    own (E, cap) buffer, through ``experts`` ((E, G, cap, d) -> the same)
    and combined back -> (T, d)."""
    t, d = x2d.shape
    e = cfg.moe.num_experts
    tg = t // groups
    cap = expert_capacity(cfg, tg)
    parts = [_dispatch_group(x2d[i * tg:(i + 1) * tg],
                             idx[i * tg:(i + 1) * tg],
                             weights[i * tg:(i + 1) * tg], e, cap, x2d.dtype)
             for i in range(groups)]
    xin = torch.stack([pt[0] for pt in parts], dim=1)   # (E,G,cap,d)
    yexp = experts(xin)
    pad = torch.zeros((1, d), dtype=x2d.dtype, device=x2d.device)
    outs = []
    for i, (_, slot, flat_token, flat_weight, keep) in enumerate(parts):
        yflat = torch.cat([yexp[:, i].reshape(e * cap, d), pad])
        outs.append(_combine_group(yflat, slot, flat_token, flat_weight,
                                   keep, tg, d, x2d.dtype))
    return outs[0] if groups == 1 else torch.cat(outs)


def num_groups(num_tokens: int) -> int:
    """Dispatch groups of ``num_tokens`` tokens: the batch's mesh size, or
    1 where that does not divide them."""
    groups = axis_size("batch")
    return groups if num_tokens % groups == 0 else 1


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar).

    Every one of the B*S tokens is routed and takes capacity, padding
    included: the capacity follows from the tokens of a group, as in the
    JAX package."""
    if cfg.act != "swiglu":
        raise ValueError(f"act={cfg.act!r} is not served by the port yet")
    b, s, d = x.shape
    groups = num_groups(b * s)
    if is_dtensor(x):
        return _apply_moe_sharded(cfg, p, x, groups)
    x2d = x.reshape(b * s, d)
    weights, idx, aux = route(cfg, p, x2d)
    out = _dispatch_combine(
        cfg, x2d, idx, weights, groups,
        lambda xin: _experts(p["w_gate"], p["w_up"], p["w_down"], xin))
    return out.reshape(b, s, d), aux


def _apply_moe_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor,
                       groups: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`apply_moe` over a mesh.  ``x`` is placed with its batch
    over the batch's mesh dims (its rows of the groups) and replicated
    elsewhere; each rank routes and dispatches its own tokens, in its
    share of the ``groups``; the experts are sharded over ``model`` where
    their weights are (EP): each rank runs its experts over its groups'
    slots and the outputs are all-gathered over the expert dim before the
    combine.  The aux loss takes the global means.  The gradient of
    ``x`` through the dispatch is partial over the expert shards, and
    through the routing whole on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from repro_torch.distributed.sharding import from_local, to_local
    mesh = x.device_mesh
    b, s, d = x.shape
    e = cfg.moe.num_experts
    row_pl = [pl if pl == Shard(0) else Replicate() for pl in x.placements]
    x = x.redistribute(mesh, row_pl)
    row_dims = [i for i, pl in enumerate(row_pl) if pl == Shard(0)]
    shards = 1
    for i in row_dims:
        shards *= mesh.shape[i]
    if groups % shards:
        raise ValueError(f"apply_moe: {groups} dispatch groups over "
                         f"{shards} batch shards")
    ws = {}
    for k in ("w_gate", "w_up", "w_down"):
        w = p[k]
        w_pl = [pl if pl == Shard(0) else Replicate() for pl in w.placements]
        ws[k] = to_local(w.redistribute(mesh, w_pl), row_dims)
    expert_dims = [i for i, pl in enumerate(w_pl) if pl == Shard(0)]
    router = p["router"]
    router = to_local(router.redistribute(mesh, [Replicate()] * mesh.ndim),
                       row_dims)
    x_route = x.to_local().reshape(-1, d)
    x_disp = to_local(x, expert_dims).reshape(-1, d)
    weights, idx, me, ce = _route_terms(cfg, router, x_route)
    mean_pl = [Partial() if i in row_dims else Replicate()
               for i in range(mesh.ndim)]
    full = [Replicate()] * mesh.ndim
    me, ce = (from_local(v / shards, mesh, mean_pl, (e,))
              .redistribute(mesh, full) for v in (me, ce))
    aux = _aux_loss(cfg, me, ce)
    e_local = ws["w_gate"].shape[0]
    e0 = 0
    if expert_dims:
        from repro_torch.distributed.sharding import shard_offset
        e0 = shard_offset(p["w_gate"].shape, mesh, w_pl, 0)
    g_local = groups // shards

    def experts(xin):                                   # (E,G_l,cap,d)
        y = _experts(ws["w_gate"], ws["w_up"], ws["w_down"],
                     xin[e0:e0 + e_local])
        y_pl = [Shard(0) if i in expert_dims else
                Shard(1) if i in row_dims else Replicate()
                for i in range(mesh.ndim)]
        gathered = [Shard(1) if i in row_dims else Replicate()
                    for i in range(mesh.ndim)]
        shape = (e, groups) + tuple(y.shape[2:])
        return from_local(y, mesh, y_pl, shape).redistribute(
            mesh, gathered).to_local()

    out = _dispatch_combine(cfg, x_disp, idx, weights, g_local, experts)
    out = from_local(out.reshape(-1, s, d), mesh, row_pl, (b, s, d))
    return constrain(out, "batch", None, "embed"), aux
