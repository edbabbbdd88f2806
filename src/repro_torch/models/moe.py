"""Top-k MoE with capacity-bounded sort-based dispatch.

Counterpart of `repro.models.moe` with the same names, parameter dict
(``router`` (d, E) in f32 whatever the model's dtype, ``w_gate``/``w_up``
(E, d, f), ``w_down`` (E, f, d)) and results.  Assignments are ranked
within their expert by a stable sort of the flat (token, k) order, so
earlier tokens win; those past the expert's capacity are dropped, and
the (E, cap, d) expert batch is built by a gather.  The port has no
mesh, so there is one dispatch group (the JAX package's ``G`` is 1 on a
single device).

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
    moe = cfg.moe
    logits = torch.matmul(x2d.float(), p["router"].float())
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights = top.values[:, :moe.top_k]
    idx = top.indices[:, :moe.top_k]
    weights = weights / torch.clamp(weights.sum(dim=-1, keepdim=True),
                                    min=1e-9)
    # load-balancing auxiliary loss (Switch-style)
    me = probs.mean(dim=0)
    experts = torch.arange(moe.num_experts, device=idx.device)
    ce = (idx[..., None] == experts).sum(dim=1).float().mean(dim=0)
    aux = moe.num_experts * torch.sum(me * ce) / moe.top_k
    return weights, idx, aux


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


def apply_moe(cfg: ModelConfig, p: Params, x: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B,S,d) -> (out (B,S,d), aux_loss scalar).

    Every one of the B*S tokens is routed and takes capacity, padding
    included: the capacity follows from B*S, as in the JAX package."""
    moe = cfg.moe
    if cfg.act != "swiglu":
        raise ValueError(f"act={cfg.act!r} is not served by the port yet")
    b, s, d = x.shape
    t = b * s
    e = moe.num_experts
    x2d = x.reshape(t, d)
    weights, idx, aux = route(cfg, p, x2d)
    cap = expert_capacity(cfg, t)
    xin, slot, flat_token, flat_weight, keep = _dispatch_group(
        x2d, idx, weights, e, cap, x.dtype)             # xin: (E,cap,d)
    # expert FFN: (E,cap,d) x (E,d,f)
    g = torch.bmm(xin, p["w_gate"])
    u = torch.bmm(xin, p["w_up"])
    yexp = torch.bmm(F.silu(g) * u, p["w_down"])        # (E,cap,d)
    yflat = torch.cat([yexp.reshape(e * cap, d),
                       torch.zeros((1, d), dtype=x.dtype, device=x.device)])
    out = _combine_group(yflat, slot, flat_token, flat_weight, keep, t, d,
                         x.dtype)
    return out.reshape(b, s, d), aux
