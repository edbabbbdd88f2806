"""Transformer layers of the port's decoders: norms (qk-norm among them),
RoPE and M-RoPE, GQA projections, the SwiGLU and GELU FFNs, embeddings
and heads of one or K codebooks.

Counterparts of `repro.models.layers` with the same names, the same
parameter dicts and the same einsum layouts (``wq`` (d, H, dh), ``wo``
(H, dh, d), ``w_gate``/``w_up`` (d, f), ``tok`` (K, V, d), ``head`` (K,
d, V), K = max(num_codebooks, 1)).  The norms go
through the fused norm kernel (`repro_torch.kernels.ops`); the large
matrix products are plain ``torch.matmul``.  ``attention_naive`` is the
paper's attention (batched GEMM, the fused mask + softmax kernel, batched
GEMM); ``attention_chunked_train`` runs it a block of queries at a time
under activation checkpointing.  ``embed_tokens`` gathers through
``gather_rows``, whose gradient is the same on every run.

Over a mesh (`repro_torch.distributed`) the weights and activations are
DTensors and the activations are annotated with logical axes
(``constrain``) at the JAX package's points: q/k/v after rope, the
attention output, the FFN's hidden and output, the embedding and the
logits.  The kernels run on each rank's shard (`repro_torch.kernels.ops`);
the attention routes that are plain PyTorch around the softmax kernel run
on the local heads too; the embedding from a vocab-sharded table is a
vocab-parallel gather (each rank gathers its rows, the sum over ``model``
completes it).
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, from_local,
                                              from_local_like, fsdp_gathered,
                                              head_slices, is_dtensor,
                                              replicated_on, to_local)
from repro_torch.kernels import ops

Params = Dict[str, torch.Tensor]

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    if name not in DTYPES:
        raise ValueError(f"unsupported dtype {name!r}; the port runs "
                         f"{sorted(DTYPES)}")
    return DTYPES[name]


# ---------------------------------------------------------------------------
# Initialization
# ---------------------------------------------------------------------------


def dense_init(gen: torch.Generator, shape: Tuple[int, ...],
               in_axis_size: int, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    """Normal weights scaled by 1/sqrt(fan-in), drawn from ``gen`` (which
    must live on ``device``)."""
    scale = 1.0 / math.sqrt(max(in_axis_size, 1))
    w = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=device)
    return (w * scale).to(dtype)


def init_norm(cfg: ModelConfig, dim: int, dtype: torch.dtype,
              device: torch.device) -> Params:
    p = {"scale": torch.ones((dim,), dtype=dtype, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((dim,), dtype=dtype, device=device)
    return p


def init_attention(cfg: ModelConfig, gen: torch.Generator,
                   dtype: torch.dtype, device: torch.device) -> Params:
    d, h, kv, dh = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {
        "wq": dense_init(gen, (d, h, dh), d, dtype, device),
        "wk": dense_init(gen, (d, kv, dh), d, dtype, device),
        "wv": dense_init(gen, (d, kv, dh), d, dtype, device),
        "wo": dense_init(gen, (h, dh, d), h * dh, dtype, device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.ones((dh,), dtype=dtype, device=device)
        p["k_norm"] = torch.ones((dh,), dtype=dtype, device=device)
    return p


def init_ffn(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "w_gate": dense_init(gen, (d, f), d, dtype, device),
            "w_up": dense_init(gen, (d, f), d, dtype, device),
            "w_down": dense_init(gen, (f, d), f, dtype, device),
        }
    return {
        "w_up": dense_init(gen, (d, f), d, dtype, device),
        "b_up": torch.zeros((f,), dtype=dtype, device=device),
        "w_down": dense_init(gen, (f, d), f, dtype, device),
        "b_down": torch.zeros((d,), dtype=dtype, device=device),
    }


def init_embedding(cfg: ModelConfig, gen: torch.Generator,
                   dtype: torch.dtype, device: torch.device) -> Params:
    """``tok`` (K, V, d) and, untied, ``head`` (K, d, V): one table each
    per codebook (K = 1 for a token model)."""
    n_embed = max(cfg.num_codebooks, 1)
    p = {"tok": dense_init(gen, (n_embed, cfg.vocab_size, cfg.d_model),
                           cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (n_embed, cfg.d_model, cfg.vocab_size),
                               cfg.d_model, dtype, device)
    return p


# ---------------------------------------------------------------------------
# Normalization
# ---------------------------------------------------------------------------


def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
               eps: float = 1e-6, residual: Optional[torch.Tensor] = None):
    """RMSNorm or LayerNorm over the last dim through the fused norm
    kernel.  With ``residual`` the kernel adds it first and returns
    ``(norm(x + residual), x + residual)`` from one launch."""
    shape = x.shape
    rr = residual is not None
    if is_dtensor(x):       # the wrapper takes (..., C) shards whole
        if rr and tuple(x.placements) != tuple(residual.placements):
            x = x.redistribute(residual.device_mesh, residual.placements)
        x2, r2 = x, residual
        shape = None
    else:
        x2 = x.reshape(-1, shape[-1])
        r2 = None if residual is None else residual.reshape(-1, shape[-1])
    if cfg.norm == "layernorm":
        out = ops.fused_layernorm(x2, p["scale"], p["bias"], residual=r2,
                                  eps=eps, return_residual=rr)
    else:
        out = ops.fused_rmsnorm(x2, p["scale"], residual=r2, eps=eps,
                                return_residual=rr)
    if shape is None:
        return out
    if rr:
        return out[0].reshape(shape), out[1].reshape(shape)
    return out.reshape(shape)


def rms_norm_headwise(scale: torch.Tensor, x: torch.Tensor,
                      eps: float = 1e-6) -> torch.Tensor:
    """Per-head qk-norm (Qwen3/OLMoE): RMSNorm over the trailing head dim,
    through the fused norm kernel over rows of dh (f32 moments, output in
    x's dtype), as the JAX package's jnp ``rms_norm_headwise``."""
    if is_dtensor(x):
        return ops.fused_rmsnorm(x, scale, eps=eps)
    shape = x.shape
    y = ops.fused_rmsnorm(x.reshape(-1, shape[-1]), scale, eps=eps)
    return y.reshape(shape)


# ---------------------------------------------------------------------------
# Rotary embeddings
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) integer."""
    half = x.shape[-1] // 2
    freqs = replicated_on(rope_freqs(x.shape[-1], theta, x.device),
                          positions)
    angles = positions[..., None].float() * freqs          # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def mrope_sections(head_dim: int) -> Tuple[int, int, int]:
    """Split of half-dim across (temporal, height, width) à la Qwen2-VL."""
    half = head_dim // 2
    t = half - 2 * (half // 3)
    return (t, half // 3, half // 3)


def apply_mrope(x: torch.Tensor, positions: torch.Tensor,
                theta: float) -> torch.Tensor:
    """M-RoPE: x (B, S, H, dh); positions (3, B, S), the temporal, height
    and width streams.  Frequency i of the half dim takes its angle from
    the stream of its section (:func:`mrope_sections`)."""
    half = x.shape[-1] // 2
    freqs = replicated_on(rope_freqs(x.shape[-1], theta, x.device),
                          positions)
    t, h, _ = mrope_sections(x.shape[-1])
    # each frequency's stream, built on the device (no host copy, so a
    # CUDA graph captures it)
    idx = torch.arange(half, device=x.device)
    sel = replicated_on((idx >= t).long() + (idx >= t + h).long(),
                        positions)                        # (half,)
    angles = positions[..., None].float() * freqs        # (3,B,S,half)
    angle = angles.gather(0, sel.expand_as(angles[:1]))[0]  # (B,S,half)
    cos = torch.cos(angle)[:, :, None, :]
    sin = torch.sin(angle)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def positions_for(cfg: ModelConfig, tokens_shape: Tuple[int, int],
                  num_prefix_patches: int = 0, offset: int = 0,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Position ids: (B, S) ``offset`` .. ``offset + S``, or (3, B, S) for
    M-RoPE.  With an image prefix (M-RoPE), the first
    ``num_prefix_patches`` slots are a square patch grid at (t = 0, h =
    row, w = col), and text positions continue from 1 on all three
    streams, as the JAX package's stub front end lays them out."""
    b, s = tokens_shape
    idx = torch.arange(s, dtype=torch.int32, device=device)
    base = (idx[None, :] + offset).expand(b, s)
    if cfg.rope != "mrope":
        return base
    if num_prefix_patches:
        g = max(math.isqrt(num_prefix_patches), 1)
        is_img = idx < num_prefix_patches
        text = idx - num_prefix_patches + 1
        row = torch.where(is_img, idx // g, text)
        col = torch.where(is_img, idx % g, text)
        tpos = torch.where(is_img, torch.zeros_like(idx), text)
        pos3 = torch.stack([tpos, row, col])[:, None, :] + offset
        return pos3.expand(3, b, s)
    return base[None].expand(3, b, s)


def _rope_dispatch(cfg: ModelConfig, x, positions):
    if cfg.rope == "none":
        return x
    if cfg.rope == "mrope":
        return apply_mrope(x, positions, cfg.rope_theta)
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Attention (GQA) projections
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, n, k = w.shape
    y = torch.matmul(x, fsdp_gathered(w).reshape(d, n * k))
    if is_dtensor(y):
        # a shard of the merged (n * k) columns must hold whole heads
        from torch.distributed.tensor import Replicate, Shard
        last = Shard(y.dim() - 1)
        want = [Replicate() if p == last and n % y.device_mesh.shape[i]
                else p for i, p in enumerate(y.placements)]
        if want != list(y.placements):
            y = y.redistribute(y.device_mesh, want)
    return y.reshape(x.shape[:-1] + (n, k))


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor):
    """x: (B,S,d) -> q (B,S,H,dh), k/v (B,S,KV,dh) with qk-norm (where
    the config has it) and rope applied.  Over a mesh ``x`` is gathered
    whole along the sequence first (sequence parallelism's all-gather)."""
    x = constrain(x, "batch", None, "embed")
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    if cfg.qk_norm:
        q = rms_norm_headwise(p["q_norm"], q)
        k = rms_norm_headwise(p["k_norm"], k)
    q = _rope_dispatch(cfg, q, positions)
    k = _rope_dispatch(cfg, k, positions)
    q = constrain(q, "batch", None, "heads", None)
    k = constrain(k, "batch", None, "kv_heads", None)
    v = constrain(v, "batch", None, "kv_heads", None)
    return q, k, v


def attention_output(p: Params, attn: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): attn (B,S,H,dh) -> (B,S,d)."""
    h, k, d = p["wo"].shape
    b, s = attn.shape[:2]
    out = torch.matmul(attn.reshape(b, s, h * k),
                       fsdp_gathered(p["wo"]).reshape(h * k, d))
    return constrain(out, "batch", None, "embed")


def on_local_heads(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   name: str = "attention") -> torch.Tensor:
    """``fn(q, k, v)`` over (B,S,H,dh) / (B,S,KV,dh) DTensors run on each
    rank's batch rows and heads (the kv heads of its query heads), its
    output placed as ``q``; plain tensors go straight to ``fn``."""
    if not is_dtensor(q):
        return fn(q, k, v)
    ql, (kl, vl), _ = head_slices(name, q, (k, v), (), q_head=2,
                                  kv_head=2)
    out = torch.empty_like(ql) if ql.shape[2] == 0 else fn(ql, kl, vl)
    return from_local_like(out, q)


def attention_naive(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, *, causal: bool = True,
                    q_offset: int = 0) -> torch.Tensor:
    """q: (B,Sq,H,dh), k/v: (B,Sk,KV,dh) -> (B,Sq,H,dh).

    The scores are one ``torch.matmul`` in the activation dtype over a
    grouped (B, KV, G, ...) view of q (GQA without copying K), cast to
    f32; the masked, scaled softmax is the fused softmax kernel over the
    (B*H*Sq, Sk) rows, the causal mask given as each row's length
    ``q_pos + 1`` (key j is kept iff j <= q_pos, as the JAX package masks
    ``kpos <= qpos``); the weights are cast to q's dtype and multiplied
    with V.  Over a mesh it runs on the local heads (:func:`on_local_heads`)."""
    if is_dtensor(q):
        return on_local_heads(functools.partial(
            attention_naive, cfg, causal=causal, q_offset=q_offset), q, k, v,
            "attention_naive")
    b, sq, h, dh = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    g = h // kvh
    qg = q.reshape(b, sq, kvh, g, dh).permute(0, 2, 3, 1, 4)
    scores = torch.matmul(qg, k.permute(0, 2, 3, 1)[:, :, None])
    if causal:
        lengths = torch.arange(q_offset + 1, q_offset + sq + 1,
                               dtype=torch.int32, device=q.device)
        lengths = lengths.repeat(b * h)
    else:
        lengths = None
    w = ops.fused_softmax(scores.float().reshape(-1, sk), lengths,
                          scale=1.0 / math.sqrt(dh))
    w = w.to(q.dtype).reshape(b, kvh, g, sq, sk)
    out = torch.matmul(w, v.permute(0, 2, 1, 3)[:, :, None])
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dh)


def attention_chunked_train(cfg: ModelConfig, q: torch.Tensor,
                            k: torch.Tensor, v: torch.Tensor, *,
                            causal: bool = True,
                            q_block: int = 512) -> torch.Tensor:
    """Training-path blockwise attention: each block of ``q_block``
    queries is :func:`attention_naive` at its offset (scores in the
    activation dtype, cast to f32, the softmax kernel with each row's
    causal length, times V), wrapped in ``torch.utils.checkpoint``, so
    the backward recomputes one block's (q_block x Sk) scores at a time
    instead of keeping every block's.  The last block runs at its true
    length where the JAX package pads it (padded queries are dropped
    there).  Rows of at most the softmax kernel's width on the card."""
    sq = q.shape[1]
    q_block = min(q_block, sq)
    outs = []
    for s0 in range(0, sq, q_block):
        block = functools.partial(attention_naive, cfg, causal=causal,
                                  q_offset=s0)
        outs.append(checkpoint(block, q[:, s0:s0 + q_block], k, v,
                               use_reentrant=False))
    return torch.cat(outs, dim=1)


def attention_packed(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *, q_seg: torch.Tensor,
                     k_seg: torch.Tensor, q_pos: torch.Tensor,
                     k_pos: torch.Tensor,
                     plan: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Segment-masked causal attention of a packed prefill: q (1,Sq,H,dh)
    holds every segment's fresh tokens back to back, k/v (1,Sk,KV,dh) each
    segment's cached prefix followed by the fresh keys (the last Sq keys
    line up with the queries); ``q_seg`` / ``k_seg`` (Sq,) / (Sk,) carry
    the segment id per slot (negative = padding) and ``q_pos`` / ``k_pos``
    the position within the segment.  Key j is visible to query i iff both
    sit in one segment and ``k_pos[j] <= q_pos[i]``, or j is i's own fresh
    key.  Through the packed mode of the flash kernel, over the pack's
    tile ``plan`` (`repro_torch.kernels.ops.flash_attention_packed_plan`)
    where the caller built it once for every layer; -> (1,Sq,H,dh)."""
    out = ops.flash_attention_packed(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), q_seg, k_seg, q_pos,
                                     k_pos, plan=plan)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def apply_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """SwiGLU, or GELU with biases (the tanh form, ``jax.nn.gelu``'s
    default).  Over a mesh ``x`` is gathered whole along the sequence
    first."""
    x = constrain(x, "batch", None, "embed")
    w_up, w_down = fsdp_gathered(p["w_up"]), fsdp_gathered(p["w_down"])
    if cfg.act == "swiglu":
        g = torch.matmul(x, fsdp_gathered(p["w_gate"]))
        u = torch.matmul(x, w_up)
        h = constrain(F.silu(g) * u, "batch", None, "mlp")
        return constrain(torch.matmul(h, w_down), "batch", None, "embed")
    h = F.gelu(torch.matmul(x, w_up) + p["b_up"], approximate="tanh")
    h = constrain(h, "batch", None, "mlp")
    return constrain(torch.matmul(h, w_down) + p["b_down"], "batch", None,
                     "embed")


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


class _GatherRows(torch.autograd.Function):
    """``table[idx]`` whose backward sums each row's gradients without
    atomics: the indices' gradients are grouped by a stable sort and each
    group summed in order (``segment_reduce``), so a step's gradient is
    the same on every run.  Autograd's own backward of the lookup is an
    accumulating ``index_put_``, which adds on the card through atomics
    in no fixed order."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.shape, ctx.dtype = table.shape, table.dtype
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        flat = idx.reshape(-1)
        gf = g.reshape((flat.numel(),) + tuple(ctx.shape[1:])).float()
        rows, inverse, counts = torch.unique(flat, return_inverse=True,
                                             return_counts=True)
        order = torch.sort(inverse, stable=True).indices
        sums = torch.segment_reduce(gf[order], "sum", lengths=counts,
                                    axis=0)
        out = torch.zeros(ctx.shape, dtype=torch.float32, device=g.device)
        out.index_copy_(0, rows, sums)
        return out.to(ctx.dtype), None


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``table[idx]`` (idx int64); where ``table`` needs a gradient, one
    that is the same on every run (:class:`_GatherRows`)."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _GatherRows.apply(table, idx)
    return table[idx]


def _gather_sharded(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` of a (V, d) DTensor table: gathered whole on every
    mesh dim but those that shard its vocabulary (FSDP's gather), each
    rank gathers the rows it holds, the others zero, and the result is
    ``Partial`` over the vocab dims (the caller's ``constrain`` sums it:
    the vocab-parallel embedding).  ``ids`` (B, S) are a DTensor or a
    plain tensor, the same on every rank."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    from repro_torch.distributed.sharding import shard_offset
    mesh = table.device_mesh
    want = [p if p == Shard(0) else Replicate() for p in table.placements]
    table = table.redistribute(mesh, want)
    vocab_dims = [i for i, p in enumerate(want) if p == Shard(0)]
    ids = replicated_on(ids, table)
    id_pl = [Replicate() if i in vocab_dims else p
             for i, p in enumerate(ids.placements)]
    if any(p not in (Shard(0), Replicate()) for p in id_pl):
        raise ValueError(f"embed_tokens: ids placed {ids.placements}; "
                         "expected rows sharded or replicated")
    ids = ids.redistribute(mesh, id_pl)
    row_dims = [i for i, p in enumerate(id_pl) if p == Shard(0)]
    local = to_local(table, row_dims)
    v0 = shard_offset(table.shape, mesh, want, 0)
    il = ids.to_local().long() - v0
    inside = (il >= 0) & (il < local.shape[0])
    rows = gather_rows(local, torch.where(inside, il, 0)) * \
        inside[..., None].to(local.dtype)
    out_pl = [Partial() if i in vocab_dims else p
              for i, p in enumerate(id_pl)]
    return from_local(rows, mesh, out_pl,
                          tuple(ids.shape) + (table.shape[1],))


def _gather(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    if is_dtensor(table):
        return _gather_sharded(table, ids)
    return gather_rows(table, ids.long())


def embed_tokens(cfg: ModelConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B,S), or (B,K,S) for a codebook model, whose K codebook
    embeddings of a frame are summed in codebook order -> (B,S,d).  Over
    a mesh, from a vocab-sharded table (:func:`_gather_sharded`)."""
    if tokens.dim() == 2:
        h = _gather(p["tok"][0], tokens)
    else:
        h = _gather(p["tok"][0], tokens[:, 0])
        for i in range(1, tokens.shape[1]):
            h = h + _gather(p["tok"][i], tokens[:, i])
    return constrain(h, "batch", None, "embed")


def lm_logits(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """h: (B,S,d) -> logits (B,S,V), or (B,K,S,V) for a codebook model
    (one head a codebook)."""
    h = constrain(h, "batch", None, "embed")
    w = fsdp_gathered(p["tok"]).transpose(1, 2) if cfg.tie_embeddings \
        else fsdp_gathered(p["head"])
    if not cfg.num_codebooks:
        return constrain(torch.matmul(h, w[0]), "batch", None, "vocab")
    return constrain(torch.matmul(h[:, None], w[None]), "batch", None, None,
                     "vocab")
