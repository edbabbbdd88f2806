"""Transformer layers of the port's dense path: norms, RoPE, GQA
projections, SwiGLU FFN, embeddings.

Counterparts of `repro.models.layers` with the same names, the same
parameter dicts and the same einsum layouts (``wq`` (d, H, dh), ``wo``
(H, dh, d), ``w_gate``/``w_up`` (d, f), ``tok`` (1, V, d)).  The norms go
through the fused norm kernel (`repro_torch.kernels.ops`); the large
matrix products are plain ``torch.matmul``.  ``attention_naive`` is the
paper's attention (batched GEMM, the fused mask + softmax kernel, batched
GEMM).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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
    return {
        "wq": dense_init(gen, (d, h, dh), d, dtype, device),
        "wk": dense_init(gen, (d, kv, dh), d, dtype, device),
        "wv": dense_init(gen, (d, kv, dh), d, dtype, device),
        "wo": dense_init(gen, (h, dh, d), h * dh, dtype, device),
    }


def init_ffn(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype,
             device: torch.device) -> Params:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": dense_init(gen, (d, f), d, dtype, device),
        "w_up": dense_init(gen, (d, f), d, dtype, device),
        "w_down": dense_init(gen, (f, d), f, dtype, device),
    }


def init_embedding(cfg: ModelConfig, gen: torch.Generator,
                   dtype: torch.dtype, device: torch.device) -> Params:
    p = {"tok": dense_init(gen, (1, cfg.vocab_size, cfg.d_model),
                           cfg.d_model, dtype, device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, (1, cfg.d_model, cfg.vocab_size),
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
    x2 = x.reshape(-1, shape[-1])
    r2 = None if residual is None else residual.reshape(-1, shape[-1])
    rr = residual is not None
    if cfg.norm == "layernorm":
        out = ops.fused_layernorm(x2, p["scale"], p["bias"], residual=r2,
                                  eps=eps, return_residual=rr)
    else:
        out = ops.fused_rmsnorm(x2, p["scale"], residual=r2, eps=eps,
                                return_residual=rr)
    if rr:
        return out[0].reshape(shape), out[1].reshape(shape)
    return out.reshape(shape)


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
    freqs = rope_freqs(x.shape[-1], theta, x.device)
    angles = positions[..., None].float() * freqs          # (B,S,half)
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def positions_for(cfg: ModelConfig, tokens_shape: Tuple[int, int],
                  offset: int = 0,
                  device: Optional[torch.device] = None) -> torch.Tensor:
    """Position ids (B, S) for a dense model: ``offset`` .. ``offset+S``."""
    b, s = tokens_shape
    base = torch.arange(s, dtype=torch.int32, device=device)[None, :] + \
        offset
    return base.expand(b, s)


def _rope_dispatch(cfg: ModelConfig, x, positions):
    if cfg.rope == "none":
        return x
    if cfg.rope != "rope":
        raise ValueError(f"rope={cfg.rope!r} is not served by the port yet")
    return apply_rope(x, positions, cfg.rope_theta)


# ---------------------------------------------------------------------------
# Attention (GQA) projections
# ---------------------------------------------------------------------------


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk") as one matmul."""
    d, n, k = w.shape
    y = torch.matmul(x, w.reshape(d, n * k))
    return y.reshape(x.shape[:-1] + (n, k))


def qkv_project(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor):
    """x: (B,S,d) -> q (B,S,H,dh), k/v (B,S,KV,dh) with rope applied."""
    if cfg.qk_norm:
        raise ValueError("qk_norm is not served by the port yet")
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    q = _rope_dispatch(cfg, q, positions)
    k = _rope_dispatch(cfg, k, positions)
    return q, k, v


def attention_output(p: Params, attn: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): attn (B,S,H,dh) -> (B,S,d)."""
    h, k, d = p["wo"].shape
    b, s = attn.shape[:2]
    return torch.matmul(attn.reshape(b, s, h * k), p["wo"].reshape(h * k, d))


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
    with V."""
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


def attention_packed(cfg: ModelConfig, q: torch.Tensor, k: torch.Tensor,
                     v: torch.Tensor, *, q_seg: torch.Tensor,
                     k_seg: torch.Tensor, q_pos: torch.Tensor,
                     k_pos: torch.Tensor) -> torch.Tensor:
    """Segment-masked causal attention of a packed prefill: q (1,Sq,H,dh)
    holds every segment's fresh tokens back to back, k/v (1,Sk,KV,dh) each
    segment's cached prefix followed by the fresh keys (the last Sq keys
    line up with the queries); ``q_seg`` / ``k_seg`` (Sq,) / (Sk,) carry
    the segment id per slot (negative = padding) and ``q_pos`` / ``k_pos``
    the position within the segment.  Key j is visible to query i iff both
    sit in one segment and ``k_pos[j] <= q_pos[i]``, or j is i's own fresh
    key.  Through the packed mode of the flash kernel; -> (1,Sq,H,dh)."""
    out = ops.flash_attention_packed(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2), q_seg, k_seg, q_pos,
                                     k_pos)
    return out.transpose(1, 2)


# ---------------------------------------------------------------------------
# Feed-forward
# ---------------------------------------------------------------------------


def apply_ffn(cfg: ModelConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.act != "swiglu":
        raise ValueError(f"act={cfg.act!r} is not served by the port yet")
    g = torch.matmul(x, p["w_gate"])
    u = torch.matmul(x, p["w_up"])
    return torch.matmul(F.silu(g) * u, p["w_down"])


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, p: Params,
                 tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B,S) -> (B,S,d)."""
    if tokens.dim() != 2:
        raise ValueError("codebook tokens are not served by the port yet")
    return p["tok"][0][tokens.long()]


def lm_logits(cfg: ModelConfig, p: Params, h: torch.Tensor) -> torch.Tensor:
    """h: (B,S,d) -> logits (B,S,V)."""
    if cfg.tie_embeddings:
        return torch.matmul(h, p["tok"][0].t())
    return torch.matmul(h, p["head"][0])
