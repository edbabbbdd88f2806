"""Plain PyTorch versions of the port's kernels (the correctness oracles).

Each function mirrors `repro.kernels.ref` of the JAX package op for op,
including the variable-length masking, so the CPU tests can hold it
against the JAX oracle and ``chip_smoke.py`` can hold each Hopper kernel
against it on the card.  The serving path reaches these only for tensors
that lie on the CPU (see `repro_torch.kernels.ops`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch


def softmax_ref(x: torch.Tensor, lengths: Optional[torch.Tensor] = None,
                scale: float = 1.0) -> torch.Tensor:
    """Masked scaled softmax over the last dim. x: (R, C); lengths: (R,)
    valid columns (a length past C keeps every column).  x is scaled in
    f32; a row with no valid column gives zeros, not NaN; the output has
    x's dtype."""
    xf = x.float() * scale
    if lengths is not None:
        col = torch.arange(x.shape[-1], device=x.device)[None, :]
        xf = torch.where(col < lengths.to(x.device)[:, None], xf,
                         float("-inf"))
    m = xf.max(dim=-1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(xf - m)
    s = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    return (e / s).to(x.dtype)


def layernorm_ref(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  bias: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  eps: float = 1e-6, return_residual: bool = False):
    """Fused AddBias+Residual+LayerNorm. x,(residual): (R,C); bias: (C,).

    Uses the paper's Eq. 1 single-pass form Var = E(x^2) - E(x)^2.
    """
    s = x.float()
    if bias is not None:
        s = s + bias.float()
    if residual is not None:
        s = s + residual.float()
    mean = s.mean(dim=-1, keepdim=True)
    mean_sq = (s * s).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean_sq - mean * mean, min=0.0)
    y = (s - mean) * torch.rsqrt(var + eps)
    y = (y * gamma.float() + beta.float()).to(x.dtype)
    if return_residual:
        return y, s.to(x.dtype)
    return y


def rmsnorm_ref(x: torch.Tensor, gamma: torch.Tensor,
                bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None,
                eps: float = 1e-6, return_residual: bool = False):
    """Fused AddBias+Residual+RMSNorm. x,(residual): (R,C); bias: (C,)."""
    s = x.float()
    if bias is not None:
        s = s + bias.float()
    if residual is not None:
        s = s + residual.float()
    ms = (s * s).mean(dim=-1, keepdim=True)
    y = (s * torch.rsqrt(ms + eps) * gamma.float()).to(x.dtype)
    if return_residual:
        return y, s.to(x.dtype)
    return y


def sample_ref(logits: torch.Tensor, temperature: torch.Tensor,
               top_k: torch.Tensor, top_p: torch.Tensor,
               gumbel: torch.Tensor) -> torch.Tensor:
    """Fused sampling. logits: (B, V); temperature/top_k/top_p: (B,);
    gumbel: (B, C) pre-drawn per-row Gumbel noise.

    Candidate set = the top C = gumbel.shape[-1] temperature-scaled
    logits (ties: lowest index first).  top_k == 0 or top_k > C
    truncates to C.  The Gumbel-max trick over the kept candidates is an
    exact categorical draw from the renormalized top-k/top-p
    distribution.  Rows with temperature <= 0 return the plain argmax.
    """
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    c = gumbel.shape[-1]
    temp = torch.clamp(temperature.float(), min=1e-6)[:, None]
    scaled = logits.float() / temp
    # a stable descending sort orders ties by index, as lax.top_k does
    vals, idx = torch.sort(scaled, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :c], idx[:, :c]
    cand = torch.arange(c, device=logits.device)[None, :]
    k = torch.where(top_k > 0, top_k, c).clamp(1, c)[:, None]
    keep = cand < k
    neg_inf = torch.tensor(float("-inf"), device=logits.device)
    masked = torch.where(keep, vals, neg_inf)
    m = masked.max(dim=-1, keepdim=True).values
    e = torch.where(keep, torch.exp(masked - m), 0.0)
    probs = e / torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    # nucleus: keep the smallest high-probability set whose mass reaches
    # top_p (the crossing token is kept, so the set is never empty)
    exclusive = torch.cumsum(probs, dim=-1) - probs
    keep = keep & (exclusive < top_p.float()[:, None])
    pert = torch.where(keep, vals + gumbel.float(), neg_inf)
    choice = torch.argmax(pert, dim=-1)
    sampled = torch.gather(idx, 1, choice[:, None])[:, 0].to(torch.int32)
    return torch.where(temperature > 0, sampled, greedy)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        lengths: Optional[torch.Tensor] = None,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """q: (B,H,Sq,dh); k,v: (B,KV,Sk,dh); lengths: (B,) valid kv length.

    GQA: H = KV * G.  Causal alignment assumes the queries are the *last*
    Sq positions of the kv sequence: q row i attends kv j iff
    j <= (Sk - Sq + i).
    """
    b, h, sq, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kv, g, sq, dh).float()
    s = torch.einsum("bkgqd,bksd->bkgqs", qg, k.float()) * scale
    kpos = torch.arange(sk, device=q.device)
    mask = torch.ones((b, sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        qpos = torch.arange(sq, device=q.device) + (sk - sq)
        mask = mask & (kpos[None, None, :] <= qpos[None, :, None])
    if lengths is not None:
        mask = mask & (kpos[None, None, :] < lengths.to(q.device)[:, None,
                                                                  None])
    s = torch.where(mask[:, None, None], s, float("-inf"))
    m = s.max(dim=-1, keepdim=True).values
    m = torch.where(torch.isfinite(m), m, 0.0)
    e = torch.exp(s - m)
    den = torch.clamp(e.sum(dim=-1, keepdim=True), min=1e-30)
    w = (e / den).to(q.dtype)
    out = torch.einsum("bkgqs,bksd->bkgqd", w.float(), v.float())
    return out.to(q.dtype).reshape(b, h, sq, dh)


def flash_attention_packed_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_seg: torch.Tensor,
                               k_seg: torch.Tensor, q_pos: torch.Tensor,
                               k_pos: torch.Tensor,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Segment-masked attention of a packed prefill, as the JAX package's
    ``attention_packed``.  q: (1,H,Sq,dh); k,v: (1,KV,Sk,dh) with Sk >= Sq,
    the queries lining up with the last Sq keys; q_seg, q_pos: (Sq,) and
    k_seg, k_pos: (Sk,) int32 segment ids (negative = padding) and
    positions within the segment.

    Key j is visible to query i iff ``q_seg[i] == k_seg[j]`` and
    ``k_pos[j] <= q_pos[i]``, or j is i's own fresh key (``j - (Sk - Sq)
    == i``), which keeps every padding row finite.  GQA folds H onto KV;
    the softmax runs in f32."""
    b, h, sq, dh = q.shape
    kv, sk = k.shape[1], k.shape[2]
    if b != 1 or sk < sq:
        raise ValueError(f"packed attention takes one flat row with Sk >= "
                         f"Sq, got q {tuple(q.shape)}, k {tuple(k.shape)}")
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    qg = q[0].reshape(kv, g, sq, dh).float()
    s = torch.einsum("kgqd,ksd->kgqs", qg, k[0].float()) * scale
    same = q_seg[:, None] == k_seg[None, :]
    causal = k_pos[None, :] <= q_pos[:, None]
    keys = torch.arange(sk, device=q.device)
    self_key = (keys[None, :] - (sk - sq)) == \
        torch.arange(sq, device=q.device)[:, None]
    s = torch.where((same & causal) | self_key, s, float("-inf"))
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    w = (e / e.sum(dim=-1, keepdim=True)).to(q.dtype)
    out = torch.einsum("kgqs,ksd->kgqd", w.float(), v[0].float())
    return out.to(q.dtype).reshape(1, h, sq, dh)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a contiguous cache. q: (B,H,dh); k,v:
    (B,KV,S,dh), any strides; lengths: (B,) valid kv lengths (None = S).
    GQA folds H onto KV.  As the JAX package's ``ops.flash_decode`` on
    its ``xla`` path: the attention reference with one query."""
    out = flash_attention_ref(q[:, :, None, :], k, v, lengths,
                              causal=False, scale=scale)
    return out[:, :, 0]


def flash_decode_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention. q: (B,H,dh); k_pool,v_pool: (NB,BS,KV,dh);
    block_tables: (B,MB) physical block of each logical block; lengths:
    (B,) valid kv lengths.  Gathers each row's logical view through its
    table (as the JAX package's ``ops.flash_decode_paged`` does on its
    ``xla`` path) and runs the attention reference."""
    b, mb = block_tables.shape
    bs = k_pool.shape[1]
    tables = block_tables.long()
    k = k_pool[tables].reshape((b, mb * bs) + k_pool.shape[2:])
    v = v_pool[tables].reshape((b, mb * bs) + v_pool.shape[2:])
    out = flash_attention_ref(q[:, :, None, :], k.transpose(1, 2),
                              v.transpose(1, 2), lengths, causal=False,
                              scale=scale)
    return out[:, :, 0]
