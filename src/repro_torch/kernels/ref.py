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


#: query rows and keys per tile of the packed mode's plan
PACKED_TILE = 64
#: plan entry flag: the visited key tile is masked
PLAN_MASKED = 1 << 16


def packed_plan_width(sk: int) -> int:
    """Entries per row of a packed plan over ``sk`` keys: the count and
    one per key tile, rounded up to 16 bytes."""
    n_kt = -(-sk // PACKED_TILE)
    return -(-(n_kt + 1) // 4) * 4


def flash_attention_packed_plan_ref(q_seg: torch.Tensor, k_seg: torch.Tensor,
                                    q_pos: torch.Tensor,
                                    k_pos: torch.Tensor) -> torch.Tensor:
    """The tile plan of a packed attention: which key tiles each query
    tile visits, as the plan kernel decides it.  ``q_seg``, ``q_pos``
    (Sq,) and ``k_seg``, ``k_pos`` (Sk,) int32, Sk >= Sq, the queries at
    the last Sq keys; tiles of ``PACKED_TILE`` rows and keys.

    Returns (ceil(Sq / 64), `packed_plan_width` (Sk)) int32: row t holds
    the count n of key tiles that query tile t visits, then those tiles in
    ascending order, each ``PLAN_MASKED``-flagged where it is masked, then
    -1.  A query tile with no real row (id >= 0) visits nothing.  Else a
    key tile is visited where one of its keys is visible to a real row
    (one id, ``k_pos <= q_pos``) or it holds a row's own key; it is
    unmasked only where all 64 rows are real and carry one id, and all
    64 keys carry that id at positions at or below every row's."""
    t = PACKED_TILE
    sq, sk = q_seg.shape[0], k_seg.shape[0]
    if sk < sq:
        raise ValueError(f"packed plan needs Sk >= Sq, got {sq}, {sk}")
    n_qt, n_kt = -(-sq // t), -(-sk // t)
    dev = q_seg.device
    qs = torch.full((n_qt * t,), -1, dtype=torch.int64, device=dev)
    qp = torch.zeros((n_qt * t,), dtype=torch.int64, device=dev)
    qs[:sq], qp[:sq] = q_seg.long(), q_pos.long()
    ks = torch.full((n_kt * t,), -1, dtype=torch.int64, device=dev)
    kp = torch.zeros((n_kt * t,), dtype=torch.int64, device=dev)
    ks[:sk], kp[:sk] = k_seg.long(), k_pos.long()
    key_in = torch.arange(n_kt * t, device=dev) < sk
    real = qs >= 0                       # padding slots past Sq are -1
    seen = real[:, None] & key_in[None, :] & (qs[:, None] == ks[None, :]) \
        & (kp[None, :] <= qp[:, None])
    own = (torch.arange(n_kt * t, device=dev)[None, :] - (sk - sq)) == \
        torch.arange(n_qt * t, device=dev)[:, None]
    own &= (torch.arange(n_qt * t, device=dev) < sq)[:, None]
    visited = (seen | own).reshape(n_qt, t, n_kt, t).any(3).any(1)
    visited &= real.reshape(n_qt, t).any(1)[:, None]
    rows_s, rows_p = qs.reshape(n_qt, t), qp.reshape(n_qt, t)
    one_id = real.reshape(n_qt, t).all(1) & \
        (rows_s == rows_s[:, :1]).all(1)
    below = key_in[None, :] & (ks[None, :] == rows_s[:, :1]) & \
        (kp[None, :] <= rows_p.min(1).values[:, None])
    unmasked = one_id[:, None] & below.reshape(n_qt, n_kt, t).all(2)
    plan = torch.full((n_qt, packed_plan_width(sk)), -1, dtype=torch.int32,
                      device=dev)
    for r in range(n_qt):
        tiles = torch.nonzero(visited[r]).flatten()
        entries = tiles + torch.where(unmasked[r, tiles], 0, PLAN_MASKED)
        plan[r, 0] = tiles.numel()
        plan[r, 1:1 + tiles.numel()] = entries.to(torch.int32)
    return plan


def packed_plan_visits(plan: torch.Tensor, sq: int,
                       sk: int) -> torch.Tensor:
    """(Sq, Sk) bool: the pairs whose key tile the plan visits for the
    query's tile."""
    t = PACKED_TILE
    n_qt, n_kt = -(-sq // t), -(-sk // t)
    tiles = torch.zeros((n_qt, n_kt), dtype=torch.bool, device=plan.device)
    for r in range(n_qt):
        n = int(plan[r, 0])
        tiles[r, (plan[r, 1:1 + n] & (PLAN_MASKED - 1)).long()] = True
    return tiles.repeat_interleave(t, 0).repeat_interleave(t, 1)[:sq, :sk]


def flash_attention_packed_ref(q: torch.Tensor, k: torch.Tensor,
                               v: torch.Tensor, q_seg: torch.Tensor,
                               k_seg: torch.Tensor, q_pos: torch.Tensor,
                               k_pos: torch.Tensor,
                               scale: Optional[float] = None,
                               plan: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Segment-masked attention of a packed prefill, as the JAX package's
    ``attention_packed``.  q: (1,H,Sq,dh); k,v: (1,KV,Sk,dh) with Sk >= Sq,
    the queries lining up with the last Sq keys; q_seg, q_pos: (Sq,) and
    k_seg, k_pos: (Sk,) int32 segment ids (negative = padding) and
    positions within the segment.

    Key j is visible to query i iff ``q_seg[i] == k_seg[j]`` and
    ``k_pos[j] <= q_pos[i]``, or j is i's own fresh key (``j - (Sk - Sq)
    == i``), which keeps every padding row finite.  GQA folds H onto KV;
    the softmax runs in f32.  With a ``plan``
    (`flash_attention_packed_plan_ref`) only the pairs of the key tiles
    it visits are seen, as by the kernel, and a row that sees no key (a
    query tile of padding only) gives zeros."""
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
    mask = (same & causal) | self_key
    if plan is not None:
        mask = mask & packed_plan_visits(plan, sq, sk)
    s = torch.where(mask, s, float("-inf"))
    m = s.max(dim=-1, keepdim=True).values
    e = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0))
    den = e.sum(dim=-1, keepdim=True)
    w = (e / torch.where(den > 0, den, 1.0)).to(q.dtype)
    out = torch.einsum("kgqs,ksd->kgqd", w.float(), v[0].float())
    return out.to(q.dtype).reshape(1, h, sq, dh)


def flash_decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: Optional[torch.Tensor] = None,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Decode attention over a contiguous cache. q: (B,H,dh); k,v:
    (B,KV,S,dh) in any type (an f32 or a bf16 cache), any strides;
    lengths: (B,) valid kv lengths (None = S).  GQA folds H onto KV.  As
    the JAX package's ``ops.flash_decode`` on its ``xla`` path: the
    attention reference with one query, K and V cast to f32 before the
    products, as its Pallas kernel casts them."""
    out = flash_attention_ref(q[:, :, None, :], k.float(), v.float(),
                              lengths, causal=False, scale=scale)
    return out[:, :, 0]


def flash_decode_paged_ref(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: Optional[torch.Tensor] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Paged decode attention. q: (B,H,dh); k_pool,v_pool: (NB,BS,KV,dh)
    in any type; block_tables: (B,MB) physical block of each logical
    block; lengths: (B,) valid kv lengths.  Gathers each row's logical
    view through its table (as the JAX package's ``ops.flash_decode_paged``
    does on its ``xla`` path), casts it to f32 (as the Pallas kernel casts
    K and V) and runs the attention reference."""
    b, mb = block_tables.shape
    bs = k_pool.shape[1]
    tables = block_tables.long()
    k = k_pool[tables].reshape((b, mb * bs) + k_pool.shape[2:]).float()
    v = v_pool[tables].reshape((b, mb * bs) + v_pool.shape[2:]).float()
    out = flash_attention_ref(q[:, :, None, :], k.transpose(1, 2),
                              v.transpose(1, 2), lengths, causal=False,
                              scale=scale)
    return out[:, :, 0]
