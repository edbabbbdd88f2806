"""Mamba1 (selective scan) and Mamba2 (scalar-decay multihead / SSD)
blocks of the port.

Counterpart of `repro.models.ssm`, with the same parameter dicts and the
same computation.  A prompt pass runs the *chunked* scan: the sequence is
cut into chunks of ``chunk_size`` steps; within a chunk the recurrence
``h_t = a_t * h_{t-1} + bx_t`` is an inclusive scan of the pairs ``(a,
bx)`` under the combine ``(a1 * a2, a2 * b1 + b2)``, run in log-depth
(Hillis–Steele: ``ceil(log2 c)`` rounds of elementwise products over the
whole chunk, where the JAX package calls ``lax.associative_scan``), and
the state carries from chunk to chunk in a Python loop (its
``lax.scan``).  The last chunk runs at its true length: the JAX package
pads it with steps of ``dt = 0`` (decay 1, input 0), which leave every
real position's value and the carried state as they are.  Mamba2 also
has the SSD form (``ssm.ssd_matmul``): within a chunk the scalar-decay
recurrence is two matrix products per head.  A decode step is one
recurrence step over ``(conv_state, ssm_state)``.  The scan and the step
are plain torch, as the JAX package's are jnp (there is no Pallas kernel
of them).  Over a mesh the Mamba-1 prompt pass constrains ``xs`` to
``ssm_inner`` as the JAX package does and runs per channel on each rank's
shard (:func:`_apply_mamba_sharded`); Mamba-2 and the decode step over a
mesh are not ported (they raise).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.sharding import (constrain, from_local,
                                              fsdp_gathered, is_dtensor,
                                              shard_offset, to_local)
from repro_torch.models.layers import dense_init

Params = Dict[str, torch.Tensor]


def dt_rank(cfg: ModelConfig) -> int:
    return -(-cfg.d_model // 16)


def num_ssm_heads(cfg: ModelConfig) -> int:
    return cfg.d_inner // cfg.ssm.head_dim


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> Params:
    """One block's weights in ``dtype``, drawn from ``gen`` (which must
    live on ``device``); ``A_log``, ``D`` and ``dt_bias`` are f32, as in
    the JAX package."""
    ssm = cfg.ssm
    d, di, n = cfg.d_model, cfg.d_inner, ssm.state_dim
    f32 = dict(dtype=torch.float32, device=device)
    p: Params = {
        "in_proj": dense_init(gen, (d, 2 * di), d, dtype, device),
        "conv_w": dense_init(gen, (ssm.conv_kernel, di), ssm.conv_kernel,
                             dtype, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), di, dtype, device),
    }
    if ssm.variant == "mamba1":
        r = dt_rank(cfg)
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand((di,), generator=gen, **f32) * (hi - lo) + lo
        p.update({
            "x_proj": dense_init(gen, (di, r + 2 * n), di, dtype, device),
            "dt_proj": dense_init(gen, (r, di), r, dtype, device),
            "dt_bias": torch.log(torch.expm1(
                torch.clamp(torch.exp(u), min=1e-4))),
            "A_log": torch.log(torch.arange(1, n + 1, **f32)).expand(
                di, n).contiguous(),
            "D": torch.ones((di,), **f32),
        })
    else:  # mamba2
        h = num_ssm_heads(cfg)
        p.update({
            "bc_proj": dense_init(gen, (di, 2 * n), di, dtype, device),
            "dt_w": dense_init(gen, (di, h), di, dtype, device),
            "dt_bias": torch.zeros((h,), **f32),
            "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
            "D": torch.ones((h,), **f32),
        })
    return p


# ---------------------------------------------------------------------------
# Shared pieces
# ---------------------------------------------------------------------------


def _causal_conv(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over time. x: (B,S,di)."""
    k = p["conv_w"].shape[0]
    xpad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(xpad[:, i:i + x.shape[1], :] * p["conv_w"][i]
              for i in range(k))
    return out + p["conv_b"]


def _conv_step(p: Params, conv_state: torch.Tensor, x_t: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """conv_state: (B, k-1, di); x_t: (B, di) -> (new_state, out).  The
    window is taken in ``x_t``'s dtype, as the prompt pass convolves: the
    state only ever holds earlier ``x_t`` values, so the cast is exact."""
    window = torch.cat([conv_state.to(x_t.dtype), x_t[:, None, :]], dim=1)
    out = torch.einsum("bkd,kd->bd", window, p["conv_w"]) + p["conv_b"]
    return window[:, 1:], out


def _linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``(a, b)`` pairs along axis 1 under the combine
    ``(a1 * a2, a2 * b1 + b2)`` (the earlier pair first): the ``b`` half
    of the result, the recurrence ``h_t = a_t * h_{t-1} + b_t`` from
    ``h_{-1} = 0``.  Log-depth (Hillis–Steele): in round ``d`` = 1, 2, 4,
    ... every position ``t >= d`` combines with ``t - d``.  ``a`` may
    broadcast against ``b`` in its trailing dims.  Each round writes a
    second buffer (``b + a * b`` shifted as one fused ``addcmul``) and
    the two swap, so a round reads each operand once and writes once
    (``a`` and ``b`` themselves are overwritten).  Where grad mode is on
    and ``a`` or ``b`` requires grad (autograd refuses ``out=`` there),
    each round builds fresh tensors from the same ops in the same order,
    bit for bit the same result."""
    c = a.shape[1]
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        d = 1
        while d < c:
            b = torch.cat([b[:, :d], torch.addcmul(b[:, d:], a[:, d:],
                                                   b[:, :-d])], dim=1)
            if 2 * d < c:
                a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
            d *= 2
        return b
    b_next, a_next = torch.empty_like(b), torch.empty_like(a)
    d = 1
    while d < c:
        torch.addcmul(b[:, d:], a[:, d:], b[:, :-d], out=b_next[:, d:])
        b_next[:, :d] = b[:, :d]
        b, b_next = b_next, b
        if 2 * d < c:
            torch.mul(a[:, d:], a[:, :-d], out=a_next[:, d:])
            a_next[:, :d] = a[:, :d]
            a, a_next = a_next, a
        d *= 2
    return b


def _chunk_scan(a: torch.Tensor, bx: torch.Tensor, h0: torch.Tensor,
                log_a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t * h_{t-1} + bx_t over the chunk's time axis (axis=1).

    a, bx: (B, c, ...), overwritten unless they need a gradient
    (:func:`_linear_scan`); h0: (B, ...). Returns (h_all
    (B,c,...), h_last).  ``log_a`` = log of a (for the stable cumulative
    product exp(cumsum)).
    """
    h_zero = _linear_scan(a, bx)
    cum_a = torch.exp(torch.cumsum(log_a, dim=1))
    h_all = torch.addcmul(h_zero, cum_a, h0[:, None])
    return h_all, h_all[:, -1]


def _chunks(s: int, chunk: int):
    """(start, end) of each chunk of a length-``s`` sequence; the last
    one runs at its true length."""
    return [(i, min(i + chunk, s)) for i in range(0, s, chunk)]


# ---------------------------------------------------------------------------
# Mamba1 selective scan
# ---------------------------------------------------------------------------


def _same(t: torch.Tensor) -> torch.Tensor:
    return t


def _mamba1_inner(cfg: ModelConfig, p: Params, xc: torch.Tensor,
                  h0: torch.Tensor, contract=_same
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B,S,di) post-conv post-silu; h0: (B,di,N). Chunked scan.
    ``contract`` completes the one product over the channels (x_proj):
    the identity on one device, a sum over the channel shards on a
    mesh."""
    n = cfg.ssm.state_dim
    r = dt_rank(cfg)
    proj = contract(torch.matmul(xc, p["x_proj"]))
    dt = F.softplus(torch.matmul(proj[..., :r], p["dt_proj"]).float()
                    + p["dt_bias"])                       # (B,S,di)
    b_t = proj[..., r:r + n].float()                      # (B,S,N)
    c_t = proj[..., r + n:].float()                       # (B,S,N)
    a_mat = -torch.exp(p["A_log"])                        # (di,N)
    xf = xc.float()
    h = h0
    ys = []
    for s0, s1 in _chunks(xc.shape[1], cfg.ssm.chunk_size):
        dtk = dt[:, s0:s1]
        log_a = dtk[..., None] * a_mat                    # (B,c,di,N)
        da = torch.exp(log_a)
        dbx = (dtk * xf[:, s0:s1])[..., None] * b_t[:, s0:s1, None, :]
        h_all, h = _chunk_scan(da, dbx, h, log_a)
        ys.append(torch.einsum("bcdn,bcn->bcd", h_all, c_t[:, s0:s1]))
    y = torch.cat(ys, dim=1) + xf * p["D"]
    return y, h


def _mamba1_step(cfg: ModelConfig, p: Params, xc: torch.Tensor,
                 h: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. xc: (B,di); h: (B,di,N)."""
    n = cfg.ssm.state_dim
    r = dt_rank(cfg)
    proj = torch.matmul(xc, p["x_proj"])
    dt = F.softplus(torch.matmul(proj[..., :r], p["dt_proj"]).float()
                    + p["dt_bias"])                       # (B,di)
    b_t = proj[..., r:r + n].float()
    c_t = proj[..., r + n:].float()
    a_mat = -torch.exp(p["A_log"])
    da = torch.exp(dt[..., None] * a_mat)                 # (B,di,N)
    dbx = (dt * xc.float())[..., None] * b_t[:, None, :]
    h_new = da * h + dbx
    y = torch.einsum("bdn,bn->bd", h_new, c_t)
    y = y + xc.float() * p["D"]
    return y, h_new


# ---------------------------------------------------------------------------
# Mamba2 (scalar decay per head)
# ---------------------------------------------------------------------------


def _mamba2_parts(cfg: ModelConfig, p: Params, xc: torch.Tensor,
                  dt_in: torch.Tensor):
    """What both Mamba2 prompt forms start from: B and C (B,S,N), dt and
    log a (B,S,H) in f32, and x by head (B,S,H,dh) in f32."""
    n = cfg.ssm.state_dim
    bc = torch.matmul(xc, p["bc_proj"]).float()
    dt = F.softplus(dt_in.float() + p["dt_bias"])          # (B,S,H)
    log_a = dt * -torch.exp(p["A_log"])                    # (B,S,H) <= 0
    bsz, s = xc.shape[:2]
    xh = xc.reshape(bsz, s, num_ssm_heads(cfg), cfg.ssm.head_dim).float()
    return bc[..., :n], bc[..., n:], dt, log_a, xh


def _mamba2_inner(cfg: ModelConfig, p: Params, xc: torch.Tensor,
                  dt_in: torch.Tensor, h0: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B,S,di); dt_in: (B,S,H) pre-softplus; h0: (B,H,dh,N)."""
    b_t, c_t, dt, log_a, xh = _mamba2_parts(cfg, p, xc, dt_in)
    h = h0
    ys = []
    for s0, s1 in _chunks(xc.shape[1], cfg.ssm.chunk_size):
        lak = log_a[:, s0:s1, :, None, None]              # (B,c,H,1,1)
        dbx = (dt[:, s0:s1, :, None] * xh[:, s0:s1])[..., None] * \
            b_t[:, s0:s1, None, None, :]                  # (B,c,H,dh,N)
        h_all, h = _chunk_scan(torch.exp(lak), dbx, h, lak)
        ys.append(torch.einsum("bchdn,bcn->bchd", h_all, c_t[:, s0:s1]))
    y = torch.cat(ys, dim=1) + xh * p["D"][:, None]
    return y.reshape(y.shape[0], y.shape[1], -1), h


def _mamba2_inner_ssd(cfg: ModelConfig, p: Params, xc: torch.Tensor,
                      dt_in: torch.Tensor, h0: torch.Tensor
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba-2 SSD (structured state-space duality) block-matmul form.

    Within a chunk the scalar-decay recurrence collapses to
        y = (M ⊙ (C Bᵀ)) @ (dt·x) + exp(s)·(C · h0)
        M[t,u] = exp(s_t − s_u) for u ≤ t,  s = cumsum(log a)
    — two (c,c)x(c,dh) matmuls per head instead of a log-depth scan over
    (B,c,H,dh,N) tensors. All exponents are ≤ 0 (a ∈ (0,1)), so the form
    is numerically stable. Inter-chunk state is carried exactly as in the
    scan path.
    """
    b_t, c_t, dt, log_a, xh = _mamba2_parts(cfg, p, xc, dt_in)
    h = h0
    ys = []
    for s0, s1 in _chunks(xc.shape[1], cfg.ssm.chunk_size):
        c = s1 - s0
        bk, ck = b_t[:, s0:s1], c_t[:, s0:s1]
        cum = torch.cumsum(log_a[:, s0:s1], dim=1)         # (B,c,H) s_t
        # decay matrix M[t,u] = exp(s_t - s_u), u <= t (<= 1).  The
        # exponent is masked BEFORE the exp: the upper triangle is
        # positive and would overflow
        diff = cum[:, :, None, :] - cum[:, None, :, :]     # (B,c,c,H)
        tri = torch.tril(torch.ones((c, c), dtype=torch.bool,
                                    device=xc.device))
        diff = torch.where(tri[None, :, :, None], diff,
                           torch.full((), -1e30, device=xc.device))
        m = torch.exp(diff)
        gb = torch.einsum("btn,bun->btu", ck, bk)          # C B^T
        xdt = xh[:, s0:s1] * dt[:, s0:s1, :, None]         # (B,c,H,dh)
        y = torch.einsum("btuh,buhd->bthd", gb[..., None] * m, xdt)
        # carry contribution: exp(s_t) * C_t . h0
        y = y + torch.exp(cum)[..., None] * \
            torch.einsum("btn,bhdn->bthd", ck, h)
        # new state: exp(s_end) h0 + sum_u exp(s_end - s_u) xdt_u (x) B_u
        s_end = cum[:, -1]                                 # (B,H)
        decay_u = torch.exp(s_end[:, None] - cum)          # (B,c,H)
        h = torch.exp(s_end)[:, :, None, None] * h + torch.einsum(
            "buhd,bun->bhdn", decay_u[..., None] * xdt, bk)
        ys.append(y)
    y = torch.cat(ys, dim=1) + xh * p["D"][:, None]
    return y.reshape(y.shape[0], y.shape[1], -1), h


def _mamba2_step(cfg: ModelConfig, p: Params, xc: torch.Tensor,
                 dt_in: torch.Tensor, h: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B,di); dt_in: (B,H); h: (B,H,dh,N)."""
    n = cfg.ssm.state_dim
    nh = num_ssm_heads(cfg)
    dh = cfg.ssm.head_dim
    bc = torch.matmul(xc, p["bc_proj"]).float()
    b_t, c_t = bc[..., :n], bc[..., n:]
    dt = F.softplus(dt_in.float() + p["dt_bias"])
    a_h = -torch.exp(p["A_log"])
    da = torch.exp(dt * a_h)[..., None, None]               # (B,H,1,1)
    xh = xc.reshape(-1, nh, dh).float()
    dbx = (dt[..., None] * xh)[..., None] * b_t[:, None, None, :]
    h_new = da * h + dbx
    y = torch.einsum("bhdn,bn->bhd", h_new, c_t)
    y = y + xh * p["D"][:, None]
    return y.reshape(y.shape[0], nh * dh), h_new


# ---------------------------------------------------------------------------
# Full block
# ---------------------------------------------------------------------------


def ssm_state_shapes(cfg: ModelConfig, batch: int):
    """Shapes of (conv_state, ssm_state) for one layer."""
    ssm = cfg.ssm
    di = cfg.d_inner
    conv = (batch, ssm.conv_kernel - 1, di)
    if ssm.variant == "mamba1":
        state = (batch, di, ssm.state_dim)
    else:
        state = (batch, num_ssm_heads(cfg), ssm.head_dim, ssm.state_dim)
    return conv, state


def apply_mamba(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> torch.Tensor:
    """Full-sequence mamba block (train/prefill, state discarded)."""
    y, _, _ = apply_mamba_with_state(cfg, p, x, None)
    return y


def apply_mamba_with_state(cfg: ModelConfig, p: Params, x: torch.Tensor,
                           init_state: Optional[Tuple[torch.Tensor,
                                                      torch.Tensor]]):
    """x: (B,S,d). Returns (y (B,S,d), conv_state, ssm_state): the conv
    window of the last k-1 inputs in x's dtype and the f32 scan state,
    from ``init_state`` = (conv_state, ssm_state) or from zeros."""
    if is_dtensor(x):
        return _apply_mamba_sharded(cfg, p, x, init_state)
    di = cfg.d_inner
    xz = torch.matmul(x, p["in_proj"])
    xs, z = xz[..., :di], xz[..., di:]
    if init_state is None:
        conv0, state0 = ssm_state_shapes(cfg, x.shape[0])
        conv_state = torch.zeros(conv0, dtype=x.dtype, device=x.device)
        h0 = torch.zeros(state0, dtype=torch.float32, device=x.device)
    else:
        conv_state, h0 = init_state
    return _mamba_block(cfg, p, xs, z, conv_state, h0, x.dtype)


def _mamba_block(cfg: ModelConfig, p: Params, xs: torch.Tensor,
                 z: torch.Tensor, conv_state: torch.Tensor,
                 h0: torch.Tensor, dtype: torch.dtype, contract=_same):
    """The block after ``in_proj``: the conv over [conv_state ; xs], the
    scan from ``h0``, the gate by ``z`` and ``out_proj``.  Everything is
    per channel but the products over the channels, which ``contract``
    completes (the identity on one device; over a mesh each rank runs
    its channels and ``contract`` sums the products over the channel
    shards).  Returns (y, conv_state, ssm_state)."""
    ssm = cfg.ssm
    full = torch.cat([conv_state.to(xs.dtype), xs], dim=1)
    k = ssm.conv_kernel
    conv_out = sum(full[:, i:i + xs.shape[1], :] * p["conv_w"][i]
                   for i in range(k)) + p["conv_b"]
    xc = F.silu(conv_out)
    new_conv_state = full[:, -(k - 1):, :] if k > 1 else conv_state
    if ssm.variant == "mamba1":
        y, h_last = _mamba1_inner(cfg, p, xc, h0, contract)
    else:
        dt_in = torch.matmul(xc, p["dt_w"])               # (B,S,H)
        inner = _mamba2_inner_ssd if ssm.ssd_matmul else _mamba2_inner
        y, h_last = inner(cfg, p, xc, dt_in, h0)
    y = y.to(dtype) * F.silu(z)
    out = contract(torch.matmul(y, p["out_proj"]))
    return out, new_conv_state, h_last


def _apply_mamba_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor,
                         init_state) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """:func:`apply_mamba_with_state` of a Mamba-1 block over a mesh:
    ``xs`` / ``z`` constrained to ``ssm_inner`` (the JAX package's
    point), then :func:`_mamba_block` on each rank's rows and channels
    with its slice of each weight (the scan writes with ``out=``, which
    a DTensor does not take), the two products over the channels
    (``x_proj`` and ``out_proj``) summed over the channel shards.
    Returns the output, the conv window and the scan state as DTensors
    placed by rows and channels."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    ssm = cfg.ssm
    if ssm.variant != "mamba1" or init_state is not None:
        raise NotImplementedError(
            "over a mesh the port runs the Mamba-1 block's prompt pass; "
            "Mamba-2 and a resumed state run on one device")
    di, n, k = cfg.d_inner, ssm.state_dim, ssm.conv_kernel
    x = constrain(x, "batch", None, "embed")
    xz = torch.matmul(x, fsdp_gathered(p["in_proj"]))
    xs = constrain(xz[..., :di], "batch", None, "ssm_inner")
    z = constrain(xz[..., di:], "batch", None, "ssm_inner")
    mesh, pl = xs.device_mesh, tuple(xs.placements)
    rows = [i for i, q in enumerate(pl) if q == Shard(0)]
    chans = [i for i, q in enumerate(pl) if q == Shard(2)]
    c0 = shard_offset(xs.shape, mesh, pl, 2)
    xs_l, z_l = xs.to_local(), z.to_local()
    bsz, n_ch = xs_l.shape[0], xs_l.shape[2]
    rows_pl = [Shard(0) if i in rows else Replicate()
               for i in range(len(pl))]

    def weight(w, ch_dim):
        """``w``'s rows (``ch_dim``) of this rank's channels, whole
        elsewhere; its gradient partial over the row shards (and over
        the channel shards where it is replicated and sliced here)."""
        want = [Shard(ch_dim) if i in chans and q == Shard(ch_dim)
                else Replicate() for i, q in enumerate(w.placements)]
        w = w.redistribute(mesh, want)
        sliced = [i for i in chans if want[i] != Shard(ch_dim)]
        wl = to_local(w, rows + sliced)
        return wl.narrow(ch_dim, c0, n_ch) if sliced else wl

    def reduce_channels(t):
        """A local product over this rank's channels, summed over them."""
        part = [Partial() if i in chans else q
                for i, q in enumerate(rows_pl)]
        shape = (x.shape[0],) + tuple(t.shape[1:])
        return from_local(t, mesh, part, shape).redistribute(
            mesh, rows_pl).to_local()

    local = {"conv_w": weight(p["conv_w"], 1),
             "conv_b": weight(p["conv_b"], 0),
             "x_proj": weight(p["x_proj"], 0),
             "dt_proj": weight(p["dt_proj"], 1),
             "dt_bias": weight(p["dt_bias"], 0),
             "A_log": weight(p["A_log"], 0), "D": weight(p["D"], 0),
             "out_proj": weight(p["out_proj"], 0)}
    conv0 = torch.zeros((bsz, k - 1, n_ch), dtype=xs_l.dtype,
                        device=xs_l.device)
    h0 = torch.zeros((bsz, n_ch, n), dtype=torch.float32,
                     device=xs_l.device)
    out, conv_state, h = _mamba_block(cfg, local, xs_l, z_l, conv0, h0,
                                      x.dtype, reduce_channels)
    out = constrain(from_local(out, mesh, rows_pl, tuple(x.shape)),
                    "batch", None, "embed")
    conv_state = from_local(conv_state, mesh, pl, (x.shape[0], k - 1, di))
    state_pl = [Shard(1) if q == Shard(2) else q for q in pl]
    return out, conv_state, from_local(h, mesh, state_pl,
                                       (x.shape[0], di, n))


def apply_mamba_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                     conv_state: torch.Tensor, h: torch.Tensor):
    """Decode step. x_t: (B,d) -> (y (B,d), conv_state, h), the state
    as new tensors (the caller writes them back where it keeps them)."""
    di = cfg.d_inner
    xz = torch.matmul(x_t, p["in_proj"])
    xs, z = xz[..., :di], xz[..., di:]
    conv_state, conv_out = _conv_step(p, conv_state, xs)
    xc = F.silu(conv_out)
    if cfg.ssm.variant == "mamba1":
        y, h = _mamba1_step(cfg, p, xc, h)
    else:
        dt_in = torch.matmul(xc, p["dt_w"])
        y, h = _mamba2_step(cfg, p, xc, dt_in, h)
    y = y.to(x_t.dtype) * F.silu(z)
    out = torch.matmul(y, p["out_proj"])
    return out, conv_state, h
