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
of them).  Over a mesh the prompt pass and the decode step constrain
``xs`` to ``ssm_inner`` as the JAX package does and run per channel on
each rank's shard with its slice of each weight, the products over the
channels summed over the channel shards (:class:`_MeshBlock`); Mamba-2's
heads lie along the channels, so a rank holds whole heads (a split that
cuts one raises).
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
from repro_torch.models.layers import dense_init, slot

Params = Dict[str, torch.Tensor]


def dt_rank(cfg: ModelConfig) -> int:
    return -(-cfg.d_model // 16)


def num_ssm_heads(cfg: ModelConfig) -> int:
    return cfg.d_inner // cfg.ssm.head_dim


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_mamba(cfg: ModelConfig, gen: torch.Generator, dtype: torch.dtype,
               device: torch.device, out: Optional[Params] = None) -> Params:
    """One block's weights in ``dtype``, drawn from ``gen`` (which must
    live on ``device``; into ``out``'s leaves where given, as
    `dense_init`); ``A_log``, ``D`` and ``dt_bias`` are f32, as in the
    JAX package."""
    ssm = cfg.ssm
    d, di, n = cfg.d_model, cfg.d_inner, ssm.state_dim
    f32 = dict(dtype=torch.float32, device=device)
    p: Params = {
        "in_proj": dense_init(gen, (d, 2 * di), d, dtype, device,
                              slot(out, "in_proj")),
        "conv_w": dense_init(gen, (ssm.conv_kernel, di), ssm.conv_kernel,
                             dtype, device, slot(out, "conv_w")),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "out_proj": dense_init(gen, (di, d), di, dtype, device,
                               slot(out, "out_proj")),
    }
    if ssm.variant == "mamba1":
        r = dt_rank(cfg)
        lo, hi = math.log(1e-3), math.log(1e-1)
        u = torch.rand((di,), generator=gen, **f32) * (hi - lo) + lo
        p.update({
            "x_proj": dense_init(gen, (di, r + 2 * n), di, dtype, device,
                                 slot(out, "x_proj")),
            "dt_proj": dense_init(gen, (r, di), r, dtype, device,
                                  slot(out, "dt_proj")),
            "dt_bias": torch.log(torch.expm1(
                torch.clamp(torch.exp(u), min=1e-4))),
            "A_log": torch.log(torch.arange(1, n + 1, **f32)).expand(
                di, n).contiguous(),
            "D": torch.ones((di,), **f32),
        })
    else:  # mamba2
        h = num_ssm_heads(cfg)
        p.update({
            "bc_proj": dense_init(gen, (di, 2 * n), di, dtype, device,
                                  slot(out, "bc_proj")),
            "dt_w": dense_init(gen, (di, h), di, dtype, device,
                               slot(out, "dt_w")),
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


def _same(t: torch.Tensor, heads: bool = False) -> torch.Tensor:
    """The one-device ``contract``: a product over the channels is
    complete, and every head is this device's."""
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
                 h: torch.Tensor, contract=_same
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single decode step. xc: (B,di); h: (B,di,N)."""
    n = cfg.ssm.state_dim
    r = dt_rank(cfg)
    proj = contract(torch.matmul(xc, p["x_proj"]))
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
                  dt_in: torch.Tensor, contract=_same):
    """What both Mamba2 prompt forms start from: B and C (B,S,N), dt and
    log a (B,S,H) in f32, and x by head (B,S,H,dh) in f32.  H is the
    heads ``xc``'s channels hold (a rank's, over a mesh, whose ``p``
    holds their ``dt_bias`` / ``A_log``); ``contract`` completes the
    product over the channels (``bc_proj``)."""
    n = cfg.ssm.state_dim
    bc = contract(torch.matmul(xc, p["bc_proj"])).float()
    dt = F.softplus(dt_in.float() + p["dt_bias"])          # (B,S,H)
    log_a = dt * -torch.exp(p["A_log"])                    # (B,S,H) <= 0
    bsz, s = xc.shape[:2]
    xh = xc.reshape(bsz, s, -1, cfg.ssm.head_dim).float()
    return bc[..., :n], bc[..., n:], dt, log_a, xh


def _mamba2_inner(cfg: ModelConfig, p: Params, xc: torch.Tensor,
                  dt_in: torch.Tensor, h0: torch.Tensor, contract=_same
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B,S,di); dt_in: (B,S,H) pre-softplus; h0: (B,H,dh,N)."""
    b_t, c_t, dt, log_a, xh = _mamba2_parts(cfg, p, xc, dt_in, contract)
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
                      dt_in: torch.Tensor, h0: torch.Tensor, contract=_same
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
    b_t, c_t, dt, log_a, xh = _mamba2_parts(cfg, p, xc, dt_in, contract)
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
                 dt_in: torch.Tensor, h: torch.Tensor, contract=_same
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """xc: (B,di); dt_in: (B,H); h: (B,H,dh,N) (H: the heads ``xc``'s
    channels hold)."""
    n = cfg.ssm.state_dim
    dh = cfg.ssm.head_dim
    nh = xc.shape[-1] // dh
    bc = contract(torch.matmul(xc, p["bc_proj"])).float()
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
    shards, and with ``heads`` keeps this rank's heads of the sum).
    Returns (y, conv_state, ssm_state)."""
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
        dt_in = contract(torch.matmul(xc, p["dt_w"]), heads=True)  # (B,S,H)
        inner = _mamba2_inner_ssd if ssm.ssd_matmul else _mamba2_inner
        y, h_last = inner(cfg, p, xc, dt_in, h0, contract)
    y = y.to(dtype) * F.silu(z)
    out = contract(torch.matmul(y, p["out_proj"]))
    return out, new_conv_state, h_last


class _MeshBlock:
    """One mamba block's per-rank pieces over a mesh: the input
    constrained to (``batch``, ..., ``embed``) and ``in_proj`` applied,
    ``xs`` / ``z`` constrained to ``ssm_inner`` (the JAX package's point)
    and taken local (this rank's rows and channels), each weight's slice
    for those channels (Mamba-2's per-head vectors for the heads they
    hold), and ``contract``, which sums a local product over the channel
    shards (``Partial`` reduced; with ``heads``, this rank's heads of the
    sum).  The scan writes with ``out=`` and the step into the cache, so
    the block runs on plain local tensors through the one-device body."""

    def __init__(self, cfg: ModelConfig, p: Params, x: torch.Tensor):
        from torch.distributed.tensor import Replicate, Shard
        di = cfg.d_inner
        lead = (None,) * (x.dim() - 2)      # the prompt pass's sequence
        self.x = constrain(x, "batch", *lead, "embed")
        xz = torch.matmul(self.x, fsdp_gathered(p["in_proj"]))
        self.ch = ch = x.dim() - 1
        xs = constrain(xz[..., :di], "batch", *lead, "ssm_inner")
        z = constrain(xz[..., di:], "batch", *lead, "ssm_inner")
        self.mesh, self.pl = xs.device_mesh, tuple(xs.placements)
        self.rows = [i for i, q in enumerate(self.pl) if q == Shard(0)]
        self.chans = [i for i, q in enumerate(self.pl) if q == Shard(ch)]
        self.c0 = shard_offset(xs.shape, self.mesh, self.pl, ch)
        self.xs, self.z = xs.to_local(), z.to_local()
        self.n_ch = self.xs.shape[-1]
        self.rows_pl = [Shard(0) if i in self.rows else Replicate()
                        for i in range(len(self.pl))]
        hd = cfg.ssm.head_dim
        if cfg.ssm.variant == "mamba2" and (self.c0 % hd or self.n_ch % hd):
            raise ValueError(
                f"mamba2 over a mesh: this rank's channels {self.c0}.."
                f"{self.c0 + self.n_ch - 1} of d_inner {di} cut a head of "
                f"{hd}; the ssm_inner mesh dims must divide the "
                f"{num_ssm_heads(cfg)} heads")
        self.h0, self.nh = self.c0 // hd, self.n_ch // hd
        names = (("x_proj", 0), ("dt_proj", 1), ("dt_bias", 0),
                 ("A_log", 0), ("D", 0)) if cfg.ssm.variant == "mamba1" \
            else (("bc_proj", 0), ("dt_w", 0))
        self.p = {name: self._weight(p[name], dim) for name, dim in
                  (("conv_w", 1), ("conv_b", 0), ("out_proj", 0)) + names}
        if cfg.ssm.variant == "mamba2":
            for name in ("dt_bias", "A_log", "D"):
                self.p[name] = self._weight(p[name], None)

    def _weight(self, w: torch.Tensor, ch_dim: Optional[int]
                ) -> torch.Tensor:
        """``w``'s rows (``ch_dim``) of this rank's channels, whole
        elsewhere (``ch_dim`` None: a per-head vector, its entries of this
        rank's heads); its gradient partial over the row shards (and over
        the channel shards where it is replicated and sliced here)."""
        from torch.distributed.tensor import Replicate, Shard
        want = [Shard(ch_dim) if ch_dim is not None and i in self.chans and
                q == Shard(ch_dim) else Replicate()
                for i, q in enumerate(w.placements)]
        w = w.redistribute(self.mesh, want)
        sliced = [i for i in self.chans if want[i] == Replicate()]
        wl = to_local(w, self.rows + sliced)
        if not sliced:
            return wl
        if ch_dim is None:
            return wl.narrow(0, self.h0, self.nh)
        return wl.narrow(ch_dim, self.c0, self.n_ch)

    def contract(self, t: torch.Tensor, heads: bool = False
                 ) -> torch.Tensor:
        """A local product over this rank's channels, summed over them;
        with ``heads``, this rank's heads of the sum (its last dim)."""
        from torch.distributed.tensor import Partial
        part = [Partial() if i in self.chans else q
                for i, q in enumerate(self.rows_pl)]
        shape = (self.x.shape[0],) + tuple(t.shape[1:])
        out = from_local(t, self.mesh, part, shape).redistribute(
            self.mesh, self.rows_pl).to_local()
        return out.narrow(-1, self.h0, self.nh) if heads else out

    def state_placements(self):
        """(conv window (B, k-1, di), scan state (B, di, N) or (B, H, dh,
        N)) placements: the rows as ``xs``'s, the channels (the window's
        last dim, the state's d_inner or heads) where ``xs`` has them."""
        from torch.distributed.tensor import Shard
        return ([Shard(2) if q == Shard(self.ch) else q for q in self.pl],
                [Shard(1) if q == Shard(self.ch) else q for q in self.pl])

    def local_state(self, conv: torch.Tensor, state: torch.Tensor):
        """This rank's shards of a (conv window, scan state) pair of
        DTensors, redistributed first to :meth:`state_placements` (a
        no-op for the pair a prompt pass or a step returned)."""
        conv_pl, state_pl = self.state_placements()
        return (conv.redistribute(self.mesh, conv_pl).to_local(),
                state.redistribute(self.mesh, state_pl).to_local())

    def placed(self, cfg: ModelConfig, out: torch.Tensor, conv: torch.Tensor,
               state: torch.Tensor):
        """The block's local output, conv window and scan state as
        DTensors: the output by rows (constrained to ``embed``), the pair
        by :meth:`state_placements`."""
        out = constrain(from_local(out, self.mesh, self.rows_pl,
                                   tuple(self.x.shape)),
                        "batch", *(None,) * (self.x.dim() - 2), "embed")
        conv_pl, state_pl = self.state_placements()
        conv0, state0 = ssm_state_shapes(cfg, self.x.shape[0])
        return (out, from_local(conv, self.mesh, conv_pl, conv0),
                from_local(state, self.mesh, state_pl, state0))


def _apply_mamba_sharded(cfg: ModelConfig, p: Params, x: torch.Tensor,
                         init_state) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """:func:`apply_mamba_with_state` over a mesh: :func:`_mamba_block` on
    each rank's rows and channels (:class:`_MeshBlock`), from zeros or
    from ``init_state``'s shards.  Returns the output, the conv window and
    the scan state as DTensors placed by rows and channels."""
    m = _MeshBlock(cfg, p, x)
    if init_state is None:
        conv0, state0 = ssm_state_shapes(cfg, m.xs.shape[0])
        conv0 = conv0[:2] + (m.n_ch,)
        state0 = (state0[0], m.n_ch) + state0[2:] \
            if cfg.ssm.variant == "mamba1" else (state0[0], m.nh) + state0[2:]
        conv = torch.zeros(conv0, dtype=m.xs.dtype, device=m.xs.device)
        h0 = torch.zeros(state0, dtype=torch.float32, device=m.xs.device)
    else:
        conv, h0 = m.local_state(*init_state)
    out, conv, h = _mamba_block(cfg, m.p, m.xs, m.z, conv, h0, x.dtype,
                                m.contract)
    return m.placed(cfg, out, conv, h)


def apply_mamba_step(cfg: ModelConfig, p: Params, x_t: torch.Tensor,
                     conv_state: torch.Tensor, h: torch.Tensor):
    """Decode step. x_t: (B,d) -> (y (B,d), conv_state, h), the state
    as new tensors (the caller writes them back where it keeps them).
    Over a mesh (DTensors) each rank steps its rows and channels with its
    weight slices (:class:`_MeshBlock`), and the state comes back placed
    as ``conv_state`` and ``h`` were, so the caller writes its shards
    back in place."""
    if is_dtensor(x_t):
        m = _MeshBlock(cfg, p, x_t)
        conv_l, h_l = m.local_state(conv_state, h)
        out, conv_l, h_l = _step_block(cfg, m.p, m.xs, m.z, conv_l, h_l,
                                       x_t.dtype, m.contract)
        out, conv_l, h_l = m.placed(cfg, out, conv_l, h_l)
        return (out, conv_l.redistribute(m.mesh, conv_state.placements),
                h_l.redistribute(m.mesh, h.placements))
    di = cfg.d_inner
    xz = torch.matmul(x_t, p["in_proj"])
    return _step_block(cfg, p, xz[..., :di], xz[..., di:], conv_state, h,
                       x_t.dtype)


def _step_block(cfg: ModelConfig, p: Params, xs: torch.Tensor,
                z: torch.Tensor, conv_state: torch.Tensor, h: torch.Tensor,
                dtype: torch.dtype, contract=_same):
    """The step after ``in_proj``, as :func:`_mamba_block` is the prompt
    pass's: the conv window, the recurrence, the gate and ``out_proj``,
    the products over the channels completed by ``contract``."""
    conv_state, conv_out = _conv_step(p, conv_state, xs)
    xc = F.silu(conv_out)
    if cfg.ssm.variant == "mamba1":
        y, h = _mamba1_step(cfg, p, xc, h, contract)
    else:
        dt_in = contract(torch.matmul(xc, p["dt_w"]), heads=True)
        y, h = _mamba2_step(cfg, p, xc, dt_in, h, contract)
    y = y.to(dtype) * F.silu(z)
    out = contract(torch.matmul(y, p["out_proj"]))
    return out, conv_state, h
