"""On-device per-request token sampling for the port's engine.

Every row samples with its OWN generation params (temperature / top-k /
top-p / seed) in one fused kernel launch (`repro_torch.kernels.ops
.fused_sample`); rows with ``temperature == 0`` take the plain argmax.

Reproducibility is per request and matches the JAX package bit for bit:
token ``i`` of a request seeded ``s`` is drawn with the Gumbel noise
``jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(s), i), (C,))``.
:func:`gumbel_noise` computes those bits with torch integer ops,
vectorised over rows:

1. ``PRNGKey(s)`` is the threefry key ``(0, s mod 2^32)``;
2. ``fold_in(key, i)`` is ``threefry2x32(key, (0, i))``;
3. with the partitionable threefry (``jax_threefry_partitionable``, on
   in the JAX releases this reproduces) the C random words are
   ``hi ^ lo`` of ``threefry2x32(key, (0, j))`` for ``j < C``;
4. ``uniform`` keeps the top 23 bits as a mantissa in ``[1, 2)``,
   subtracts 1 and clamps to ``[tiny, 1)``; the Gumbel value is
   ``-log(-log(u))``.

Step 4's ``log`` is not the correctly rounded one: the JAX package's CPU
backend evaluates f32 ``log`` with XLA's Cephes-style polynomial, and
:func:`xla_log` replays it operation for operation (its fused
multiply-adds emulated in float64), so the noise is bit-equal to the
reference's.  The noise is plain torch, not a kernel; it is (B, C) = a
few hundred values per tick.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops

# Bounded candidate set per row (LightSeq-style, arxiv 2010.13887):
# sampling only ever touches the top-C logits.
DEFAULT_SAMPLE_CANDIDATES = 64

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = float(np.finfo(np.float32).tiny)
# Cephes log coefficients (as f32 values), in the order XLA's polynomial
# uses them
_LOG_P = tuple(float(np.float32(c)) for c in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1))
_LOG_Q1 = -2.12194440e-4
_LOG_Q2 = 0.693359375


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x1: torch.Tensor,
                 x2: torch.Tensor):
    """The Threefry-2x32 block (20 rounds) on uint32 values held in int64
    tensors; arguments broadcast."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x = [(x1 + ks[0]) & _M32, (x2 + ks[1]) & _M32]
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x[0] = (x[0] + x[1]) & _M32
            x[1] = _rotl(x[1], r) ^ x[0]
        x[0] = (x[0] + ks[(i + 1) % 3]) & _M32
        x[1] = (x[1] + ks[(i + 2) % 3] + i + 1) & _M32
    return x[0], x[1]


def _fma(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add: the product of two f32 values is exact in
    float64, so one float64 add and one rounding to f32 reproduce it
    (barring a double-rounding tie, which no test has hit)."""
    a64 = a.double()
    return (a64 * b + (c.double() if torch.is_tensor(c) else c)).float()


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """f32 natural log exactly as XLA's CPU backend computes it
    (the Cephes polynomial of ``GenerateVF32Log``) for positive normal
    inputs, which is all the Gumbel transform feeds it."""
    t = torch.clamp(x, min=_TINY)
    bits = t.view(torch.int32)
    e = (bits >> 23).float() - 126.0              # 1 + unbiased exponent
    t = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)  # [0.5, 1)
    small = t < 0.707106781186547524
    tmp1 = torch.where(small, t, 0.0)
    t = t - 1.0
    e = e - small.float()
    t = t + tmp1
    x2 = t * t
    x3 = x2 * t
    p = _LOG_P
    y = _fma(t, p[0], torch.full_like(t, p[1]))
    y1 = _fma(t, p[3], torch.full_like(t, p[4]))
    y2 = _fma(t, p[6], torch.full_like(t, p[7]))
    y = _fma(y, t, torch.full_like(t, p[2]))
    y1 = _fma(y1, t, torch.full_like(t, p[5]))
    y2 = _fma(y2, t, torch.full_like(t, p[8]))
    y = _fma(y, x3, y1)
    y = _fma(y, x3, y2)
    y = _fma(y, x3, e * _LOG_Q1)
    t = t - 0.5 * x2
    t = t + y
    return t + _LOG_Q2 * e


def gumbel_noise(seed: torch.Tensor, step: torch.Tensor,
                 cands: int) -> torch.Tensor:
    """(B, cands) f32 noise, row b bit-equal to ``jax.random.gumbel(
    fold_in(PRNGKey(seed[b]), step[b]), (cands,), float32)``."""
    s = seed.to(torch.int64) & _M32
    i = step.to(torch.int64) & _M32
    zero = torch.zeros_like(s)
    k1, k2 = threefry2x32(zero, s, zero, i)               # fold_in
    cnt = torch.arange(cands, dtype=torch.int64, device=seed.device)[None]
    b1, b2 = threefry2x32(k1[:, None], k2[:, None], torch.zeros_like(cnt),
                          cnt)
    mant = ((b1 ^ b2) >> 9) | 0x3F800000
    u = mant.to(torch.int32).view(torch.float32) - 1.0
    u = torch.clamp(u + _TINY, min=_TINY)
    return -xla_log(-xla_log(u))


def sample_tokens(logits: torch.Tensor, *, temperature: torch.Tensor,
                  top_k: torch.Tensor, top_p: torch.Tensor,
                  seed: torch.Tensor, step: torch.Tensor,
                  candidates: int = 0) -> torch.Tensor:
    """One token per row from per-row sampling params.

    logits: (B, V) float (f32 and bf16 reach the kernel as they are);
    temperature/top_p: (B,) f32; top_k: (B,) int32 (0 disables); seed,
    step: (B,) int32 — ``step`` is the index of the token being drawn.
    Returns (B,) int32; rows with ``temperature <= 0`` return the plain
    argmax.  ``candidates`` bounds the candidate set (<= 0 means
    :data:`DEFAULT_SAMPLE_CANDIDATES`).
    """
    if candidates <= 0:
        candidates = DEFAULT_SAMPLE_CANDIDATES
    cands = min(candidates, logits.shape[-1])
    gumbel = gumbel_noise(seed, step, cands)
    # the kernel reads f32 or bf16 logits as the LM head wrote them and
    # scales in f32, as the plain version does after its exact upcast
    if logits.dtype not in (torch.float32, torch.bfloat16):
        logits = logits.float()
    return ops.fused_sample(logits.contiguous(), temperature, top_k, top_p,
                            gumbel)
