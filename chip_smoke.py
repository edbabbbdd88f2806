#!/usr/bin/env python3
"""Drive the PyTorch port (`src/repro_torch`) on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line:

1. device: the card (``nvidia-smi`` name and power limit), torch and CUDA
   versions;
2. build: compile the port's CUDA kernels from ``src/repro_torch/csrc``
   (one ``nvcc`` per source, all started together) and load them;
3. kernels: hold every Hopper kernel against its plain PyTorch version at
   the full-width shapes of the serving path, with the tolerance stated,
   and time kernel, plain version and (where one PyTorch call computes
   the same function) that library call: ``ms`` from CUDA events around
   back-to-back calls (host time included when the host is slower than
   the card), ``device_ms`` and ``library_device_ms`` from the self
   device time that ``torch.profiler`` records for the same loop; the
   norm, sampling and decode kernels' ``device_ms`` with the L2 flushed
   before every call (``device_ms_warm_l2`` back to back); the norm at
   the decode tick's 8 rows and a prefill's 8192, beside the empty
   ``repro_floor`` kernel's device time; the sampler on f32 and bf16
   logits with ties at rank C and a row of fewer than C finite values;
   the flash kernel's packed mode (segment ids and positions) on eight
   segments of 1024, on mixed lengths padded to their pack bucket and on
   segments after prefix keys, against SDPA with the dense mask, case
   (a) beside the causal kernel at B 8 x 1024 (the same visible pairs;
   fails above 1.5 times its device time, or where its rows differ from
   the causal kernel's by a bit); and what the norm, sampling,
   decode and packed kernels compiled to (``norm_build``,
   ``sample_build``, ``flash_decode_build``,
   ``flash_attention_packed_build``);
4. serve: build ``TurboClient.from_arch("internlm2-1.8b", smoke=False)``
   (24 layers, d_model 2048, vocab 92544, bf16 weights from a seed, f32
   KV pool), serve a mixed greedy / sampled workload with mid-decode
   arrivals through the default packed admission (one packed flash
   launch per layer per pack, each pack's occupancy), check every greedy
   stream against ``engine.generate`` of its prompt alone and every
   sampled stream against the request served again alone with its seed
   (a divergence passes only where the alone run's margin at the first
   differing step and the served token's gap there, ``draw_margins``,
   are below twice the largest logit drift between a packed pass and
   each prompt's own prefill, which the phase prints and holds to
   ``PACKED_LOGIT_ULPS``), the leak invariants, and that every kernel of
   the path launched;
5. profile_decode and profile_decode_sampled: eight greedy or sampled
   rows decoding at full width, the host time per tick and, from
   ``torch.profiler``, the device's busy time by kernel family and its
   idle share (the sampled window also the sample kernel's device time
   and what ``gumbel_noise`` launches); profile_prefill: one prefill of
   eight prompts at the 1024 bucket, the same breakdown and the flash
   kernel's share; profile_prefill_packed: the same prompts as one pack.
   Each window's count of the port's kernels in the trace is held against
   the launch counters; busy totals read "not measured" where the trace
   lost kernels, beside the busy time of the kernels it holds;
6. classify: the paper's one-shot classification service at full width
   (``InferenceEngine.warmup`` into a bucketed cost table, then 64
   Poisson requests of 5 to 500 tokens through
   ``ServingSystem(execute=engine.execute_requests)`` under the dp, naive
   and nobatch policies), each served batch's last-token logits held
   against ``classify`` of each request alone, and the launch counters:
   24 masked-softmax launches per executed batch, no flash attention;
7. serve_contiguous: the serve phase's workload through
   ``kv_layout="contiguous"`` (per-group prefill through the causal
   kernel), every stream equal to the request alone, 24 contiguous-decode
   launches per decode tick and no paged-decode launch.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises: the script
exits non-zero and prints no result.  It also refuses to run without a
CUDA device or outside a checkout of the repository.

TF32 is switched off for matmuls and cuDNN, so every f32 product in the
plain versions is a full f32 product.
"""
from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, data sheet (SXM)
H100_BF16_FLOPS = 989e12        # dense bf16 tensor cores
H100_F32_FLOPS = 67e12          # f32 outside the tensor cores

SEED = 0


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def bound_ms(nbytes: float, flops: float, peak_flops: float):
    t_bytes = nbytes / H100_BYTES_PER_S
    t_ops = flops / peak_flops
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def device_us(evt) -> float:
    """An averaged profiler event's self device time in microseconds."""
    us = getattr(evt, "self_device_time_total", None)
    return us if us is not None else getattr(evt, "self_cuda_time_total", 0)


def is_kernel(evt) -> bool:
    """A device-side event (kernel, memset, copy): device time, no host
    self time."""
    return device_us(evt) > 0 and evt.self_cpu_time_total == 0


def device_ms(fn, iters: int, before=None) -> dict:
    """Device time per call of ``fn`` from torch.profiler over ``iters``
    back-to-back calls, after one warm-up call: for each kernel the calls
    launch, its mean self device time over the launches the trace
    recorded times its launches per call, summed over the port's kernels
    (names holding ``repro``) as ``port`` and over every kernel as
    ``all``.  Averaging over recorded launches, not over ``iters``, keeps
    a trace that lost events from reading low.  "not measured" where the
    profiler shows no device time.  ``before``, where given, runs before
    each call (an L2 flush); only ``port`` is then the calls' own."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):     # the trace now and then comes back empty: retry
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                if before is not None:
                    before()
                fn()
            torch.cuda.synchronize()
        port = every = 0.0
        for evt in prof.key_averages():
            if is_kernel(evt):
                per_call = device_us(evt) / evt.count * \
                    max(1, round(evt.count / iters))
                every += per_call
                if "repro" in evt.key:
                    port += per_call
        if every > 0:
            break
    return {k: (us / 1e3 if us > 0 else "not measured")
            for k, us in (("port", port), ("all", every))}


_L2_FLUSH = []


def l2_flush():
    """A call that reads 256 MB, five times the H100's 50 MB L2, so the
    next kernel finds its inputs in device memory, as a decode layer does
    after the ~120 MB of weights the tick reads between two attention
    calls.  Its kernel's name holds no ``repro``."""
    if not _L2_FLUSH:
        _L2_FLUSH.append(torch.ones(64 << 20, device="cuda"))
    buf = _L2_FLUSH[0]
    return lambda: buf.sum()


def device_fields(kernel, library, iters: int) -> dict:
    """``device_ms`` of a kernel check (its port kernels' own time) and,
    where the check has a library call, ``library_device_ms`` (every
    kernel that call launches)."""
    out = {"device_ms": device_ms(kernel, iters)["port"]}
    out["library_device_ms"] = (device_ms(library, iters)["all"]
                                if library is not None else None)
    return out


def time_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back calls,
    after one warm-up call, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name: str, got, want, atol: float, rtol: float) -> float:
    err = max_err(got, want)
    bad = (got.float() - want.float()).abs() > atol + rtol * want.float().abs()
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{name}: kernel disagrees with its plain "
                             f"version (max abs err {err:.3g}, "
                             f"{int(bad.sum())} elements beyond atol "
                             f"{atol} + rtol {rtol})")
    return err


# ---------------------------------------------------------------------------
# Phase 3: every kernel against its plain version
# ---------------------------------------------------------------------------


def cold_with_writeback_ms(kernel, iters: int):
    """Device time a call adds to an L2 flush: (flush, call) pairs minus
    the flush alone, over every kernel.  The flush only reads, so a call's
    writes still dirty in the L2 when it ends reach device memory during
    the next flush; this counts them, which ``device_ms`` with the L2
    flushed does not."""
    flush = l2_flush()

    def pair():
        flush()
        return kernel()
    both = device_ms(pair, iters)["all"]
    alone = device_ms(flush, iters)["all"]
    if isinstance(both, float) and isinstance(alone, float):
        return both - alone
    return "not measured"


def cold_warm(kernel, nbytes: int, flops: float, peak_flops: float,
              iters: int, writeback: bool = False) -> dict:
    """A kernel's device time with the L2 flushed before every call
    (``device_ms``) and back to back (``device_ms_warm_l2``), beside its
    bound; with ``writeback``, also cold with its writes' trip to device
    memory counted (``device_ms_cold_writeback``)."""
    b_ms, b_by = bound_ms(nbytes, flops, peak_flops)
    cold = device_ms(kernel, iters, before=l2_flush())["port"]
    warm = device_ms(kernel, iters)["port"]
    line = {"device_ms": cold, "device_ms_warm_l2": warm, "bound_ms": b_ms,
            "bound_by": b_by}
    if isinstance(cold, float):
        line["share_of_bound"] = b_ms / cold
    if isinstance(warm, float):
        line["share_of_bound_warm_l2"] = b_ms / warm
    if writeback:
        wb = cold_with_writeback_ms(kernel, iters)
        line["device_ms_cold_writeback"] = wb
        if isinstance(wb, float) and wb > 0:
            line["share_of_bound_cold_writeback"] = b_ms / wb
    return line


NORM_TOL = dict(atol=3e-2, rtol=2e-2)   # bf16 output: ~2 ulp at |y| <= 4
#: the norm checks' rows: the decode tick's 8 and a B 8 x 1024 prefill's
NORM_ROWS = (8, 8192)


def norm_case(dev, gen, rms: bool, r: int, c: int, tol: dict) -> dict:
    """One shape of the fused norm: kernel against its plain version (the
    updated residual bit for bit), and the times of kernel, plain version
    and library call; the kernel's device time cold and warm."""
    from repro_torch.kernels import layernorm, ref
    import torch.nn.functional as F
    x = torch.randn((r, c), generator=gen, device=dev).bfloat16()
    res = torch.randn((r, c), generator=gen, device=dev).bfloat16()
    g = (1 + 0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()
    if rms:
        def kernel():
            return layernorm.norm_cuda(x, g, residual=res, rms=True,
                                       return_residual=True)

        def plain():
            return ref.rmsnorm_ref(x, g, residual=res, return_residual=True)
        s_sum = (x.float() + res.float()).bfloat16()

        def library():
            return F.rms_norm(s_sum, (c,), g, 1e-6)
    else:
        beta = (0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()
        bias = (0.1 * torch.randn((c,), generator=gen, device=dev)).bfloat16()

        def kernel():
            return layernorm.norm_cuda(x, g, beta, bias, res, rms=False,
                                       return_residual=True)

        def plain():
            return ref.layernorm_ref(x, g, beta, bias, res,
                                     return_residual=True)
        s_sum = (x.float() + bias.float() + res.float()).bfloat16()

        def library():
            return F.layer_norm(s_sum, (c,), g, beta, 1e-6)
    y, s = kernel()
    y_ref, s_ref = plain()
    torch.cuda.synchronize()
    err = check_close("norm y", y, y_ref, **tol)
    if not torch.equal(s, s_ref):
        raise AssertionError(f"norm residual: not bit-equal to the plain "
                             f"version (max abs {max_err(s, s_ref)})")
    iters = 200 if r <= 64 else 50
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    nbytes = (4 * r * c + (1 if rms else 3) * c) * 2
    return {"phase": "kernel_check", "kernel": "fused_norm",
            "mode": "rms" if rms else "layernorm",
            "shape": [r, c], "dtype": "bfloat16",
            "tolerance": {**tol, "why": "bf16 output; kernel and plain "
                          "version sum the row in other orders; the "
                          "updated residual bit for bit"},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms,
            "library": ("F.rms_norm" if rms else "F.layer_norm") +
            " of the pre-summed row (half the bytes: no residual read, "
            "no residual written)",
            **cold_warm(kernel, nbytes, 6 * r * c, H100_F32_FLOPS, iters,
                        writeback=r > 64),
            "library_device_ms": device_ms(library, iters)["all"],
            "bound_counts": "x and residual read, y and residual written, "
                            "gamma (and beta, bias) read once"}


def floor_device_ms(blocks: int, threads: int, iters: int = 200):
    """Device time of the empty ``repro_floor`` kernel on (blocks,
    threads): the floor under any launch of that shape."""
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    stream = torch.cuda.current_stream().cuda_stream

    def launch():
        cuda_lib.check(lib.repro_floor(blocks, threads, stream),
                       "repro_floor")
    return device_ms(launch, iters)["port"]


def norm_build_facts() -> dict:
    """What the norm bodies on the port's paths compiled to: registers
    and spills (ptxas) and resident blocks per SM."""
    from repro_torch.kernels import cuda_lib, layernorm
    lib = cuda_lib.library()
    facts = {}
    for label, dtype, code, mangled in (
            ("bf16 C2048", torch.bfloat16, 1, "I13__nv_bfloat16"),
            ("f32 C2048", torch.float32, 0, "If")):
        plan = layernorm.norm_plan(2048, dtype)
        needle = (f"norm_kernel{mangled}Li{plan.threads}E"
                  f"Li{plan.vectors}E")
        ptxas = next((u for name, u in cuda_lib.BUILD_INFO["ptxas"].items()
                      if needle in name), {})
        blocks = lib.repro_norm_blocks_per_sm(code, plan.threads,
                                              plan.vectors)
        if blocks < 1:
            raise AssertionError(f"fused_norm {label}: occupancy query gave "
                                 f"{blocks}")
        facts[label] = {"threads_per_row": plan.threads,
                        "vectors_per_thread": plan.vectors,
                        "blocks_per_sm": blocks,
                        "registers": ptxas.get("registers", "not measured"),
                        "spill_bytes": ptxas.get("spill_stores", 0) +
                        ptxas.get("spill_loads", 0)}
    return facts


def check_norm(dev, gen, results):
    lines = []
    for rms in (True, False):
        for r in NORM_ROWS:
            lines.append(norm_case(dev, gen, rms, r, 2048, NORM_TOL))
    # the floor under the decode tick's launch: the same grid, no work
    from repro_torch.kernels import layernorm
    floor = floor_device_ms(
        NORM_ROWS[0], layernorm.norm_plan(2048, torch.bfloat16).threads)
    for line in lines:
        if line["shape"][0] == 8:
            line["floor_device_ms"] = floor
            if isinstance(floor, float) and \
                    isinstance(line["device_ms"], float):
                line["device_ms_above_floor"] = line["device_ms"] - floor
        emit(line)
    emit({"phase": "norm_build", **norm_build_facts()})
    # the kernels line reports the decode-tick shape of the main path (RMS
    # mode, R = 8) and the worst error over both modes and both shapes
    entry = dict(lines[0])
    entry["max_abs_err"] = max(ln["max_abs_err"] for ln in lines)
    results["fused_norm"] = dict(
        entry, route="cuda", source="src/repro_torch/csrc/norm.cu",
        replaces="src/repro/kernels/layernorm.py:64")


def flash_case(dev, gen, b: int, s: int, tol: dict) -> dict:
    """One causal prefill shape: kernel against its plain version, and the
    times of kernel, plain version and SDPA (CUDA events and device
    time)."""
    from repro_torch.kernels import flash_attention, ref
    import torch.nn.functional as F
    h, kv, dh = 16, 8, 128
    q = torch.randn((b, s, h, dh), generator=gen, device=dev).bfloat16()
    k = torch.randn((b, s, kv, dh), generator=gen, device=dev).bfloat16()
    v = torch.randn((b, s, kv, dh), generator=gen, device=dev).bfloat16()
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)

    def kernel():
        return flash_attention.flash_attention_cuda(qt, kt, vt, causal=True)

    def plain():
        return ref.flash_attention_ref(qt, kt, vt, causal=True)

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                              enable_gqa=True)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close("flash_attention", out, want, **tol)
    iters = 20
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    dev_t = device_fields(kernel, library, iters)
    nbytes = b * s * dh * 2 * (2 * h + 2 * kv)
    flops = 4.0 * b * h * dh * s * (s + 1) / 2
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
    line = {"phase": "kernel_check", "kernel": "flash_attention",
            "shape": {"B": b, "S": s, "H": h, "KV": kv, "dh": dh},
            "dtype": "bfloat16", "causal": True,
            "tolerance": {**tol, "why": tol_why_attention()},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "library": "F.scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by, **dev_t,
            "tflops": flops / (k_ms * 1e-3) / 1e12,
            "share_of_bound": b_ms / k_ms}
    if isinstance(dev_t["device_ms"], float):
        line["device_tflops"] = flops / (dev_t["device_ms"] * 1e-3) / 1e12
    return line


def flash_build_facts() -> dict:
    """What the flash kernels compiled to: resident blocks per SM (CUDA
    occupancy calculator), registers and spills (ptxas), and the
    tensor-core (HMMA / HGMMA) and f32 FMA instructions in each body's
    SASS (cuobjdump; "not measured" where the tool is missing)."""
    import shutil
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    facts = {}
    for label, code, needle in (("bf16", 1, "flash_attention_bf16_kernel"),
                                ("f32", 0, "flash_attention_kernel")):
        blocks = lib.repro_flash_attention_blocks_per_sm(code)
        if blocks < 0:
            raise AssertionError(f"flash_attention {label}: occupancy query "
                                 f"failed with CUDA error {-blocks}")
        ptxas = {k: v for k, v in cuda_lib.BUILD_INFO["ptxas"].items()
                 if needle in k}
        facts[label] = {"blocks_per_sm": blocks,
                        "ptxas": next(iter(ptxas.values()), "not measured")}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run(
            [tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
            capture_output=True, text=True).stdout
        for label, needle in (("bf16", "flash_attention_bf16_kernel"),
                              ("f32", "flash_attention_kernel")):
            facts[label]["sass"] = cuda_lib.sass_opcodes(
                sass, needle, ("HMMA", "HGMMA", "FFMA", "MUFU", "LDSM"))
    else:
        for label in facts:
            facts[label]["sass"] = "not measured: no cuobjdump"
    tc_ops = facts["bf16"]["sass"]
    if isinstance(tc_ops, dict) and tc_ops["HMMA"] + tc_ops["HGMMA"] == 0:
        raise AssertionError("flash_attention bf16: no tensor-core "
                             f"instruction in its SASS: {facts['bf16']}")
    return facts


def check_flash_attention(dev, gen, results):
    """The causal prefill kernel at the earlier slices' three shapes and
    at the serve path's own (B 8, as ``batch_buckets=(8,)`` pads every
    prefill, at each seq bucket); the kernels line reports B 2, S 1024."""
    tol = dict(atol=2e-2, rtol=2e-2)   # bf16 in/out; see tol_why_attention
    entry = {}
    for b, s in ((4, 128), (4, 512), (2, 1024),
                 (8, 128), (8, 256), (8, 512), (8, 1024)):
        line = flash_case(dev, gen, b, s, tol)
        emit(line)
        if (b, s) == (2, 1024):
            entry = line
    emit({"phase": "flash_attention_build", **flash_build_facts()})
    results["flash_attention"] = dict(
        entry, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91")


#: the packed-mode checks' packs: (label, fresh lengths, prefix lengths,
#: pack width, prefix width): eight tile-aligned segments of 1024 (flat
#: 8192); mixed lengths with a one-token segment and boundaries inside
#: tiles, padded to their pack bucket; segments after 128, 256 and no
#: prefix keys (the prefix region padded to its bucket)
PACKED_CASES = (
    ("a: 8 x 1024", (1024,) * 8, (0,) * 8, 8192, 0),
    ("b: mixed 1..1024", (1, 64, 200, 333, 512, 700, 960, 1024), (0,) * 8,
     4096, 0),
    ("c: prefix 128, 256, 0", (300, 500, 700), (128, 256, 0), 2048, 512),
)
#: the packed kernel's device time in case (a) against the causal kernel's
#: at B 8 x 1024 (the same visible pairs): above this, tiles are not
#: being skipped
PACKED_OVER_CAUSAL_LIMIT = 1.5


def packed_inputs(dev, gen, fresh, prefix, width, pre_width, h=16, kv=8):
    """bf16 q (1, H, width, 128), k and v (1, KV, pre_width + width, 128)
    as views of (1, S, heads, 128) activations, and the segment ids and
    positions (q_seg, k_seg, q_pos, k_pos) of the pack."""
    from repro_torch.runtime.engine import segment_labels
    q_seg, q_pos = segment_labels(fresh, prefix, width)
    p_seg, p_pos = segment_labels(prefix, [0] * len(prefix), pre_width)
    ids = [torch.from_numpy(a).to(dev) for a in
           (q_seg, np.concatenate([p_seg, q_seg]), q_pos,
            np.concatenate([p_pos, q_pos]))]
    q, k, v = [torch.randn((1, n, heads, 128), generator=gen,
                           device=dev).bfloat16().transpose(1, 2)
               for n, heads in ((width, h), (pre_width + width, kv),
                                (pre_width + width, kv))]
    return q, k, v, ids


def packed_mask(ids) -> torch.Tensor:
    """The (Sq, Sk) visibility of a pack: one id and k_pos <= q_pos, or the
    query's own key."""
    q_seg, k_seg, q_pos, k_pos = ids
    sq, sk = q_seg.numel(), k_seg.numel()
    keys = torch.arange(sk, device=q_seg.device)
    own = keys[None, :] - (sk - sq) == torch.arange(sq, device=q_seg.device
                                                    )[:, None]
    return ((q_seg[:, None] == k_seg[None, :]) &
            (k_pos[None, :] <= q_pos[:, None])) | own


def packed_case(dev, gen, label, fresh, prefix, width, pre_width) -> dict:
    """One pack: the packed mode against its plain version on real rows
    (padding rows finite), and the times of kernel, plain version and
    SDPA with the dense boolean mask; the bound counts the visible pairs
    of the real rows."""
    from repro_torch.kernels import flash_attention, ref
    import torch.nn.functional as F
    h, kv, dh = 16, 8, 128
    q, k, v, ids = packed_inputs(dev, gen, fresh, prefix, width, pre_width)
    mask = packed_mask(ids)

    def kernel():
        return flash_attention.flash_attention_packed_cuda(q, k, v, *ids)

    def plain():
        return ref.flash_attention_packed_ref(q, k, v, *ids)

    def library():
        return F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                              enable_gqa=True)
    tol = dict(atol=2e-2, rtol=2e-2)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    real = ids[0] >= 0
    err = check_close(f"flash_attention_packed {label}", out[:, :, real],
                      want[:, :, real], **tol)
    if not bool(torch.isfinite(out.float()).all()):
        raise AssertionError(f"flash_attention_packed {label}: a padding "
                             "row is not finite")
    del want
    pairs = int(mask[real].sum())
    sq, sk = width, pre_width + width
    nbytes = 2 * (2 * sq * h * dh + 2 * sk * kv * dh) + 4 * 2 * (sq + sk)
    flops = 4.0 * dh * h * pairs
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
    iters = 20
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, 3),
                        time_ms(library, iters))
    dev_t = device_fields(kernel, library, iters)
    line = {"phase": "kernel_check", "kernel": "flash_attention_packed",
            "case": label,
            "shape": {"H": h, "KV": kv, "dh": dh, "Sq": sq, "Sk": sk,
                      "segments": list(fresh), "prefix": list(prefix),
                      "flat": int(real.sum())},
            "dtype": "bfloat16",
            "tolerance": {**tol, "why": tol_why_attention() +
                          "; real rows only (padding rows finite)"},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms,
            "library": "F.scaled_dot_product_attention with the dense "
                       "boolean (Sq, Sk) mask (a yardstick, not on the path)",
            "visible_pairs": pairs, "dense_pairs": sq * sk,
            "bound_ms": b_ms, "bound_by": b_by,
            "bound_counts": "4 dh H flops a visible pair of a real row; "
                            "q, k, v, ids read once, output written once",
            **dev_t, "share_of_bound": b_ms / k_ms}
    if isinstance(dev_t["device_ms"], float):
        line["device_tflops"] = flops / (dev_t["device_ms"] * 1e-3) / 1e12
        line["device_share_of_bound"] = b_ms / dev_t["device_ms"]
    if label.startswith("a"):
        line["against_causal"] = packed_against_causal(
            dev, gen, q, k, v, out, fresh, dev_t["device_ms"], k_ms, iters)
    return line


def packed_against_causal(dev, gen, q, k, v, packed_out, fresh,
                          packed_device_ms, packed_ms, iters) -> dict:
    """Case (a) beside the causal kernel at B 8 x 1024 on the same rows
    (the same visible pairs): their times, and whether the packed rows
    equal the causal ones bit for bit (each segment starts on a tile)."""
    from repro_torch.kernels import flash_attention
    b, s = len(fresh), fresh[0]

    def rows(t):             # (1, heads, B * S, dh) -> (B, heads, S, dh)
        return t[0].reshape(t.shape[1], b, s, 128).transpose(0, 1)

    qb, kb, vb = rows(q), rows(k), rows(v)

    def causal():
        return flash_attention.flash_attention_cuda(qb, kb, vb, causal=True)
    out = causal()
    torch.cuda.synchronize()
    equal = bool(torch.equal(out, rows(packed_out)))
    c_ms = time_ms(causal, iters)
    c_dev = device_ms(causal, iters)["port"]
    if isinstance(packed_device_ms, float) and isinstance(c_dev, float):
        ratio, by = packed_device_ms / c_dev, "device_ms"
    else:
        ratio, by = packed_ms / c_ms, "ms"
    flops = 4.0 * b * 16 * 128 * s * (s + 1) / 2
    nbytes = b * s * 128 * 2 * (2 * 16 + 2 * 8)
    return {"causal_shape": {"B": b, "S": s}, "causal_ms": c_ms,
            "causal_device_ms": c_dev,
            "causal_bound_ms": bound_ms(nbytes, flops, H100_BF16_FLOPS)[0],
            "packed_over_causal": ratio, "compared_by": by,
            "limit": PACKED_OVER_CAUSAL_LIMIT,
            "bit_equal_to_causal": equal}


def packed_build_facts() -> dict:
    """What the packed mode compiled to: resident blocks per SM, ptxas
    registers and spills, and its tensor-core instructions in SASS."""
    import shutil
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    blocks = lib.repro_flash_attention_packed_blocks_per_sm()
    if blocks < 1:
        raise AssertionError(f"flash_attention_packed: occupancy query gave "
                             f"{blocks}")
    needle = "flash_attention_packed_kernel"
    facts = {"blocks_per_sm": blocks,
             "ptxas": next((u for name, u in cuda_lib.BUILD_INFO["ptxas"]
                            .items() if needle in name), "not measured")}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run(
            [tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
            capture_output=True, text=True).stdout
        facts["sass"] = cuda_lib.sass_opcodes(
            sass, needle, ("HGMMA", "LDGSTS", "MUFU", "BAR"))
        if facts["sass"]["HGMMA"] == 0:
            raise AssertionError("flash_attention_packed: no wgmma (HGMMA) "
                                 "in its SASS")
    else:
        facts["sass"] = "not measured: no cuobjdump"
    return facts


def check_flash_attention_packed(dev, gen, results):
    """The packed mode on cases (a) to (c); the kernels line reports case
    (a) with the worst error over the three."""
    lines = []
    for case in PACKED_CASES:
        lines.append(packed_case(dev, gen, *case))
        emit(lines[-1])
        release_memory()
    ratio = lines[0]["against_causal"]["packed_over_causal"]
    if ratio > PACKED_OVER_CAUSAL_LIMIT:
        raise AssertionError(
            f"flash_attention_packed: {ratio:.2f}x the causal kernel's time "
            f"on the same visible pairs (limit {PACKED_OVER_CAUSAL_LIMIT}): "
            "key tiles are not skipped")
    if not lines[0]["against_causal"]["bit_equal_to_causal"]:
        raise AssertionError(
            "flash_attention_packed: case (a)'s rows differ from the causal "
            "kernel's on the same tile-aligned segments")
    emit({"phase": "flash_attention_packed_build", **packed_build_facts()})
    results["flash_attention_packed"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91")


def tol_why_attention() -> str:
    return ("bf16 inputs and output; the kernel rounds the unnormalised "
            "probabilities to bf16 before P.V and divides by their f32 "
            "sum after, the plain version rounds the normalised weights; "
            "sums in other orders")


DECODE_TOL = dict(atol=4e-3, rtol=4e-3)    # a few bf16 ulps of the output
DECODE_TOL_WHY = ("the cache is f32 and the kernel keeps f32 throughout; "
                  "the plain version rounds the softmax weights to q's "
                  "bf16, and both round the output to bf16: a few of its "
                  "ulps apart")
#: the decode checks' cases: the serve-like spread of lengths (the
#: kernels line's), and the full load
DECODE_CASES = (("lengths 1..1024", "spread"),
                ("full load, every row 1024", "full"))


def decode_lengths(dev, b: int, s: int, which) -> torch.Tensor:
    """``which``: "spread" (1 to S evenly), "full" (every row S), or the
    B lengths themselves."""
    if which == "full":
        return torch.full((b,), s, dtype=torch.int32, device=dev)
    if which == "spread":
        return torch.linspace(1, s, b, device=dev).round().to(torch.int32)
    return torch.tensor(which, dtype=torch.int32, device=dev)


def decode_timing(kernel, nbytes: int, flops: float, iters: int) -> dict:
    """A decode kernel's times and bound: ``ms`` from CUDA events over
    back-to-back calls (host time included); ``device_ms`` its own device
    time with the L2 flushed before every call, as the decode tick finds
    it; ``device_ms_warm_l2`` back to back, the inputs left in L2 by the
    call before (how PR 14 timed it)."""
    line = {"ms": time_ms(kernel, iters),
            **cold_warm(kernel, nbytes, flops, H100_F32_FLOPS, iters),
            "bound_counts": "live K and V rows read once, q read, output "
                            "written, tables and lengths read"}
    if isinstance(line["device_ms"], float):
        line["gbytes_per_s"] = nbytes / (line["device_ms"] * 1e-3) / 1e9
    return line


def paged_decode_case(dev, gen, label: str, which) -> dict:
    """The paged decode kernel at B 8, H 16, KV 8, BS 16, MB 64 over a
    pool of randomly placed blocks: against its plain version, then
    timed (``decode_timing``)."""
    from repro_torch.kernels import flash_decode, ref
    b, h, kv, dh, bs, mb = 8, 16, 8, 128, 16, 64
    nb = b * mb + 1
    lengths = decode_lengths(dev, b, mb * bs, which)
    perm = torch.randperm(nb - 1, generator=gen, device=dev) + 1
    tables = torch.zeros((b, mb), dtype=torch.int32, device=dev)
    used = 0
    for i, ln in enumerate(lengths.tolist()):
        nblk = -(-ln // bs)
        tables[i, :nblk] = perm[used:used + nblk].to(torch.int32)
        used += nblk               # logical blocks past the length: trash 0
    q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
    k_pool = torch.randn((nb, bs, kv, dh), generator=gen, device=dev)
    v_pool = torch.randn((nb, bs, kv, dh), generator=gen, device=dev)

    def kernel():
        return flash_decode.flash_decode_paged_cuda(q, k_pool, v_pool,
                                                    tables, lengths)

    def plain():
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, tables,
                                          lengths)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close(f"flash_decode_paged {label}", out, want,
                      **DECODE_TOL)
    live = int(lengths.sum())
    nbytes = 2 * live * kv * dh * 4 + 2 * b * h * dh * 2 + b * mb * 4 + b * 4
    line = {"phase": "kernel_check", "kernel": "flash_decode_paged",
            "case": label,
            "shape": {"B": b, "H": h, "KV": kv, "dh": dh, "BS": bs,
                      "MB": mb, "lengths": lengths.tolist()},
            "dtype": "q bfloat16, pool float32",
            "tolerance": {**DECODE_TOL, "why": DECODE_TOL_WHY},
            "max_abs_err": err,
            **decode_timing(kernel, nbytes, 4.0 * h * dh * live, 200),
            "plain_ms": time_ms(plain, 20),
            "library_ms": None, "library_device_ms": None}
    return line


def check_paged_decode(dev, gen, results):
    lines = [paged_decode_case(dev, gen, label, which)
             for label, which in DECODE_CASES]
    for line in lines:
        emit(line)
    results["flash_decode_paged"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:207")


def flash_decode_build_facts() -> dict:
    """What the decode kernels compiled to, per (layout, q dtype, group):
    registers and spills (ptxas), static and dynamic shared memory and
    resident blocks per SM (CUDA occupancy calculator); and, for the
    serve path's instantiation (paged, bf16 q, G 2), the async copies
    (LDGSTS), shuffles and exp units in its SASS (cuobjdump)."""
    import shutil
    from repro_torch.kernels import cuda_lib
    lib = cuda_lib.library()
    ring = lib.repro_flash_decode_ring_bytes()
    facts = {}
    for layout, rows, paged in (("paged", "PagedRows", 1),
                                ("contiguous", "StridedRows", 0)):
        for dtype, code, mangled in (("f32", 0, "decode_kernelIf"),
                                     ("bf16", 1, "decode_kernelI13__nv_")):
            for g in (1, 2, 8):
                blocks = lib.repro_flash_decode_blocks_per_sm(code, g, paged)
                if blocks < 1:
                    raise AssertionError(
                        f"flash_decode {layout} {dtype} G {g}: occupancy "
                        f"query gave {blocks}")
                ptxas = next((u for name, u in
                              cuda_lib.BUILD_INFO["ptxas"].items()
                              if mangled in name and f"Li{g}E" in name and
                              rows in name), {})
                facts[f"{layout} {dtype} G{g}"] = {
                    "blocks_per_sm": blocks,
                    "registers": ptxas.get("registers", "not measured"),
                    "spill_bytes": ptxas.get("spill_stores", 0) +
                    ptxas.get("spill_loads", 0),
                    "smem_bytes": ring + ptxas.get("static_smem_bytes", 0)}
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if Path(tool).exists():
        sass = subprocess.run(
            [tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
            capture_output=True, text=True).stdout
        facts["sass_paged_bf16_G2"] = cuda_lib.sass_opcodes(
            sass, "decode_kernelI13__nv_bfloat16Li2ENS_9PagedRows",
            ("LDGSTS", "SHFL", "MUFU", "FFMA", "ATOMG", "RED"))
        if facts["sass_paged_bf16_G2"]["LDGSTS"] == 0:
            raise AssertionError("flash_decode: no cp.async (LDGSTS) in "
                                 "the paged kernel's SASS")
    else:
        facts["sass_paged_bf16_G2"] = "not measured: no cuobjdump"
    return facts


def softmax_case(dev, gen, label: str, lengths, c: int,
                 dtype: torch.dtype) -> dict:
    """One shape of the masked softmax: kernel against its plain version,
    exact zeros past each length, and the times of kernel, plain version
    and torch.softmax of the pre-masked input."""
    from repro_torch.kernels import ref, softmax
    r = lengths.numel()
    x = (4 * torch.randn((r, c), generator=gen, device=dev)).to(dtype)
    scale = 1 / math.sqrt(128)

    def kernel():
        return softmax.softmax_cuda(x, lengths, scale=scale)

    def plain():
        return ref.softmax_ref(x, lengths, scale)
    valid = torch.arange(c, device=dev)[None, :] < lengths[:, None]
    x_masked = torch.where(valid, x.float() * scale, float("-inf"))

    def library():
        return torch.softmax(x_masked, dim=-1)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == torch.float32 \
        else dict(atol=1e-5, rtol=8e-3)
    err = check_close(f"fused_softmax {label}", out, want, **tol)
    if bool((out[~valid] != 0).any()):
        raise AssertionError(f"fused_softmax {label}: a column past its "
                             "row's length is not exactly zero")
    iters = 50 if r > 4096 else 200
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    dev_t = device_fields(kernel, library, iters)
    # what the function needs: the columns below min(length, C) read
    # once, every column written once (zeros past the length), lengths
    live = int(lengths.clamp(0, c).sum())
    nbytes = (live + r * c) * x.element_size() + r * 4
    b_ms, b_by = bound_ms(nbytes, 5.0 * live, H100_F32_FLOPS)
    return {"phase": "kernel_check", "kernel": "fused_softmax",
            "case": label, "shape": [r, c], "dtype": str(dtype),
            "tolerance": {**tol, "why": "f32 math in both; the row sum is "
                          "taken in another order (bf16: one ulp of the "
                          "rounded output)"},
            "zeros_past_length": "exact",
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms,
            "library": "torch.softmax of the pre-masked, pre-scaled input",
            "bound_ms": b_ms, "bound_by": b_by, **dev_t,
            "bound_counts": "live columns read, whole rows written",
            "share_of_bound": b_ms / k_ms}


def check_softmax(dev, gen, results):
    """The masked softmax at the classify shape (B 16, H 16, S 512, causal
    row lengths), at S 1024, and on rows of length 0 and past C."""
    def causal(bh: int, s: int):        # the rows of a (B*H, S, S) score
        return torch.arange(1, s + 1, dtype=torch.int32,
                            device=dev).repeat(bh)

    def ragged(c: int):
        lengths = torch.randint(-2, 2 * c, (4096,), generator=gen,
                                device=dev, dtype=torch.int32)
        lengths[:8] = torch.tensor([0, 0, c, c + 1, 5 * c, 1, -1, 7],
                                   dtype=torch.int32)
        return lengths
    lines = [softmax_case(dev, gen, "classify B16 H16 S512",
                          causal(16 * 16, 512), 512, torch.float32),
             softmax_case(dev, gen, "B4 H16 S1024", causal(4 * 16, 1024),
                          1024, torch.float32),
             softmax_case(dev, gen, "ragged C300, lengths 0 and > C",
                          ragged(300), 300, torch.float32),
             softmax_case(dev, gen, "ragged bf16 C512, lengths 0 and > C",
                          ragged(512), 512, torch.bfloat16)]
    for line in lines:
        emit(line)
    # the kernels line reports the classify shape and the worst error
    results["fused_softmax"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/softmax.cu",
        replaces="src/repro/kernels/softmax.py:42")


def contiguous_decode_case(dev, gen, label: str, which) -> dict:
    """Contiguous decode at B 8, H 16, KV 8, S 1024 on a strided view of a
    (B, S, KV, dh) cache whose positions past each length are NaN: against
    its plain version, bit for bit against the paged kernel on the same
    keys, then timed (``decode_timing``), with SDPA beside it."""
    from repro_torch.kernels import flash_decode, ref
    import torch.nn.functional as F
    b, h, kv, dh, s, bs = 8, 16, 8, 128, 1024, 16
    lengths = decode_lengths(dev, b, s, which)
    q = torch.randn((b, h, dh), generator=gen, device=dev).bfloat16()
    kc = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    vc = torch.randn((b, s, kv, dh), generator=gen, device=dev)
    past = torch.arange(s, device=dev)[None, :] >= lengths[:, None]
    kc[past] = float("nan")            # never written, never to be read
    vc[past] = float("nan")
    k, v = kc.transpose(1, 2), vc.transpose(1, 2)     # (B, KV, S, dh)
    # the plain version multiplies masked weights (0) into V: give it the
    # same keys with a finite tail
    k0 = kc.masked_fill(past[:, :, None, None], 0).transpose(1, 2)
    v0 = vc.masked_fill(past[:, :, None, None], 0).transpose(1, 2)

    def kernel():
        return flash_decode.flash_decode_cuda(q, k, v, lengths)

    def plain():
        return ref.flash_decode_ref(q, k0, v0, lengths)
    mask = ~past[:, None, None, :]
    qf = q.float()[:, :, None, :]

    def library():
        return F.scaled_dot_product_attention(qf, k0, v0, attn_mask=mask,
                                              enable_gqa=True)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close(f"flash_decode {label}", out, want, **DECODE_TOL)
    # the same keys in a pool: row r owns blocks 1 + r * MB ... in order
    mb = s // bs
    pool_k = torch.cat([torch.zeros((1, bs, kv, dh), device=dev),
                        kc.reshape(b * mb, bs, kv, dh)])
    pool_v = torch.cat([torch.zeros((1, bs, kv, dh), device=dev),
                        vc.reshape(b * mb, bs, kv, dh)])
    tables = (1 + torch.arange(b * mb, device=dev, dtype=torch.int32)
              ).reshape(b, mb)
    paged = flash_decode.flash_decode_paged_cuda(q, pool_k, pool_v, tables,
                                                 lengths)
    torch.cuda.synchronize()
    bit_diff = max_err(out, paged)
    if not torch.equal(out, paged):
        raise AssertionError(f"flash_decode {label}: differs from the "
                             f"paged kernel on the same keys (max abs "
                             f"{bit_diff})")
    del pool_k, pool_v
    live = int(lengths.sum())
    nbytes = 2 * live * kv * dh * 4 + 2 * b * h * dh * 2 + b * 4
    return {"phase": "kernel_check", "kernel": "flash_decode",
            "case": label,
            "shape": {"B": b, "H": h, "KV": kv, "dh": dh, "S": s,
                      "lengths": lengths.tolist(),
                      "layout": "strided (B, KV, S, dh) view of a "
                                "(B, S, KV, dh) cache, NaN past each length"},
            "dtype": "q bfloat16, cache float32",
            "tolerance": {**DECODE_TOL, "why": DECODE_TOL_WHY},
            "max_abs_err": err, "max_abs_diff_vs_paged_kernel": bit_diff,
            **decode_timing(kernel, nbytes, 4.0 * h * dh * live, 200),
            "plain_ms": time_ms(plain, 20),
            "library_ms": time_ms(library, 50),
            "library_device_ms": device_ms(library, 50)["all"],
            "library": "F.scaled_dot_product_attention (f32 q, bool mask, "
                       "enable_gqa), back to back (warm L2)"}


def check_contiguous_decode(dev, gen, results):
    lines = [contiguous_decode_case(dev, gen, label, which)
             for label, which in DECODE_CASES]
    for line in lines:
        emit(line)
    emit({"phase": "flash_decode_build", **flash_decode_build_facts()})
    results["flash_decode"] = dict(
        lines[0], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:81")


def sample_inputs(dev, gen, dtype: torch.dtype):
    """The sampling check's eight rows at B 8, V 92544, C 64: two greedy
    rows; row 1 with ten ties at the top; row 2 with 40 ties at the top
    and the C-th rank inside a run of 60 more ties (spread over the row,
    so over every block of its cluster); row 5 with 20 finite values and
    the rest -inf, fewer than C."""
    from repro_torch.runtime.sampling import gumbel_noise
    b, v, c = 8, 92544, 64
    logits = 3 * torch.randn((b, v), generator=gen, device=dev)
    logits[1, 100:110] = logits[1].max() + 1     # a tie at the top
    spread = torch.randperm(v, generator=gen, device=dev)
    logits[2, spread[:40]] = 30.0                # exact in bf16 too
    logits[2, spread[40:100]] = 25.0             # ranks 41..100 tie
    logits[5] = float("-inf")
    logits[5, spread[100:120]] = 3 * torch.randn((20,), generator=gen,
                                                 device=dev)
    logits = logits.to(dtype)
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.0, 0.9, 0.5, 2.0],
                        device=dev)
    top_k = torch.tensor([0, 0, 40, 5, 0, 100, 1, 0], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 0.9, 1.0, 0.8, 1.0, 0.95, 1.0, 0.5],
                         device=dev)
    seed = torch.arange(b, dtype=torch.int32, device=dev) + 11
    gumbel = gumbel_noise(seed, torch.full_like(seed, 3), c)
    return logits, temp, top_k, top_p, gumbel


def sample_case(dev, gen, dtype: torch.dtype) -> dict:
    """The fused sampler at B 8, V 92544, C 64 with ``dtype`` logits:
    every token against the plain version, then its device time cold and
    warm (the LM head has just written the logits, so the tick finds them
    in L2)."""
    from repro_torch.kernels import ref, sampling
    args = sample_inputs(dev, gen, dtype)
    logits, _, _, _, gumbel = args
    b, v = logits.shape
    c = gumbel.shape[-1]

    def kernel():
        return sampling.sample_cuda(*args)

    def plain():
        return ref.sample_ref(*args)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    mismatch = int((out != want).sum())
    if mismatch:
        raise AssertionError(f"fused_sample {dtype}: {mismatch} rows differ "
                             f"from the plain version: {out.tolist()} vs "
                             f"{want.tolist()}")
    nbytes = b * v * logits.element_size() + b * c * 4 + b * 16
    return {"phase": "kernel_check", "kernel": "fused_sample",
            "shape": {"B": b, "V": v, "C": c}, "dtype": str(dtype),
            "rows": "greedy 0 and 4; ties at the top in 1; the C-th rank "
                    "inside a run of ties in 2; 20 finite values in 5",
            "tolerance": {"tokens": "exact", "why": "integer tokens; "
                          "both versions consume the same noise"},
            "tokens": out.tolist(),
            "max_abs_err": float(mismatch), "ms": time_ms(kernel, 50),
            "plain_ms": time_ms(plain, 20), "library_ms": None,
            "library_device_ms": None,
            **cold_warm(kernel, nbytes, 2.0 * b * v, H100_F32_FLOPS, 50),
            "bound_counts": "logits read once, noise and per-row "
                            "parameters read, tokens written"}


def sample_build_facts() -> dict:
    """What the sampling kernel compiled to (ptxas registers, spills,
    static shared memory) and what a launch at V 92544, C 64 gets: its
    dynamic shared memory, resident blocks per SM and the most clusters
    the card runs at once."""
    import ctypes

    from repro_torch.kernels import cuda_lib, sampling
    lib = cuda_lib.library()
    plan = sampling.sample_plan(8, 92544, 64)
    facts = {"cluster": plan.cluster, "slice_len": plan.slice_len,
             "dynamic_smem_bytes": plan.smem_bytes,
             "digit_bits": sampling.DIGIT_BITS}
    for label, code, mangled in (("f32", 0, "sample_kernelIfE"),
                                 ("bf16", 1, "sample_kernelI13__nv_")):
        blocks, clusters = ctypes.c_int(0), ctypes.c_int(0)
        cuda_lib.check(lib.repro_sample_occupancy(
            code, plan.smem_bytes, ctypes.byref(blocks),
            ctypes.byref(clusters)), "repro_sample_occupancy")
        if blocks.value < 1 or clusters.value < 1:
            raise AssertionError(f"fused_sample {label}: {blocks.value} "
                                 f"blocks per SM, {clusters.value} clusters")
        ptxas = next((u for name, u in cuda_lib.BUILD_INFO["ptxas"].items()
                      if mangled in name), {})
        facts[label] = {"blocks_per_sm": blocks.value,
                        "max_active_clusters": clusters.value,
                        "registers": ptxas.get("registers", "not measured"),
                        "spill_bytes": ptxas.get("spill_stores", 0) +
                        ptxas.get("spill_loads", 0),
                        "static_smem_bytes": ptxas.get("static_smem_bytes",
                                                       0)}
    return facts


def check_sample(dev, gen, results):
    """f32 logits (the earlier slices' check) and bf16, as the LM head
    writes them on the serve path; the kernels line reports bf16."""
    lines = [sample_case(dev, gen, dtype)
             for dtype in (torch.float32, torch.bfloat16)]
    for line in lines:
        emit(line)
    emit({"phase": "sample_build", **sample_build_facts()})
    results["fused_sample"] = dict(
        lines[1], max_abs_err=max(ln["max_abs_err"] for ln in lines),
        route="cuda", source="src/repro_torch/csrc/sampling.cu",
        replaces="src/repro/kernels/sampling.py:83")


# ---------------------------------------------------------------------------
# Phase 4: serve full-width InternLM2-1.8B
# ---------------------------------------------------------------------------


def own_prefill_logits(engine, tokens) -> torch.Tensor:
    """Last-token logits (V,) of ``tokens`` prefilled alone, in f32."""
    from repro_torch.models import prefill
    logits, _ = prefill(engine.cfg, engine.params,
                        torch.tensor([tokens], device=engine.device))
    return logits[0].float()


#: how far a prompt's last-token logits from a packed pass may lie from
#: its own prefill's, in bf16 ulps at the row's largest |logit|: the
#: bound the classify phase holds a request's logits to between its
#: served batch and a batch of its own (bf16 activations through 24
#: layers, products at other shapes)
PACKED_LOGIT_ULPS = 4


def packed_logit_drift(engine, prompts) -> tuple:
    """The largest |logit| difference between each prompt's last-token
    logits from a packed pass (the prompts packed in groups of 8, the
    top batch bucket) and from its own prefill, and the largest in bf16
    ulps of the row's largest |logit|; fails where one passes
    ``PACKED_LOGIT_ULPS``."""
    cfg = engine.cfg
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim),
                        device=engine.device)
    no_ids = torch.zeros((0,), dtype=torch.int32, device=engine.device)
    worst, worst_ulps = 0.0, 0.0
    for at in range(0, len(prompts), 8):
        group = prompts[at:at + 8]
        logits, _ = engine.prefill_packed_flat(group, [0] * len(group),
                                               no_kv, no_kv, no_ids, no_ids)
        for i, p in enumerate(group):
            got, own = logits[i].float(), own_prefill_logits(engine, p)
            d = float((got - own).abs().max())
            ulps = d / bf16_ulp(float(own.abs().max()))
            if not ulps <= PACKED_LOGIT_ULPS or \
                    not bool(torch.isfinite(got).all()):
                raise AssertionError(
                    f"packed prefill: prompt {at + i} ({len(p)} tokens) "
                    f"logits {d:.3g} ({ulps:.2f} bf16 ulps of the row's "
                    f"largest) from its own prefill's (limit "
                    f"{PACKED_LOGIT_ULPS})")
            worst, worst_ulps = max(worst, d), max(worst_ulps, ulps)
    return worst, worst_ulps


def draw_margins(logits, params, step: int, served: int):
    """How far the draw at ``step`` from ``logits`` (V,) lies from changing,
    and from giving the token ``served`` instead, both on the scale of a
    greedy top-2 gap (in logits / T for a sampled draw): twice the least
    move of every logit under which it can happen.

    Greedy: the top-2 gap, and the gap between the top logit and the
    served token's.  Sampled: the draw takes, among the kept ranks (top k,
    then the nucleus), the rank whose scaled value plus its Gumbel noise
    is largest; the noise belongs to the rank.  A move of every value by
    at most e moves each rank's value by at most e, so the winner changes
    only where (1) a token next to it in rank order comes within 2e and
    takes its rank, (2) another kept rank's value plus noise comes within
    2e of the winner's, or (3) the nucleus cut crosses the winner, or a
    rank that would then beat it: a rank's exclusive mass moves past
    top_p only where e reaches half the distance of their log-odds.  The
    served token is drawn only where it can take some rank q (half their
    value gap) that is kept and beats every other kept rank.  Where one
    event needs several conditions, its move is their largest, a lower
    bound: a divergence whose served gap is at or above the limit is one
    that no smaller move explains."""
    x = logits.double().cpu()
    if params.temperature <= 0:
        top = x.topk(2).values
        return float(top[0] - top[1]), float(top[0] - x[served])
    from repro_torch.runtime.sampling import (DEFAULT_SAMPLE_CANDIDATES,
                                              gumbel_noise)
    c = DEFAULT_SAMPLE_CANDIDATES
    seed = torch.tensor([params.seed], dtype=torch.int32)
    noise = gumbel_noise(seed, torch.full_like(seed, step), c)[0].double()
    # the sampler scales in f32 and orders ties by index
    scaled = (logits.float() / params.temperature).double().cpu()
    vals = torch.sort(scaled, descending=True, stable=True).values
    k = params.top_k if 0 < params.top_k <= c else c
    probs = torch.softmax(vals[:k], dim=-1)
    mass = torch.cumsum(probs, 0) - probs          # exclusive, rank order
    kept = [bool(m < params.top_p) for m in mass]
    pert = [float(v) for v in vals[:k] + noise[:k]]
    win = max((r for r in range(k) if kept[r]), key=lambda r: pert[r])
    logit_p = math.log(params.top_p / (1 - params.top_p)) \
        if params.top_p < 1 else None

    def cut(r: int) -> float:        # the nucleus crosses rank r
        m = float(mass[r])
        if logit_p is None or m <= 0:
            return math.inf
        m = min(m, 1 - 1e-12)
        return 0.5 * abs(math.log(m / (1 - m)) - logit_p)

    def beats(r: int) -> float:      # rank r's value + noise passes the rest
        rest = [pert[q] for q in range(k) if q != r and kept[q]]
        return max(0.0, (max(rest, default=-math.inf) - pert[r]) / 2)

    events = [(float(vals[win]) - float(vals[win + 1])) / 2, cut(win)]
    if win > 0:
        events.append((float(vals[win - 1]) - float(vals[win])) / 2)
    events += [max(0.0 if kept[r] else cut(r), (pert[win] - pert[r]) / 2)
               for r in range(k) if r != win]
    v_t = float(scaled[served])
    reach = [max(abs(float(vals[q]) - v_t) / 2, 0.0 if kept[q] else cut(q),
                 beats(q)) for q in range(k)]
    return 2 * min(events), 2 * min(reach)


def explain_divergence(engine, prompt, params, alone, served,
                       dlogit: float) -> dict:
    """Where a served stream leaves the request run alone: the first
    differing step, the alone run's margin there and the served token's
    gap (``draw_margins``), from a prefill of the prompt and the alone
    run's tokens before it.  ``within_rule``: the margin is below twice
    the packed pass's logit drift (the step is a near tie that rounding
    may flip), and so is the served token's gap (rounding of that size
    can give the token that was served)."""
    n = len(prompt)
    step = next(i for i, (a, b) in enumerate(zip(alone[n:], served[n:]))
                if a != b)
    logits = own_prefill_logits(engine, alone[:n + step])
    margin, served_gap = draw_margins(logits, params, step, served[n + step])
    limit = 2 * dlogit / (params.temperature if params.temperature > 0
                          else 1.0)
    return {"prompt_len": n, "sampled": params.temperature > 0,
            "first_differing_step": step, "alone_margin": margin,
            "served_token_gap": served_gap, "limit": limit,
            "within_rule": margin < limit and served_gap < limit}


def serve(dev, card: str, layout: str = "paged"):
    """The generative path over the paged pool (phase 4) or the contiguous
    slot cache (phase 7, ``layout="contiguous"``)."""
    from repro_torch.api import GenerationParams, TurboClient
    from repro_torch.kernels import cuda_lib
    rng = np.random.default_rng(SEED)
    buckets = (128, 256, 512, 1024)
    t0 = time.perf_counter()
    # one batch bucket, the slot count: generate() of one prompt then runs
    # the decode tick's matrix products at the serving batch's shape, so
    # its greedy stream can be held bit for bit against the served one
    # (cuBLAS may pick another kernel, and round otherwise, at batch 1).
    # The pool holds every slot at the top bucket, plus the trash block;
    # the contiguous slot cache is sized at the first admission and grows
    # to the top bucket.
    layout_kw = dict(num_blocks=8 * 1024 // 16 + 1) if layout == "paged" \
        else dict(kv_layout="contiguous")
    client = TurboClient.from_arch(
        "internlm2-1.8b", smoke=False, device=dev, seq_buckets=buckets,
        batch_buckets=(8,), max_slots=8, cap_new=64, init_seed=SEED,
        **layout_kw)
    engine = client.backend.engine
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    vocab = engine.cfg.vocab_size
    plens = [64, 960, 200, 512, 90, 700, 130, 333, 1000 - 64, 77, 480, 256,
             150, 600]
    specs = []
    for i, n in enumerate(plens):
        new = int(rng.integers(32, 65))
        new = min(new, 1024 - n)
        sampled = i % 3 == 1
        params = GenerationParams(
            max_new_tokens=new, temperature=0.8 if sampled else 0.0,
            top_k=50 if sampled else 0, top_p=0.95 if sampled else 1.0,
            seed=1000 + i)
        prompt = [int(t) for t in rng.integers(1, vocab, n)]
        specs.append((prompt, params))
    first, later = specs[:8], specs[8:]

    torch.cuda.reset_peak_memory_stats(dev)
    cuda_lib.reset_launches()
    t_serve = time.perf_counter()
    handles = [client.submit(p, g) for p, g in first]
    client.pump(max_ticks=6)                  # prefills + a few decodes
    handles += [client.submit(p, g) for p, g in later]   # mid-decode
    results = [h.result() for h in handles]
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t_serve
    launches = dict(cuda_lib.LAUNCHES)
    peak = torch.cuda.max_memory_allocated(dev)
    ce = client.backend
    ticks, prefills = ce.decode_ticks, ce.prefill_dispatches
    packs = list(ce.pack_log) if layout == "paged" else []

    # the paged layout admits through packed prefill (the default), the
    # contiguous one per group through the causal kernel
    decode = "flash_decode_paged" if layout == "paged" else "flash_decode"
    attention = "flash_attention_packed" if layout == "paged" \
        else "flash_attention"
    for kname in ("norm", attention, decode, "sample"):
        if launches.get(kname, 0) <= 0:
            raise AssertionError(f"kernel {kname} never launched on the "
                                 f"serving path: {launches}")
    if launches[attention] != engine.cfg.num_layers * prefills:
        raise AssertionError(
            f"{launches[attention]} {attention} launches over {prefills} "
            f"prefills (expected {engine.cfg.num_layers} per prefill)")
    other = "flash_attention" if layout == "paged" \
        else "flash_attention_packed"
    if launches.get(other, 0):
        raise AssertionError(f"{layout} serving launched {other}: "
                             f"{launches}")
    if layout == "paged" and not 0 < ce.pack_dispatches == prefills:
        raise AssertionError(f"paged serving: {ce.pack_dispatches} packed "
                             f"of {prefills} prefill dispatches")
    # two norms a layer and the final one, in every decode tick and prefill
    norms_per_step = 2 * engine.cfg.num_layers + 1
    if launches["norm"] != norms_per_step * (ticks + prefills):
        raise AssertionError(f"{launches['norm']} norm launches over {ticks} "
                             f"ticks and {prefills} prefills (expected "
                             f"{norms_per_step} each)")
    if layout == "contiguous":
        per_tick = engine.cfg.num_layers
        if launches[decode] != per_tick * ticks or \
                launches.get("flash_decode_paged", 0):
            raise AssertionError(
                f"contiguous serving: {launches[decode]} contiguous decode "
                f"launches over {ticks} ticks (expected "
                f"{per_tick} per tick) and "
                f"{launches.get('flash_decode_paged', 0)} paged")
    elif ce.block_table.used_blocks != 0:
        raise AssertionError(f"{ce.block_table.used_blocks} KV blocks "
                             "leaked after drain")
    if engine.kv_slab.live_bytes != 0:
        raise AssertionError(f"{engine.kv_slab.live_bytes} slab bytes "
                             "leaked after drain")
    gen_tokens = 0
    for (prompt, params), res, h in zip(specs, results, handles):
        out = res[len(prompt):]
        gen_tokens += len(out)
        if res[:len(prompt)] != prompt or \
                len(out) != params.max_new_tokens:
            raise AssertionError(f"request {h.req_id}: bad result shape")
        if any(not 0 <= t < vocab for t in out):
            raise AssertionError(f"request {h.req_id}: token out of range")
    # packed prefill runs the products at other shapes than a prompt's own
    # prefill, so its logits may round otherwise: how far, on these prompts
    packed_dlogit, packed_ulps = packed_logit_drift(
        engine, [p for p, _ in specs]) if layout == "paged" else (0.0, 0.0)
    # greedy streams against generate() alone; sampled streams depend on
    # their own seed alone, so against the request served again alone
    greedy_checked, sampled_checked, divergences = 0, 0, []
    for (prompt, params), res in zip(specs, results):
        if params.temperature > 0:
            alone = client.submit(prompt, params).result()
        else:
            alone = engine.generate([prompt],
                                    max_new_tokens=params.max_new_tokens)[0]
        if alone != res:
            divergences.append(explain_divergence(
                engine, prompt, params, alone, res, packed_dlogit))
        if params.temperature > 0:
            sampled_checked += alone == res
        else:
            greedy_checked += alone == res
    ttft = sorted(h.ttft for h in handles)
    emit({"phase": "serve" if layout == "paged" else "serve_contiguous",
          "model": "internlm2-1.8b (full width, 24 layers, bf16 weights "
          "from a seed, f32 KV)", "kv_layout": layout,
          "card": card, "requests": len(handles),
          "sampled": sum(1 for _, p in specs if p.temperature > 0),
          "greedy_equal_to_generate_alone": greedy_checked,
          "sampled_equal_to_served_alone": sampled_checked,
          "divergences": divergences,
          "packed_vs_own_prefill_max_abs_dlogit": packed_dlogit,
          "packed_vs_own_prefill_bf16_ulps": {
              "max": packed_ulps, "limit": PACKED_LOGIT_ULPS},
          "pack_dispatches": len(packs),
          "packs": [{"segments": n, "flat": flat, "bucket": bucket,
                     "occupancy": flat / bucket}
                    for n, flat, bucket in packs],
          "generated_tokens": gen_tokens, "serve_s": serve_s,
          "tok_per_s": gen_tokens / serve_s,
          "ttft_p50_s": float(np.percentile(ttft, 50)),
          "ttft_p99_s": float(np.percentile(ttft, 99)),
          "peak_mem_gib": peak / 2 ** 30, "stack_build_s": build_s,
          "decode_ticks": ticks, "prefill_dispatches": prefills,
          "norm_launches": {"decode": norms_per_step * ticks,
                            "prefill": norms_per_step * prefills},
          "kv_cache_gib": sum(ce.state.cache[k].numel() * 4
                              for k in ("k", "v")) / 2 ** 30,
          "launches": launches})
    beyond = [d for d in divergences if not d["within_rule"]]
    if beyond:
        raise AssertionError(f"{len(beyond)} served streams differ from the "
                             f"request alone beyond the margin rule: "
                             f"{beyond}")
    return client, launches


# ---------------------------------------------------------------------------
# Phase 6: the paper's one-shot classification service at full width
# ---------------------------------------------------------------------------

#: how far a request's last-token logits may move between its served batch
#: and a batch of its own, in bf16 ulps at the row's largest |logit|: the
#: activations are bf16 through 24 layers, and the two runs pad to other
#: shapes, so cuBLAS picks other kernels and rounds otherwise (five replays
#: on an H100 moved them by 2.5 to 2.75 such ulps)
CLASSIFY_LOGIT_ULPS = 4
#: requests whose class is held against their class alone: those whose
#: top-2 margin alone exceeds twice the tolerance (random weights give
#: many near ties, so the check walks the dp batches until it has these)
CLASSIFY_CLASSES_HELD = 16


def bf16_ulp(x: float) -> float:
    """The spacing of bf16 numbers at magnitude ``x`` (8-bit mantissa)."""
    return 2.0 ** (math.floor(math.log2(max(abs(x), 2.0 ** -126))) - 7)


def replay(system, requests) -> float:
    """Submit each request at its Poisson arrival time (on the serving
    system's monotonic clock) and step the system whenever work is
    queued; returns the wall seconds from the first arrival slot to the
    last response."""
    from repro_torch.core import Request
    t0 = time.monotonic()
    i = 0
    while i < len(requests) or not system.pipeline.idle():
        while i < len(requests) and \
                t0 + requests[i].arrival_time <= time.monotonic():
            r = requests[i]
            system.submit(Request(r.req_id, r.seq_len, t0 + r.arrival_time,
                                  r.payload))
            i += 1
        if system.pipeline.idle():
            time.sleep(max(t0 + requests[i].arrival_time - time.monotonic(),
                           0.0))
            continue
        system.step()
    return time.monotonic() - t0


def classify_phase(dev, card: str, n_requests: int = 64):
    """launch/serve.py's first phase at full width: warm the cost table,
    then serve the same Poisson request list under each policy, and hold
    served batches against each request classified alone."""
    from repro_torch.configs import get_config
    from repro_torch.core import (BucketedCostModel, ServingConfig,
                                  ServingSystem)
    from repro_torch.data import LengthDistribution, RequestGenerator
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import InferenceEngine
    cfg = get_config("internlm2-1.8b")
    ladder = BucketLadder(seq_buckets=(32, 64, 128, 256, 512),
                          batch_buckets=(1, 2, 4, 8, 16, 32))
    engine = InferenceEngine(cfg, init_params(cfg, seed=SEED, device=dev),
                             ladder=ladder, device=dev)
    t0 = time.perf_counter()
    table = engine.warmup(lengths=(32, 128, 512), batches=(1, 4, 16))
    warm_s = time.perf_counter() - t0
    cost = BucketedCostModel(table, buckets=ladder.seq_buckets)
    rate = 200.0
    requests = RequestGenerator(
        rate=rate, lengths=LengthDistribution("uniform", 5, 500),
        vocab_size=cfg.vocab_size, seed=0).generate(
            2 * n_requests / rate)[:n_requests]
    if len(requests) != n_requests:
        raise AssertionError(f"the generator gave {len(requests)} requests")
    emit({"phase": "classify_cost_table", "card": card, "warmup_s": warm_s,
          "seconds_by_len_and_batch": [[ln, b, t] for (ln, b), t
                                       in sorted(table.table.items())]})
    served, logs, softmax_launches = {}, {}, {}
    for policy in ("dp", "naive", "nobatch"):
        system = ServingSystem(execute=engine.execute_requests,
                               cost_model=cost,
                               config=ServingConfig(policy=policy,
                                                    max_batch_size=20))
        torch.cuda.synchronize()
        cuda_lib.reset_launches()
        wall = replay(system, requests)
        launches = dict(cuda_lib.LAUNCHES)
        batches = list(system.pipeline.batch_log)
        if launches.get("softmax", 0) != cfg.num_layers * len(batches) or \
                launches.get("flash_attention", 0):
            raise AssertionError(
                f"classify ({policy}): {launches} over {len(batches)} "
                f"batches; expected {cfg.num_layers} softmax launches per "
                "batch and no flash attention")
        resp = system.responses
        if len(resp) != n_requests or any(r.result is None for r in resp):
            raise AssertionError(f"classify ({policy}): {len(resp)} "
                                 "responses, or one without a result")
        if any(not 0 <= r.result < cfg.vocab_size for r in resp):
            raise AssertionError(f"classify ({policy}): class out of range")
        lats = sorted(r.latency for r in resp)
        served[policy] = {r.req_id: r.result for r in resp}
        logs[policy] = batches
        softmax_launches[policy] = launches["softmax"]
        emit({"phase": "classify", "policy": policy, "card": card,
              "requests": n_requests, "offered_rate_per_s": rate,
              "lengths": "uniform 5-500", "wall_s": wall,
              "resp_per_s": n_requests / wall,
              "latency_p50_s": float(np.percentile(lats, 50)),
              "latency_p99_s": float(np.percentile(lats, 99)),
              "batches": len(batches),
              "batch_sizes": [len(b) for b in batches],
              "padded_lens": sorted({r.padded_len for r in resp}),
              "launches": launches})
    agree = {p: sum(served[p][i] == served["dp"][i] for i in served["dp"])
             for p in ("naive", "nobatch")}

    # the dp run's batches again, each as it was served (same members,
    # same buckets), against every member classified alone
    by_id = {r.req_id: r for r in requests}
    order = sorted(logs["dp"], key=len, reverse=True)
    checked, held, near_ties, worst, worst_ulps = 0, 0, 0, 0.0, 0.0
    for batch in order:
        logits = engine.classify_logits(
            [by_id[i].payload for i in batch]).float()
        preds = logits.argmax(dim=-1).tolist()
        if preds != [served["dp"][i] for i in batch]:
            raise AssertionError("classify: the served batch, run again, "
                                 "gives other predictions")
        for row, rid in zip(logits, batch):
            alone = engine.classify_logits([by_id[rid].payload])[0].float()
            diff = float((row - alone).abs().max())
            tol = CLASSIFY_LOGIT_ULPS * bf16_ulp(float(alone.abs().max()))
            worst = max(worst, diff)
            worst_ulps = max(worst_ulps, diff / (tol / CLASSIFY_LOGIT_ULPS))
            if diff > tol:
                raise AssertionError(
                    f"classify: request {rid}'s logits move by {diff:.4g} "
                    f"between its batch of {len(batch)} and a batch of its "
                    f"own (tolerance {tol:.4g})")
            # each logit may move by tol: the class is held where the top
            # two are further apart than two moves
            top2 = alone.topk(2).values
            if float(top2[0] - top2[1]) > 2 * tol:
                if int(row.argmax()) != int(alone.argmax()):
                    raise AssertionError(f"classify: request {rid}'s class "
                                         "differs from its class alone")
                held += 1
            else:
                near_ties += 1
            checked += 1
        # on through the dp batches until 16 classes have been held
        if held >= CLASSIFY_CLASSES_HELD:
            break
    if held < CLASSIFY_CLASSES_HELD:
        raise AssertionError(
            f"classify: only {held} of {checked} requests have a top-2 "
            f"margin clear of the tolerance; {CLASSIFY_CLASSES_HELD} are "
            "needed to hold the class")
    emit({"phase": "classify_batched_vs_alone", "card": card,
          "requests_checked": checked, "classes_held": held,
          "dp_batches_checked": order.index(batch) + 1,
          "largest_batch_checked": len(order[0]),
          "max_abs_logit_diff": worst,
          "max_diff_in_bf16_ulps_of_the_row_max": worst_ulps,
          "tolerance": {"bf16_ulps_of_the_row_max": CLASSIFY_LOGIT_ULPS,
                        "why": "bf16 activations; the batch and the request "
                        "alone pad to other shapes and round otherwise"},
          "near_ties_not_held_to_equal_class": near_ties,
          "near_tie": "top-2 margin of the row alone within twice the "
                      "tolerance",
          "predictions_equal_to_dp": agree})
    return softmax_launches["dp"]


# ---------------------------------------------------------------------------
# Phase 5: where a full-width decode tick spends its time
# ---------------------------------------------------------------------------


def kernel_family(name: str) -> str:
    if "repro" in name:
        return "port kernels"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "gemv",
                                       "nvjet")):
        return "matmul (cuBLAS)"
    return "other PyTorch kernels"


def split_profile(prof):
    """Device busy microseconds by kernel family, the device kernels and
    the host ops (each as (us, count, name)) of a profiler run: device
    work from the trace's own events, host ops from the averaged view's
    self times."""
    busy_us, by_name, host = {}, {}, []
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            us = evt.time_range.elapsed_us()
            fam = kernel_family(evt.name)
            busy_us[fam] = busy_us.get(fam, 0.0) + us
            total, count = by_name.get(evt.name, (0.0, 0))
            by_name[evt.name] = (total + us, count + 1)
    for evt in prof.key_averages():
        if not is_kernel(evt) and evt.self_cpu_time_total > 0:
            host.append((evt.self_cpu_time_total, evt.count, evt.key))
    kernels = [(us, count, name) for name, (us, count) in by_name.items()]
    return busy_us, kernels, host


#: each launch counter's kernel, by the parts of its name in a trace
PORT_KERNELS = {"norm": ("norm_kernel",),
                "flash_attention": ("flash_attention_bf16_kernel",),
                "flash_attention_packed": ("flash_attention_packed_kernel",),
                "flash_decode_paged": ("decode_kernel", "PagedRows"),
                "flash_decode": ("decode_kernel", "StridedRows"),
                "sample": ("sample_kernel",), "softmax": ("softmax",)}


def cross_check(prof, kernels, launches: dict) -> dict:
    """The profiler's count of each of the port's kernels (in the trace's
    events, and in its averaged view) against the wrappers' launch
    counters over the same window: each counted launch is one kernel, so
    a shortfall in the trace means it lost events and its busy totals
    read low."""
    averaged = [(evt.count, evt.key) for evt in prof.key_averages()
                if is_kernel(evt)]
    by_kernel = {}
    for name, parts in PORT_KERNELS.items():
        seen = sum(count for _, count, key in kernels
                   if all(p in key for p in parts))
        if seen or launches.get(name, 0):
            by_kernel[name] = {
                "trace": seen, "counted": launches.get(name, 0),
                "averaged_view": sum(count for count, key in averaged
                                     if all(p in key for p in parts))}
    seen = sum(v["trace"] for v in by_kernel.values())
    counted = sum(launches.values())
    return {"profiler_port_kernels": seen, "launch_counters": counted,
            "by_kernel": by_kernel,
            "trace_complete": all(v["trace"] >= v["counted"]
                                  for v in by_kernel.values())}


def busy_or_not_measured(value, check: dict):
    """A busy total, or why it is not given."""
    if not check["trace_complete"]:
        return (f"not measured: the trace holds "
                f"{check['profiler_port_kernels']} of "
                f"{check['launch_counters']} counted port launches")
    return value if value else "not measured: the profiler saw no device time"


def in_trace(busy_us: dict, per: int, check: dict, wall_ms: float,
             flash_us: float = 0.0) -> dict:
    """Where the trace lost a port launch: the busy time, by kernel family
    and in all, of the kernels it does hold (per tick where ``per`` is the
    window's ticks), the idle share they leave (an upper bound: the lost
    kernels' time is not in it) and, given ``flash_us``, the flash
    kernel's share of their busy time, labelled as such; nothing where
    the trace is complete."""
    if check["trace_complete"]:
        return {}
    busy = sum(busy_us.values())
    out = {"all": busy / 1e3 / per,
           **{k: v / 1e3 / per for k, v in sorted(busy_us.items())},
           "idle_share_at_most": 1 - busy / 1e3 / wall_ms,
           "holds": f"{check['profiler_port_kernels']} of "
                    f"{check['launch_counters']} counted port launches"}
    if flash_us:
        out["flash_share"] = flash_us / busy
    return {"busy_ms_of_the_kernels_in_the_trace": out}


def gumbel_noise_cost(rows: int, cands: int, calls: int) -> dict:
    """What ``gumbel_noise`` alone launches for ``rows`` rows of ``cands``
    values: device kernels, device time and host self-time per call."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.runtime.sampling import gumbel_noise
    seed = torch.arange(rows, dtype=torch.int32, device="cuda") + 1000
    step = torch.zeros_like(seed)
    gumbel_noise(seed, step, cands)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            gumbel_noise(seed, step + i, cands)
        torch.cuda.synchronize()
    _, kernels, host = split_profile(prof)
    return {"kernels_per_call": sum(c for _, c, _ in kernels) / calls,
            "device_ms_per_call": sum(u for u, _, _ in kernels) / 1e3
            / calls,
            "host_self_ms_per_call": sum(u for u, _, _ in host) / 1e3 / calls}


def traced_window(run):
    """``run()`` under torch.profiler with the launch counters set to 0
    just before it.  Returns the profiler, the window's wall milliseconds,
    its launches, the split profile, the cross-check and ``run``'s
    result."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import cuda_lib
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        result = run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    launches = dict(cuda_lib.LAUNCHES)
    split = split_profile(prof)
    check = cross_check(prof, split[1], launches)
    return prof, wall_ms, launches, split, check, result


def profile_decode(client, card: str, ticks: int = 10,
                   sampled: bool = False) -> None:
    """Eight rows decoding at full width, greedy or (``sampled``) with
    temperature, top-k and top-p: host time per tick, and from
    torch.profiler the device's busy time by kernel family and its idle
    share over the window, cross-checked against the launch counters; a
    sampled window also gives the sample kernel's device time and what
    the Gumbel noise launches per tick."""
    from repro_torch.api import GenerationParams
    rng = np.random.default_rng(SEED + (3 if sampled else 1))
    vocab = client.backend.engine.cfg.vocab_size
    ce = client.backend
    if any(s is not None for s in ce.sessions):
        raise AssertionError("profile_decode: a slot is still live")
    # the engine's sampling flag is sticky for the life of its state (as
    # the reference's); with every slot free, clear it, so greedy rows run
    # the greedy tick and not the sampling one the serve phase left on
    ce.state.sampling = False
    params = [GenerationParams(max_new_tokens=64, temperature=0.8, top_k=50,
                               top_p=0.95, seed=2000 + i) if sampled
              else GenerationParams(max_new_tokens=64) for i in range(8)]
    handles = [client.submit([int(t) for t in rng.integers(1, vocab, n)], p)
               for n, p in zip((100, 200, 300, 400, 500, 600, 700, 800),
                               params)]
    while client.pipeline.queue:                 # admit all eight
        client.pump(max_ticks=1)
    client.pump(max_ticks=2)                     # settle into decode
    prof, wall_ms, launches, (busy_us, kernels, host), check, _ = \
        traced_window(lambda: client.pump(max_ticks=ticks))
    for h in handles:
        h.cancel()
    busy_ms = sum(busy_us.values()) / 1e3
    complete = check["trace_complete"] and busy_ms > 0

    def top(rows, n):
        return [{"name": name[:80], "ms_per_tick": us / 1e3 / ticks,
                 "calls_per_tick": count / ticks}
                for us, count, name in sorted(rows, reverse=True)[:n]]
    line = {"phase": "profile_decode_sampled" if sampled else
            "profile_decode", "card": card, "rows": len(handles),
            "ticks": ticks, "tick_ms": wall_ms / ticks,
            "note": "tick_ms is taken under the profiler, which slows the "
                    "host; device times are the kernels' own" +
                    ("" if sampled else "; the served mix runs the sampled "
                     "tick once a sampled request has been admitted (the "
                     "flag is sticky): this greedy tick is what an "
                     "all-greedy engine runs"),
            "launch_cross_check": check, "launches": launches,
            "device_busy_ms_per_tick": busy_or_not_measured(
                busy_ms / ticks, check),
            "device_idle_share": (1 - busy_ms / wall_ms) if complete
            else busy_or_not_measured(None, check),
            "kernel_launches_per_tick": sum(c for _, c, _ in kernels) / ticks,
            "host_ops_self_ms_per_tick": sum(u for u, _, _ in host) / 1e3
            / ticks,
            "busy_ms_per_tick_by_family": {
                k: v / 1e3 / ticks for k, v in sorted(busy_us.items())}
            if complete else busy_or_not_measured(None, check),
            **in_trace(busy_us, ticks, check, wall_ms),
            "top_device_kernels": top(kernels, 6),
            "top_host_ops_self_time": top(host, 10)}
    if not sampled and launches.get("sample", 0):
        raise AssertionError(f"profile_decode: {launches} (a greedy "
                             "window launched the sampler)")
    if sampled:
        if launches.get("sample", 0) != ticks:
            raise AssertionError(f"profile_decode_sampled: {launches} over "
                                 f"{ticks} ticks (expected one sample "
                                 "launch per tick)")
        sample_us = sum(us for us, _, name in kernels if "sample_kernel" in
                        name)
        line["sample_kernel_device_ms_per_tick"] = (
            sample_us / 1e3 / ticks if sample_us else "not measured")
        line["gumbel_noise_alone"] = gumbel_noise_cost(len(handles), 64,
                                                       ticks)
    emit(line)


#: profile_prefill's eight prompts (the 1024 bucket), packed too by
#: profile_prefill_packed
PROFILE_PREFILL_LENS = (1000, 1010, 990, 1023, 900, 1020, 1015, 1005)


def profile_prefill(client, card: str, packed: bool = False) -> None:
    """One prefill of eight prompts at full width under torch.profiler:
    at the 1024 bucket, eight rows of it (the per-group path), or
    (``packed``) the same prompts as one pack of 7963 tokens in the 8192
    pack bucket (the paged path's default).  Wall time, the device's busy
    time by kernel family and its idle share, and the flash kernel's
    device time, share and rate over its 24 launches."""
    engine = client.backend.engine
    cfg = engine.cfg
    rng = np.random.default_rng(SEED + 2)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in PROFILE_PREFILL_LENS]
    kname = "flash_attention_packed" if packed else "flash_attention"
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads, cfg.head_dim),
                        device=engine.device)
    no_ids = torch.zeros((0,), dtype=torch.int32, device=engine.device)

    def prefill():
        if packed:
            return engine.prefill_packed_flat(prompts, [0] * len(prompts),
                                              no_kv, no_kv, no_ids,
                                              no_ids)[0]
        state = engine.prefill_batch(prompts, max_len=1024, max_new_tokens=1,
                                     prompt_kv_only=True)
        return state.cur
    prefill()                                    # warm: same shapes
    prof, wall_ms, launches, (busy_us, kernels, host), check, out = \
        traced_window(prefill)
    if launches.get(kname, 0) != cfg.num_layers:
        raise AssertionError(f"profile_prefill: {launches} (expected "
                             f"{cfg.num_layers} {kname} launches)")
    first = out[:len(prompts)].argmax(dim=-1) if packed else \
        out[:len(prompts)]
    if bool(((first < 0) | (first >= cfg.vocab_size)).any()):
        raise AssertionError("profile_prefill: first token out of range")
    if packed and not bool(torch.isfinite(out.float()).all()):
        raise AssertionError("profile_prefill_packed: non-finite logits")
    del out
    busy_ms = sum(busy_us.values()) / 1e3
    complete = check["trace_complete"] and busy_ms > 0
    needle = PORT_KERNELS[kname][0]
    flash_us = sum(us for us, _, name in kernels if needle in name)
    b, s, h, dh = 8, 1024, cfg.num_heads, cfg.head_dim
    flat = sum(PROFILE_PREFILL_LENS)
    # the work the prompts need: each one's causal pairs
    pairs = sum(n * (n + 1) / 2 for n in PROFILE_PREFILL_LENS) if packed \
        else b * s * (s + 1) / 2
    flops = cfg.num_layers * 4.0 * h * dh * pairs
    emit({"phase": "profile_prefill_packed" if packed else "profile_prefill",
          "card": card, "rows": 1 if packed else b,
          "bucket": engine.ladder.pack_bucket(flat) if packed else s,
          "flat_tokens": flat if packed else b * s,
          "prompt_lens": [len(p) for p in prompts],
          "wall_ms": wall_ms,
          "note": "wall_ms is taken under the profiler, which slows the "
                  "host; device times are the kernels' own",
          "launch_cross_check": check, "launches": launches,
          "device_busy_ms": busy_or_not_measured(busy_ms, check),
          "device_idle_share": (1 - busy_ms / wall_ms) if complete
          else busy_or_not_measured(None, check),
          "busy_ms_by_family": {k: v / 1e3 for k, v in
                                sorted(busy_us.items())}
          if complete else busy_or_not_measured(None, check),
          **in_trace(busy_us, 1, check, wall_ms, flash_us),
          kname: {
              "launches": launches[kname],
              "device_ms": flash_us / 1e3 if flash_us else "not measured",
              "ms_per_launch": flash_us / 1e3 / cfg.num_layers
              if flash_us else "not measured",
              "share_of_busy": flash_us / 1e3 / busy_ms
              if flash_us and complete else "not measured",
              "tflops": flops / (flash_us * 1e-6) / 1e12
              if flash_us else "not measured"},
          "kernel_launches": sum(c for _, c, _ in kernels),
          "host_ops_self_ms": sum(u for u, _, _ in host) / 1e3,
          "top_device_kernels": [
              {"name": name[:80], "ms": us / 1e3, "calls": count}
              for us, count, name in sorted(kernels, reverse=True)[:8]]})


def release_memory() -> None:
    """Free what a finished phase left (its client holds reference
    cycles), so the next phase's peak memory is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "csrc").is_dir():
        print("chip_smoke: run from a checkout of the repository "
              "(src/repro_torch not found)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root / "src"))
    torch.backends.cuda.matmul.allow_tf32 = False   # full f32 products
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    card = smi[0].strip()
    emit({"phase": "device", "nvidia_smi": card,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    from repro_torch.kernels import cuda_lib
    t0 = time.perf_counter()
    cuda_lib.library()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "built": cuda_lib.BUILD_INFO.get("built"),
          "library": Path(str(cuda_lib.BUILD_INFO["path"])).name,
          "ptxas_registers_and_spill_bytes": {
              name: [u.get("registers"), u.get("spill_stores", 0) +
                     u.get("spill_loads", 0)]
              for name, u in cuda_lib.BUILD_INFO["ptxas"].items()}})

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    checks = {}
    check_norm(dev, gen, checks)
    check_flash_attention(dev, gen, checks)
    check_flash_attention_packed(dev, gen, checks)
    check_paged_decode(dev, gen, checks)
    check_sample(dev, gen, checks)
    check_softmax(dev, gen, checks)
    check_contiguous_decode(dev, gen, checks)

    # each path runs with the launch counters set to 0 just before it,
    # and each kernel's launches are read from the path that runs it
    client, launches = serve(dev, card)
    profile_decode(client, card)
    profile_decode(client, card, sampled=True)
    profile_prefill(client, card)
    profile_prefill(client, card, packed=True)
    del client
    release_memory()
    launches["softmax"] = classify_phase(dev, card)
    release_memory()
    # the contiguous layout admits per group: the causal kernel's path
    _, launches_c = serve(dev, card, layout="contiguous")
    launches["flash_decode"] = launches_c["flash_decode"]
    launches["flash_attention"] = launches_c["flash_attention"]
    names = {"fused_norm": "norm", "flash_attention": "flash_attention",
             "flash_attention_packed": "flash_attention_packed",
             "flash_decode_paged": "flash_decode_paged",
             "fused_sample": "sample", "fused_softmax": "softmax",
             "flash_decode": "flash_decode"}
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms", "device_ms",
            "library_device_ms")
    kernels = []
    for name, counter in names.items():
        c = checks[name]
        item = {"name": name, "launches": launches.get(counter, 0)}
        item.update({k: c[k] for k in keys})
        kernels.append(item)
    for item in kernels:
        for k, val in item.items():
            if isinstance(val, float) and not math.isfinite(val):
                raise AssertionError(f"{item['name']}: {k} is {val}")
    emit({"kernels": kernels})
    print(card, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
