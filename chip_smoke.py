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
   the same function) that library call;
4. serve: build ``TurboClient.from_arch("internlm2-1.8b", smoke=False)``
   (24 layers, d_model 2048, vocab 92544, bf16 weights from a seed, f32
   KV pool), serve a mixed greedy / sampled workload with mid-decode
   arrivals, check every greedy stream against ``engine.generate`` of
   its prompt alone, the leak invariants, and that every kernel of the
   path launched;
5. profile_decode: eight rows decoding at full width, the host time per
   tick and, from ``torch.profiler``, the device's busy time by kernel
   family and its idle share.

Then a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and the last
line ``{"ok": true, "device": {...}}``.  Any failure raises: the script
exits non-zero and prints no result.  It also refuses to run without a
CUDA device or outside a checkout of the repository.

TF32 is switched off for matmuls and cuDNN, so every f32 product in the
plain versions is a full f32 product.
"""
from __future__ import annotations

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


def norm_case(dev, gen, rms: bool, r: int, c: int, tol: dict) -> dict:
    """One shape of the fused norm: kernel against its plain version, and
    the times of kernel, plain version and library call."""
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
    err = max(check_close("norm y", y, y_ref, **tol),
              check_close("norm residual", s, s_ref, atol=1e-2, rtol=8e-3))
    iters = 200 if r == 8 else 50
    k_ms, p_ms, l_ms = (time_ms(kernel, iters), time_ms(plain, iters),
                        time_ms(library, iters))
    nbytes = (4 * r * c + (1 if rms else 3) * c) * 2
    b_ms, b_by = bound_ms(nbytes, 6 * r * c, H100_F32_FLOPS)
    return {"phase": "kernel_check", "kernel": "fused_norm",
            "mode": "rms" if rms else "layernorm",
            "shape": [r, c], "dtype": "bfloat16",
            "tolerance": {**tol, "why": "bf16 output; kernel and plain "
                          "version sum the row in other orders"},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms,
            "library": "F.rms_norm" if rms else "F.layer_norm",
            "bound_ms": b_ms, "bound_by": b_by}


def check_norm(dev, gen, results):
    tol = dict(atol=3e-2, rtol=2e-2)   # bf16 output: ~2 ulp at |y| <= 4
    lines = []
    for rms in (True, False):
        for r in (8, 4096):
            line = norm_case(dev, gen, rms, r, 2048, tol)
            emit(line)
            lines.append(line)
    # the kernels line reports the decode-tick shape of the main path (RMS
    # mode, R = 8) and the worst error over both modes and both shapes
    entry = dict(lines[0])
    entry["max_abs_err"] = max(ln["max_abs_err"] for ln in lines)
    results["fused_norm"] = dict(
        entry, route="cuda", source="src/repro_torch/csrc/norm.cu",
        replaces="src/repro/kernels/layernorm.py:64")


def flash_case(dev, gen, b: int, s: int, tol: dict) -> dict:
    """One causal prefill shape: kernel against its plain version, and the
    times of kernel, plain version and SDPA."""
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
    nbytes = b * s * dh * 2 * (2 * h + 2 * kv)
    flops = 4.0 * b * h * dh * s * (s + 1) / 2
    b_ms, b_by = bound_ms(nbytes, flops, H100_BF16_FLOPS)
    return {"phase": "kernel_check", "kernel": "flash_attention",
            "shape": {"B": b, "S": s, "H": h, "KV": kv, "dh": dh},
            "dtype": "bfloat16", "causal": True,
            "tolerance": {**tol, "why": tol_why_attention()},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": l_ms, "library": "F.scaled_dot_product_attention",
            "bound_ms": b_ms, "bound_by": b_by,
            "tflops": flops / (k_ms * 1e-3) / 1e12}


def check_flash_attention(dev, gen, results):
    tol = dict(atol=2e-2, rtol=2e-2)   # bf16 in/out; the plain version
    # rounds the probabilities to bf16 before P.V, the kernel keeps f32
    entry = {}
    for b, s in ((4, 128), (4, 512), (2, 1024)):
        line = flash_case(dev, gen, b, s, tol)
        emit(line)
        if s == 1024:                 # the longest prompt bucket
            entry = line
    results["flash_attention"] = dict(
        entry, route="cuda", source="src/repro_torch/csrc/flash_attention.cu",
        replaces="src/repro/kernels/flash_attention.py:91")


def tol_why_attention() -> str:
    return ("bf16 inputs and output; the plain version rounds the "
            "softmax weights to bf16 before P.V, the kernel keeps them f32")


def check_paged_decode(dev, gen, results):
    from repro_torch.kernels import flash_decode, ref
    b, h, kv, dh, bs, mb = 8, 16, 8, 128, 16, 64
    nb = b * mb + 1
    lengths = torch.linspace(1, mb * bs, b, device=dev).round().to(
        torch.int32)
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
    tol = dict(atol=4e-3, rtol=4e-3)   # a few bf16 ulps of the output

    def kernel():
        return flash_decode.flash_decode_paged_cuda(q, k_pool, v_pool,
                                                    tables, lengths)

    def plain():
        return ref.flash_decode_paged_ref(q, k_pool, v_pool, tables,
                                          lengths)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    err = check_close("flash_decode_paged", out, want, **tol)
    k_ms, p_ms = time_ms(kernel, 200), time_ms(plain, 20)
    live = int(lengths.sum())
    nbytes = 2 * live * kv * dh * 4 + 2 * b * h * dh * 2 + b * mb * 4 + b * 4
    flops = 4.0 * h * dh * live
    b_ms, b_by = bound_ms(nbytes, flops, H100_F32_FLOPS)
    line = {"phase": "kernel_check", "kernel": "flash_decode_paged",
            "shape": {"B": b, "H": h, "KV": kv, "dh": dh, "BS": bs,
                      "MB": mb, "lengths": lengths.tolist()},
            "dtype": "q bfloat16, pool float32",
            "tolerance": {**tol, "why": "the pool is f32 and the kernel "
                          "keeps f32 throughout; the plain version rounds "
                          "the softmax weights to q's bf16, and both round "
                          "the output to bf16: a few of its ulps apart"},
            "max_abs_err": err, "ms": k_ms, "plain_ms": p_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by,
            "gbytes_per_s": nbytes / (k_ms * 1e-3) / 1e9}
    emit(line)
    results["flash_decode_paged"] = dict(
        line, route="cuda", source="src/repro_torch/csrc/flash_decode.cu",
        replaces="src/repro/kernels/flash_decode.py:207")


def check_sample(dev, gen, results):
    from repro_torch.kernels import ref, sampling
    from repro_torch.runtime.sampling import gumbel_noise
    b, v, c = 8, 92544, 64
    logits = 3 * torch.randn((b, v), generator=gen, device=dev)
    logits[1, 100:110] = logits[1].max() + 1     # a tie at the top
    temp = torch.tensor([0.0, 0.7, 1.0, 1.3, 0.0, 0.9, 0.5, 2.0],
                        device=dev)
    top_k = torch.tensor([0, 0, 40, 5, 0, 100, 1, 0], dtype=torch.int32,
                         device=dev)
    top_p = torch.tensor([1.0, 0.9, 1.0, 0.8, 1.0, 0.95, 1.0, 0.5],
                         device=dev)
    seed = torch.arange(b, dtype=torch.int32, device=dev) + 11
    gumbel = gumbel_noise(seed, torch.full_like(seed, 3), c)

    def kernel():
        return sampling.sample_cuda(logits, temp, top_k, top_p, gumbel)

    def plain():
        return ref.sample_ref(logits, temp, top_k, top_p, gumbel)
    out, want = kernel(), plain()
    torch.cuda.synchronize()
    mismatch = int((out != want).sum())
    if mismatch:
        raise AssertionError(f"fused_sample: {mismatch} rows differ from "
                             f"the plain version: {out.tolist()} vs "
                             f"{want.tolist()}")
    k_ms, p_ms = time_ms(kernel, 50), time_ms(plain, 20)
    nbytes = b * v * 4 + b * c * 4 + b * 16
    b_ms, b_by = bound_ms(nbytes, 2.0 * b * v, H100_F32_FLOPS)
    line = {"phase": "kernel_check", "kernel": "fused_sample",
            "shape": {"B": b, "V": v, "C": c}, "dtype": "float32",
            "tolerance": {"tokens": "exact", "why": "integer tokens; "
                          "both versions consume the same noise"},
            "max_abs_err": float(mismatch), "ms": k_ms, "plain_ms": p_ms,
            "library_ms": None, "bound_ms": b_ms, "bound_by": b_by}
    emit(line)
    results["fused_sample"] = dict(
        line, route="cuda", source="src/repro_torch/csrc/sampling.cu",
        replaces="src/repro/kernels/sampling.py:83")


# ---------------------------------------------------------------------------
# Phase 4: serve full-width InternLM2-1.8B
# ---------------------------------------------------------------------------


def serve(dev, card: str):
    from repro_torch.api import GenerationParams, TurboClient
    from repro_torch.kernels import cuda_lib
    rng = np.random.default_rng(SEED)
    buckets = (128, 256, 512, 1024)
    t0 = time.perf_counter()
    # one batch bucket, the slot count: generate() of one prompt then runs
    # the decode tick's matrix products at the serving batch's shape, so
    # its greedy stream can be held bit for bit against the served one
    # (cuBLAS may pick another kernel, and round otherwise, at batch 1).
    # The pool holds every slot at the top bucket, plus the trash block.
    client = TurboClient.from_arch(
        "internlm2-1.8b", smoke=False, device=dev, seq_buckets=buckets,
        batch_buckets=(8,), max_slots=8, cap_new=64, init_seed=SEED,
        num_blocks=8 * 1024 // 16 + 1)
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

    for kname in ("norm", "flash_attention", "flash_decode_paged",
                  "sample"):
        if launches.get(kname, 0) <= 0:
            raise AssertionError(f"kernel {kname} never launched on the "
                                 f"serving path: {launches}")
    ce = client.backend
    if ce.block_table.used_blocks != 0:
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
    greedy_checked = 0
    for (prompt, params), res in zip(specs, results):
        if params.temperature > 0:
            continue
        alone = engine.generate([prompt],
                                max_new_tokens=params.max_new_tokens)[0]
        if alone != res:
            first_diff = next(i for i, (a, b) in enumerate(zip(alone, res))
                              if a != b)
            raise AssertionError(
                f"greedy stream differs from generate() alone at token "
                f"{first_diff - len(prompt)} of a {len(prompt)}-token "
                "prompt")
        greedy_checked += 1
    ttft = sorted(h.ttft for h in handles)
    emit({"phase": "serve", "model": "internlm2-1.8b (full width, 24 "
          "layers, bf16 weights from a seed, f32 KV pool)",
          "card": card, "requests": len(handles),
          "sampled": sum(1 for _, p in specs if p.temperature > 0),
          "greedy_equal_to_generate_alone": greedy_checked,
          "generated_tokens": gen_tokens, "serve_s": serve_s,
          "tok_per_s": gen_tokens / serve_s,
          "ttft_p50_s": float(np.percentile(ttft, 50)),
          "ttft_p99_s": float(np.percentile(ttft, 99)),
          "peak_mem_gib": peak / 2 ** 30, "stack_build_s": build_s,
          "decode_ticks": ce.decode_ticks,
          "prefill_dispatches": ce.prefill_dispatches,
          "launches": launches})
    return client, launches


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


def profile_decode(client, card: str, ticks: int = 10) -> None:
    """Eight greedy rows decoding at full width: host time per tick, and
    from torch.profiler the device's busy time by kernel family and its
    idle share over the window."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.api import GenerationParams
    rng = np.random.default_rng(SEED + 1)
    vocab = client.backend.engine.cfg.vocab_size
    handles = [client.submit([int(t) for t in rng.integers(1, vocab, n)],
                             GenerationParams(max_new_tokens=64))
               for n in (100, 200, 300, 400, 500, 600, 700, 800)]
    while client.pipeline.queue:                 # admit all eight
        client.pump(max_ticks=1)
    client.pump(max_ticks=2)                     # settle into decode
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        client.pump(max_ticks=ticks)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    busy_us, kernels, host = {}, [], []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0 and evt.self_cpu_time_total == 0:     # a device kernel
            fam = kernel_family(evt.key)
            busy_us[fam] = busy_us.get(fam, 0.0) + us
            kernels.append((us, evt.count, evt.key))
        elif evt.self_cpu_time_total > 0:
            host.append((evt.self_cpu_time_total, evt.count, evt.key))
    for h in handles:
        h.cancel()
    busy_ms = sum(busy_us.values()) / 1e3

    def top(rows, n):
        return [{"name": name[:80], "ms_per_tick": us / 1e3 / ticks,
                 "calls_per_tick": count / ticks}
                for us, count, name in sorted(rows, reverse=True)[:n]]
    emit({"phase": "profile_decode", "card": card, "rows": len(handles),
          "ticks": ticks, "tick_ms": wall_ms / ticks,
          "note": "tick_ms is taken under the profiler, which slows the "
                  "host; device times are the kernels' own",
          "device_busy_ms_per_tick": (busy_ms / ticks) if busy_ms else None,
          "device_idle_share": (1 - busy_ms / wall_ms) if busy_ms
          else None,
          "kernel_launches_per_tick": sum(c for _, c, _ in kernels) / ticks,
          "host_ops_self_ms_per_tick": sum(u for u, _, _ in host) / 1e3
          / ticks,
          "busy_ms_per_tick_by_family": {
              k: v / 1e3 / ticks for k, v in sorted(busy_us.items())}
          if busy_ms else "not measured: the profiler saw no device time",
          "top_device_kernels": top(kernels, 6),
          "top_host_ops_self_time": top(host, 10)})


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
          "library": Path(str(cuda_lib.BUILD_INFO["path"])).name})

    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    checks = {}
    check_norm(dev, gen, checks)
    check_flash_attention(dev, gen, checks)
    check_paged_decode(dev, gen, checks)
    check_sample(dev, gen, checks)

    client, launches = serve(dev, card)
    profile_decode(client, card)
    names = {"fused_norm": "norm", "flash_attention": "flash_attention",
             "flash_decode_paged": "flash_decode_paged",
             "fused_sample": "sample"}
    keys = ("route", "source", "replaces", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms")
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
