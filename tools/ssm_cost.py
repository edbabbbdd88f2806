#!/usr/bin/env python3
"""Time the SSM and hybrid families' prompt pass and decode tick at full
width on one NVIDIA H100:

    python3 tools/ssm_cost.py [ARCH ...]

``ARCH`` defaults to ``falcon-mamba-7b zamba2-1.2b``.  For each model,
bf16 weights from a seed and an f32 cache: the engine's per-group
prefill (``InferenceEngine.prefill_batch``, the prefill cell's body run
eagerly) at batch buckets 1 and 8 and prompts of 128, 512 and 1000
tokens, each timed with CUDA events over one call after a warm one,
with the call's peak memory above what the weights hold; one prefill of
a 1000-token prompt at batch 1 under torch.profiler, its device time
split into matmuls, the port's kernels and PyTorch's elementwise kernels
and reductions (the scan's rounds among them); then a graphed decode
tick of the 8-row state (one replay of the captured in-place tick), its
mean over 20 replays, and the same tick run eagerly.  One JSON line a
measurement, the card's ``nvidia-smi`` name and power limit in each.
"""
import gc
import json
import subprocess
import sys
from pathlib import Path

LENS = (128, 512, 1000)
BATCHES = (1, 8)


def _ms(fn, iters: int = 1) -> float:
    import torch
    start, end = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def family(name: str) -> str:
    if "repro" in name:
        return "port kernels"
    if any(k in name.lower() for k in ("gemm", "xmma", "cutlass", "gemv",
                                       "nvjet")):
        return "matmul (cuBLAS)"
    return "elementwise and reductions (PyTorch)"


def profiled_ms(run) -> dict:
    """Device milliseconds of ``run()`` by kernel family, from the
    profiler's events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    busy = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            fam = family(evt.name)
            busy[fam] = busy.get(fam, 0.0) + evt.time_range.elapsed_us() / 1e3
    return busy


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root / "src"))
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import InferenceEngine
    from repro_torch.runtime.graphs import TickCells
    if not torch.cuda.is_available():
        print("ssm_cost: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    card = card.splitlines()[0].strip()
    dev = torch.device("cuda", 0)
    cuda_lib.library()
    archs = sys.argv[1:] or ["falcon-mamba-7b", "zamba2-1.2b"]
    for arch in archs:
        cfg = get_config(arch)
        engine = InferenceEngine(cfg, init_params(cfg, device=dev, seed=0),
                                 ladder=BucketLadder(
                                     seq_buckets=(128, 256, 512, 1024),
                                     batch_buckets=BATCHES), device=dev)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        state = None
        for b in BATCHES:
            for n in LENS:
                prompts = [[(7 * j + i) % 997 + 1 for i in range(n)]
                           for j in range(b)]

                def run():
                    return engine.prefill_batch(prompts, max_len=1024,
                                                max_new_tokens=24)
                run()
                torch.cuda.synchronize()
                torch.cuda.reset_peak_memory_stats(dev)
                ms = _ms(run)
                peak = torch.cuda.max_memory_allocated(dev) - base
                print(json.dumps({
                    "tool": "ssm_cost", "arch": arch, "card": card,
                    "what": "prefill_batch", "batch": b, "prompt": n,
                    "ms": ms, "tokens_per_s": b * n / (ms / 1e3),
                    "peak_gib_above_weights": peak / 2 ** 30}), flush=True)
                if b == 8 and n == LENS[0]:
                    state = run()
                if b == 1 and n == LENS[-1]:
                    busy = profiled_ms(run)
                    total = sum(busy.values())
                    print(json.dumps({
                        "tool": "ssm_cost", "arch": arch, "card": card,
                        "what": "prefill_profile", "batch": b, "prompt": n,
                        "device_busy_ms": total, "busy_ms_by_family": busy,
                        "share_by_family": {k: v / total
                                            for k, v in busy.items()}}),
                          flush=True)
        ticks = TickCells(engine.decode_step_inplace)
        ticks.run(state)                  # warm tick + capture + replay
        graphed = _ms(lambda: ticks.run(state), 20)
        eager = _ms(lambda: engine.decode_step_inplace(state), 5)
        print(json.dumps({
            "tool": "ssm_cost", "arch": arch, "card": card,
            "what": "decode_tick", "rows": 8, "graphed_ms": graphed,
            "eager_ms": eager, "capture_s": ticks.capture_seconds,
            "weight_gib": base / 2 ** 30}), flush=True)
        del engine, state, ticks, run
        gc.collect()           # the engine's cell tables hold cycles
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
