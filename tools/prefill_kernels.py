#!/usr/bin/env python3
"""The device kernels of one packed prefill, by name, for one checkout of
the port on one CUDA card:

    python3 tools/prefill_kernels.py CHECKOUT LABEL

``CHECKOUT`` is the root of a checkout (``.`` for this one; another
version unpacked with ``git archive`` under ``build/``).  Its port builds
full-width InternLM2-1.8B (bf16 weights from ``chip_smoke.SEED``) and
prefills the prompts of ``chip_smoke.PROFILE_PREFILL_LENS`` as one pack
through the public, eager ``prefill_packed_flat``: once to warm, then
three times under ``torch.profiler`` (the CUDA activity only).  Prints
one JSON line, prefixed with ``LABEL``: the device events a prefill by
kernel name, their total, and the port's launch counters over the same
window (a trace that lost an event shows it against them).  Two
checkouts' lines compare name by name.
"""
import collections
import json
import sys
from pathlib import Path

REPS = 3


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path[:0] = [str(root / "src"), str(root)]
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    if not torch.cuda.is_available():
        print("prefill_kernels: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.configs import get_config
    from repro_torch.kernels import cuda_lib
    from repro_torch.models import init_params
    from repro_torch.runtime.bucketing import BucketLadder
    from repro_torch.runtime.engine import InferenceEngine
    dev = torch.device("cuda", 0)
    cfg = get_config("internlm2-1.8b")
    engine = InferenceEngine(
        cfg, init_params(cfg, seed=chip_smoke.SEED, device=dev),
        ladder=BucketLadder(seq_buckets=(128, 256, 512, 1024),
                            batch_buckets=(8,)), device=dev)
    rng = np.random.default_rng(chip_smoke.SEED + 2)
    prompts = [[int(t) for t in rng.integers(1, cfg.vocab_size, n)]
               for n in chip_smoke.PROFILE_PREFILL_LENS]
    no_kv = torch.zeros((cfg.num_layers, 0, cfg.num_kv_heads,
                         cfg.head_dim), device=dev)
    no_ids = torch.zeros((0,), dtype=torch.int32, device=dev)

    def run():
        return engine.prefill_packed_flat(prompts, [0] * len(prompts),
                                          no_kv, no_kv, no_ids, no_ids)
    run()
    torch.cuda.synchronize()
    for _ in range(2):          # the trace now and then comes back empty
        cuda_lib.reset_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                run()
            torch.cuda.synchronize()
        counts = collections.Counter(
            evt.name[:120] for evt in prof.events()
            if evt.device_type == torch.autograd.DeviceType.CUDA)
        if counts:
            break
    print(label, json.dumps({
        "per_prefill": {name: n / REPS for name, n in sorted(counts.items())},
        "total_per_prefill": sum(counts.values()) / REPS,
        "launches": dict(cuda_lib.LAUNCHES)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
