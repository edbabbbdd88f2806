#!/usr/bin/env python3
"""Time the causal flash-prefill kernel of one checkout of the port, on
one NVIDIA H100, to compare two versions of the kernel in one call:

    python3 tools/time_flash.py CHECKOUT LABEL

``CHECKOUT`` is the root of a checkout (``.`` for this one; another
version unpacked with ``git archive`` under ``build/``).  Its kernels are
built from its own ``src/repro_torch/csrc`` and checked with its own
``chip_smoke.flash_case`` (kernel against the plain version at atol and
rtol 2e-2, CUDA-event and profiler times, SDPA beside it) at the check's
shapes: B 2 at S 1024 and B 8 at S 128, 512 and 1024.  One JSON line per
shape, prefixed with ``LABEL``.  Run the versions in turns (A, B, B, A):
two calls may land on two cards.
"""
import json
import sys
from pathlib import Path

SHAPES = ((2, 1024), (8, 128), (8, 512), (8, 1024))
KEYS = ("max_abs_err", "ms", "device_ms", "library_ms", "library_device_ms",
        "plain_ms", "bound_ms", "tflops", "device_tflops")


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sys.path[:0] = [str(root / "src"), str(root)]
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("time_flash: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    facts = chip_smoke.flash_build_facts()["bf16"]
    for b, s in SHAPES:
        line = chip_smoke.flash_case(dev, gen, b, s,
                                     dict(atol=2e-2, rtol=2e-2))
        print(label, json.dumps({"B": b, "S": s,
                                 **{k: line.get(k) for k in KEYS},
                                 "build": facts}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
