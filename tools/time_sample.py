#!/usr/bin/env python3
"""Time the fused sampling kernel of one checkout of the port, on one
NVIDIA H100, to compare two versions of the kernel in one call:

    python3 tools/time_sample.py CHECKOUT LABEL

``CHECKOUT`` is the root of a checkout (``.`` for this one; another
version unpacked with ``git archive`` under ``build/``).  Its kernels are
built from its own ``src/repro_torch/csrc`` and driven through its own
wrapper, while the case and the timing are this checkout's
``chip_smoke.sample_case``: B 8, V 92544, C 64, every token against the
plain version, the device time per call with the L2 flushed before each
call (``device_ms``) and back to back (``device_ms_warm_l2``).  f32
logits always; bf16 where the checkout's wrapper takes them.  One JSON
line per dtype, prefixed with ``LABEL``.  Run the versions in turns (A,
B, B, A): two calls may land on two cards.
"""
import json
import sys
from pathlib import Path

KEYS = ("max_abs_err", "ms", "device_ms", "device_ms_warm_l2", "bound_ms",
        "share_of_bound", "share_of_bound_warm_l2", "plain_ms")


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(here)]
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("time_sample: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    for dtype in (torch.float32, torch.bfloat16):
        try:
            line = chip_smoke.sample_case(dev, gen, dtype)
        except ValueError as err:       # an f32-only wrapper refuses bf16
            print(label, json.dumps({"dtype": str(dtype),
                                     "refused": str(err)}), flush=True)
            continue
        print(label, json.dumps({"dtype": str(dtype),
                                 **{k: line.get(k) for k in KEYS}}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
