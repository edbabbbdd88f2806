#!/usr/bin/env python3
"""Time the two split-K decode kernels of one checkout of the port, on one
NVIDIA H100, to compare two versions of the kernel in one call:

    python3 tools/time_decode.py CHECKOUT LABEL [--ladder]

``CHECKOUT`` is the root of a checkout (``.`` for this one; another
version unpacked with ``git archive`` under ``build/``).  Its kernels are
built from its own ``src/repro_torch/csrc`` and driven through its own
wrappers, while the cases and the timing are this checkout's
``chip_smoke.paged_decode_case`` and ``contiguous_decode_case``: each
kernel against its plain version at atol and rtol 4e-3 (the contiguous
one also bit for bit against the paged one), at B 8, H 16, KV 8, dh 128
over lengths 1..1024 and at full load (every row 1024), with the device
time per call with the L2 flushed before each call (``device_ms``) and
back to back (``device_ms_warm_l2``).  One JSON line per kernel and
case, prefixed with ``LABEL``.  ``--ladder`` times other lengths instead
(every row 1, 128, 129 or 1024, one row 1024), which separate the fixed
costs from the streaming.  Run the versions in turns (A, B, B, A): two
calls may land on two cards.
"""
import json
import sys
from pathlib import Path

#: with --ladder: lengths that separate the fixed costs (launch, the
#: start of a block, the split merge) from the streaming
LADDER = (("every row 1", [1] * 8), ("every row 128", [128] * 8),
          ("every row 129", [129] * 8), ("one row 1024", [1] * 7 + [1024]),
          ("every row 1024", [1024] * 8))
KEYS = ("max_abs_err", "ms", "device_ms", "device_ms_warm_l2", "bound_ms",
        "share_of_bound", "share_of_bound_warm_l2",
        "max_abs_diff_vs_paged_kernel", "library_device_ms")


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(here)]
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    cases = chip_smoke.DECODE_CASES
    if "--ladder" in sys.argv:
        cases = LADDER
    for case in (chip_smoke.paged_decode_case,
                 chip_smoke.contiguous_decode_case):
        for name, which in cases:
            line = case(dev, gen, name, which)
            print(label, json.dumps({"kernel": line["kernel"], "case": name,
                                     **{k: line.get(k) for k in KEYS}}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
