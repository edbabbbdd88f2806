#!/usr/bin/env python3
"""Time the fused AddBias + Residual + Norm kernel of one checkout of the
port, on one NVIDIA H100, to compare two versions of the kernel in one
call:

    python3 tools/time_norm.py CHECKOUT LABEL

``CHECKOUT`` is the root of a checkout (``.`` for this one; another
version unpacked with ``git archive`` under ``build/``).  Its kernels are
built from its own ``src/repro_torch/csrc`` and driven through its own
wrapper, while the cases and the timing are this checkout's
``chip_smoke.norm_case``: RMS and LayerNorm mode at C 2048, bf16, at the
decode tick's 8 rows and a B 8 x 1024 prefill's 8192, each against the
plain version (the updated residual bit for bit), with the device time
per call with the L2 flushed before each call (``device_ms``), back to
back (``device_ms_warm_l2``) and, at 8192 rows, flushed with the writes'
trip to device memory counted (``device_ms_cold_writeback``).  Where the checkout's library has the empty
``repro_floor`` kernel, its device time on the 8-row launch's grid too.
One JSON line per case, prefixed with ``LABEL``.  Run the versions in
turns (A, B, B, A): two calls may land on two cards.
"""
import json
import sys
from pathlib import Path

KEYS = ("max_abs_err", "ms", "device_ms", "device_ms_warm_l2",
        "device_ms_cold_writeback", "bound_ms", "share_of_bound",
        "share_of_bound_warm_l2", "share_of_bound_cold_writeback",
        "library_device_ms")


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(here)]
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda_lib
    if not torch.cuda.is_available():
        print("time_norm: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    for rms in (True, False):
        for r in chip_smoke.NORM_ROWS:
            line = chip_smoke.norm_case(dev, gen, rms, r, 2048,
                                        chip_smoke.NORM_TOL)
            print(label, json.dumps({"mode": line["mode"], "rows": r,
                                     **{k: line.get(k) for k in KEYS}}),
                  flush=True)
    if hasattr(cuda_lib.library(), "repro_floor"):
        print(label, json.dumps({"repro_floor_device_ms":
                                 chip_smoke.floor_device_ms(8, 256)}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
