#!/usr/bin/env python3
"""Run the paged serve phase (or ``serve_contiguous`` or
``serve_prefix_chunked``) of one checkout of the port several times in
one process, on one NVIDIA H100, to compare two versions of the serving
path in one call:

    python3 tools/serve_ab.py CHECKOUT LABEL [REPEATS [PHASE]]

``PHASE`` is ``serve`` (the default), ``serve_contiguous`` (the same mix
over the contiguous slot cache, its grow to 2048 included) or
``serve_prefix_chunked`` (its packed and per-group runs, one line each).

``CHECKOUT`` is the root of a checkout (``.`` for this one; another
version unpacked with ``git archive`` under ``build/``).  Its kernels are
built from its own ``src/repro_torch/csrc`` and its own client serves;
the serve and contiguous phases run the checkout's own
``chip_smoke.serve`` (its checks fit its wrappers' launch counters; the
workload, full-width InternLM2-1.8B from a seed and the 14 requests of
the serve mix after ``warmup_aot``, is the same in the versions it
compares), the prefix-cache phase this checkout's.  Each run builds a new
client.  One JSON line per run, prefixed with ``LABEL``: tok/s, TTFT p50
and p99, the serve's seconds and the client's build seconds.  Run the
versions in turns (A, B, B, A): two calls may land on two cards.
"""
import json
import subprocess
import sys
from pathlib import Path

KEYS = ("tok_per_s", "ttft_p50_s", "ttft_p99_s", "serve_s", "stack_build_s")


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    repeats = int(sys.argv[3]) if len(sys.argv) > 3 else 2
    phase = sys.argv[4] if len(sys.argv) > 4 else "serve"
    if phase not in ("serve", "serve_contiguous", "serve_prefix_chunked"):
        print(f"serve_ab: unknown phase {phase}", file=sys.stderr)
        return 2
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"),
                    str(here if phase == "serve_prefix_chunked" else root)]
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda_lib
    if not torch.cuda.is_available():
        print("serve_ab: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    card = card.splitlines()[0].strip()
    dev = torch.device("cuda", 0)
    cuda_lib.library()
    lines = []
    chip_smoke.emit = lines.append          # keep the phase's line
    for r in range(repeats):
        del lines[:]
        if phase != "serve_prefix_chunked":
            client, _ = chip_smoke.serve(
                dev, card, layout="paged" if phase == "serve" else
                "contiguous")
            del client
        else:
            chip_smoke.serve_prefix_chunked(dev, card)
        chip_smoke.release_memory()
        for line in [ln for ln in lines if ln.get("phase") == phase]:
            cells = line.get("prefill_cells", {})
            print(label, json.dumps({"repeat": r, "card": card,
                                     "mode": line.get("mode"),
                                     **{k: line.get(k) for k in KEYS},
                                     "capture_s_while_serving": cells.get(
                                         "capture_s_while_serving")}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
