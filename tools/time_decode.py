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
costs from the streaming.  First comes one line of the library's build
seconds and, for every instantiation over an f32 K/V (layout, q type,
group, head dim), the count and sha1 of its SASS with addresses and
encodings dropped: two checkouts with equal digests compiled it to the
same code.  Run the versions in turns (A, B, B, A): two calls may land on
two cards.
"""
import hashlib
import json
import re
import shutil
import subprocess
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


def f32_kv_sass() -> dict:
    """Per f32-K/V decode instantiation, keyed ``layout q G dh``: its
    SASS instructions (one a line, without address and encoding), count
    and sha1.  A name without a K/V template argument (a checkout from
    before the bf16 K/V) is an f32 one."""
    from repro_torch.kernels import cuda_lib
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"sass": "not measured: no cuobjdump"}
    dump = subprocess.run([tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
                          capture_output=True, text=True, check=True).stdout
    name_re = re.compile(r"decode_kernelI(f|13__nv_bfloat16)Li(\d+)ELi(\d+)"
                         r"ENS_\d+(PagedRows|StridedRows)E(fE|E)")
    bodies, key = {}, None
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            n = name_re.search(m.group(1))
            key = None if n is None else " ".join(
                ("paged" if n[4] == "PagedRows" else "contiguous",
                 "f32" if n[1] == "f" else "bf16", f"G{n[2]}", f"dh{n[3]}"))
            if key is not None:
                bodies[key] = []
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if key is not None and m:
            bodies[key].append(m.group(1))
    return {k: {"instructions": len(v), "sha1": hashlib.sha1(
        ("\n".join(v) + "\n").encode()).hexdigest()}
        for k, v in sorted(bodies.items())}


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    here = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(here)]
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("time_decode: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import cuda_lib
    cuda_lib.library()
    print(label, json.dumps({"build_seconds": cuda_lib.BUILD_INFO.get(
        "seconds"), "f32_kv_sass": f32_kv_sass()}), flush=True)
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
