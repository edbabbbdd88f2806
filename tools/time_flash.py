#!/usr/bin/env python3
"""Time the causal flash-prefill kernel of one checkout of the port, on
one NVIDIA H100, to compare two versions of the kernel in one call:

    python3 tools/time_flash.py CHECKOUT LABEL

``CHECKOUT`` is the root of a checkout (``.`` for this one; another
version unpacked with ``git archive`` under ``build/``).  Its kernels are
built from its own ``src/repro_torch/csrc`` and checked with its own
``chip_smoke.flash_case`` (kernel against the plain version at atol and
rtol 2e-2, CUDA-event and profiler times, SDPA beside it) at the check's
shapes: B 2 at S 1024 and B 8 at S 128, 512 and 1024; and, where the
checkout has the packed mode, ``chip_smoke.packed_case`` at its packs
(case (a) beside the causal kernel at B 8 x 1024; where the checkout
builds the pack's plan apart, its times too).  One JSON line per
shape, prefixed with ``LABEL``, and first a ``sass`` line: the causal
bf16 kernel's instruction count and a digest of its SASS with addresses
and encodings dropped (two checkouts with one digest compiled it to the
same code), the listing itself written to ``SASS_DIR/LABEL.sass`` when a
third argument names a directory.  Run the versions in turns (A, B, B,
A): two calls may land on two cards.
"""
import hashlib
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

SHAPES = ((2, 1024), (8, 128), (8, 512), (8, 1024))
KEYS = ("max_abs_err", "ms", "device_ms", "library_ms", "library_device_ms",
        "plain_ms", "bound_ms", "tflops", "device_tflops")


def causal_sass(label: str, sass_dir) -> dict:
    """The causal bf16 kernel's SASS, one instruction a line without its
    address and encoding: count and sha1, the listing to ``sass_dir``."""
    from repro_torch.kernels import cuda_lib
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        return {"sass": "not measured: no cuobjdump"}
    dump = subprocess.run([tool, "-sass", str(cuda_lib.BUILD_INFO["path"])],
                          capture_output=True, text=True, check=True).stdout
    body, inside = [], False
    for line in dump.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            # the dh 128 instantiation (dh 64 has one of its own)
            inside = "flash_attention_bf16_kernel" in m.group(1) and \
                "Li64E" not in m.group(1)
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)
        if inside and m:
            body.append(m.group(1))
    text = "\n".join(body) + "\n"
    if sass_dir is not None:
        Path(sass_dir).mkdir(parents=True, exist_ok=True)
        (Path(sass_dir) / f"{label}.sass").write_text(text)
    return {"instructions": len(body),
            "sha1": hashlib.sha1(text.encode()).hexdigest()}


def main() -> int:
    root, label = Path(sys.argv[1]).resolve(), sys.argv[2]
    sass_dir = sys.argv[3] if len(sys.argv) > 3 else None
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
    print(label, json.dumps({"sass": causal_sass(label, sass_dir)}),
          flush=True)
    for b, s in SHAPES:
        line = chip_smoke.flash_case(dev, gen, b, s,
                                     dict(atol=2e-2, rtol=2e-2))
        print(label, json.dumps({"B": b, "S": s,
                                 **{k: line.get(k) for k in KEYS},
                                 "build": facts}), flush=True)
    for case in getattr(chip_smoke, "PACKED_CASES", ()):
        line = chip_smoke.packed_case(dev, gen, *case)
        print(label, json.dumps({"case": line["case"],
                                 **{k: line.get(k) for k in KEYS},
                                 "plan": line.get("plan"),
                                 "against_causal": line.get(
                                     "against_causal")}), flush=True)
        chip_smoke.release_memory()
    return 0


if __name__ == "__main__":
    sys.exit(main())
