#!/usr/bin/env python3
"""Build the fused norm kernel with other bodies for rows of 2048 bf16 and
time each on one NVIDIA H100, in one call:

    python3 tools/norm_variants.py 32:8 64:4 128:2 256:1

Each ``THREADS:VECTORS`` argument is a body of ``src/repro_torch/csrc/
norm.cu``: THREADS a row (32, one warp; more, one block a row with one
barrier) and VECTORS 16-byte vectors a thread, THREADS * VECTORS * 8 =
2048.  The variants are built into one library under
``build/norm_variants/`` (the source with its list of bodies replaced),
each timed in a process of its own with the wrapper's plan pointed at
it: ``chip_smoke.norm_case`` (the plain version's tolerance, the updated
residual bit for bit, device time with a cold and a warm L2) in RMS and
LayerNorm mode at 8 and 8192 rows, then the empty ``repro_floor`` kernel
on the 8-row launch's grid.  One JSON line per variant and case.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("max_abs_err", "device_ms", "device_ms_warm_l2",
        "device_ms_cold_writeback", "bound_ms", "share_of_bound",
        "share_of_bound_warm_l2", "share_of_bound_cold_writeback")


def build(variants):
    from repro_torch.kernels import cuda_lib
    src = (cuda_lib.CSRC / "norm.cu").read_text()
    bodies = " ".join(f"X({t}, {v})" for t, v in variants)
    text = re.sub(r"#define REPRO_NORM_BODIES\(X\)[^\n]*\\\n[^\n]*\\\n"
                  r"[^\n]*\n", f"#define REPRO_NORM_BODIES(X) {bodies}\n",
                  src)
    if text == src:
        raise RuntimeError("norm.cu: the list of bodies was not found")
    out = ROOT / "build" / "norm_variants"
    out.mkdir(parents=True, exist_ok=True)
    (out / "norm.cu").write_text(text)
    (out / "common.cuh").write_text(
        (cuda_lib.CSRC / "common.cuh").read_text())
    lib = out / "libnorm.so"
    run = subprocess.run([cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
                          str(out / "norm.cu"), "-o", str(lib)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                         text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}")
    return lib


def time_one(threads: int, vectors: int, path: str) -> None:
    import ctypes

    import torch

    import chip_smoke
    from repro_torch.kernels import cuda_lib, layernorm
    lib = ctypes.CDLL(path)
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if "norm" in name or "floor" in name:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    cuda_lib._lib = lib              # the wrapper now launches this variant
    layernorm.norm_plan = lambda cols, dtype: layernorm.NormPlan(threads,
                                                                 vectors)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    for rms in (True, False):
        for r in chip_smoke.NORM_ROWS:
            line = chip_smoke.norm_case(dev, gen, rms, r, 2048,
                                        chip_smoke.NORM_TOL)
            print(json.dumps({"threads": threads, "vectors": vectors,
                              "mode": line["mode"], "rows": r,
                              **{k: line.get(k) for k in KEYS}}),
                  flush=True)
    print(json.dumps({"threads": threads, "vectors": vectors,
                      "repro_floor_device_ms":
                      chip_smoke.floor_device_ms(8, threads)}),
          flush=True)


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("norm_variants: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "--one":
        threads, vectors = (int(x) for x in sys.argv[2].split(":"))
        time_one(threads, vectors, sys.argv[3])
        return 0
    variants = [tuple(int(x) for x in a.split(":")) for a in sys.argv[1:]]
    lib = build(variants)
    for threads, vectors in variants:
        subprocess.run([sys.executable, __file__, "--one",
                        f"{threads}:{vectors}", str(lib)], check=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
