#!/usr/bin/env python3
"""Build the split-K decode kernel at other tile sizes and ring depths and
time each variant on one NVIDIA H100, in one call:

    python3 tools/decode_variants.py 32:2 16:4 16:2

Each ``KEYS:STAGES`` argument rebuilds ``src/repro_torch/csrc/
flash_decode.cu`` with ``kTileKeys = KEYS`` and ``kStages = STAGES`` into
its own library under ``build/decode_variants/`` (one ``nvcc`` per
variant, all started together), points the port's wrappers at it, and
runs ``chip_smoke.paged_decode_case`` and ``contiguous_decode_case``
(check against the plain version, device time with a cold and a warm
L2) at lengths 1..1024 and at full load, each variant in a process of
its own.  One JSON line per variant,
kernel and case, then one line with the device time and rate of
``torch.sum`` over the 256 MB L2-flush buffer: what a plain streaming
read reaches on this card.
"""
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("max_abs_err", "device_ms", "device_ms_warm_l2", "bound_ms",
        "share_of_bound")


def build(variants):
    """One library per (keys, stages), built in parallel."""
    from repro_torch.kernels import cuda_lib
    src = (cuda_lib.CSRC / "flash_decode.cu").read_text()
    procs = []
    for keys, stages in variants:
        out = ROOT / "build" / "decode_variants" / f"k{keys}_s{stages}"
        out.mkdir(parents=True, exist_ok=True)
        text = re.sub(r"constexpr int kTileKeys = \d+;",
                      f"constexpr int kTileKeys = {keys};", src)
        text = re.sub(r"constexpr int kStages = \d+;",
                      f"constexpr int kStages = {stages};", text)
        (out / "flash_decode.cu").write_text(text)
        (out / "common.cuh").write_text(
            (cuda_lib.CSRC / "common.cuh").read_text())
        lib = out / "libdecode.so"
        procs.append((lib, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
             str(out / "flash_decode.cu"), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = []
    for lib, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
        libs.append(lib)
    return libs


def load(path):
    import ctypes

    from repro_torch.kernels import cuda_lib
    lib = ctypes.CDLL(str(path))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if "decode" in name:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    return lib


def time_one(keys: int, stages: int, path: str) -> None:
    """Time one variant: its own process, since the kernels of two
    variants share their symbols and their set-once attributes."""
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda_lib
    lib = load(path)
    cuda_lib._lib = lib              # the wrappers now launch this variant
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    blocks = lib.repro_flash_decode_blocks_per_sm(1, 2, 1)
    for case in (chip_smoke.paged_decode_case,
                 chip_smoke.contiguous_decode_case):
        for name, which in chip_smoke.DECODE_CASES:
            line = case(dev, gen, name, which)
            print(json.dumps({"tile_keys": keys, "stages": stages,
                              "blocks_per_sm": blocks,
                              "kernel": line["kernel"], "case": name,
                              **{k: line.get(k) for k in KEYS}}),
                  flush=True)


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    if not torch.cuda.is_available():
        print("decode_variants: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "--one":
        keys, stages = (int(x) for x in sys.argv[2].split(":"))
        time_one(keys, stages, sys.argv[3])
        return 0
    variants = [tuple(int(x) for x in a.split(":")) for a in sys.argv[1:]]
    for (keys, stages), path in zip(variants, build(variants)):
        subprocess.run([sys.executable, __file__, "--one",
                        f"{keys}:{stages}", str(path)], check=True)
    flush = chip_smoke.l2_flush()
    read = chip_smoke.device_ms(flush, 50)["all"]
    nbytes = 256 << 20
    print(json.dumps({"torch_sum_256MB_device_ms": read,
                      "gbytes_per_s": nbytes / (read * 1e-3) / 1e9
                      if isinstance(read, float) else "not measured"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
