#!/usr/bin/env python3
"""Where the flash kernel's blocks spend their time, on one NVIDIA H100:

    python3 tools/flash_trace.py [VARIANT ...]

Builds an instrumented copy of ``src/repro_torch/csrc/flash_attention.cu``
under ``build/flash_trace/`` (the stamps are written into the copy here,
not into the shipped kernel; an anchor line that moved fails loudly):
thread 0 of every block reads the global timer at its start, at the
packed mode's plan phases (the query rows' summary, the tiles' votes,
the plan done), when its first key tile has landed and at its end, and
keeps the number of tiles it visited and its SM.  Then, after warm-up
launches, it runs the causal kernel at B 8 x 1024 and the packed mode on
the packs of ``chip_smoke.PACKED_CASES`` (H 16, KV 8, dh 128, bf16) once
each and prints one JSON line per run: the launch's span (first block
start to last block end), each block's mean and largest span, the mean
of each phase, the time per visited tile after the first one lands, and
the visited tiles.  ``VARIANT`` (``VARIANTS``; "base" by default) adds
diagnostic edits to the copy, each variant built and run in a process of
its own.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MAX_BLOCKS = 4096

PRELUDE = r"""
__device__ long long flash_trace[MAX_BLOCKS][8];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
// thread 0 of the block keeps the global timer in slot k (slot 6: tiles
// and SM)
__device__ __forceinline__ void stamp(int k, long long value = -1) {
  if (threadIdx.x != 0) return;
  const int id = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                 blockIdx.x;
  if (id < MAX_BLOCKS) flash_trace[id][k] = value < 0 ? global_ns() : value;
}
""".replace("MAX_BLOCKS", str(MAX_BLOCKS))

#: the packed kernel's plan
_PLAN = "  const int n_tiles = plan_tiles(*plan, pk, q0, sq, sk, offset);\n"

#: the stamps: block start; the plan's query summary (warp 0); its votes;
#: the plan done; the first key tile landed; block end (slot 6: the tiles
#: visited, and the SM)
STAMPS = ("start", "query summary", "votes", "plan", "first tile", "end")

#: (lines of csrc/flash_attention.cu, what the copy puts in their place,
#: and how many times they occur there: once where not given)
EDITS = (
    ("namespace repro {\n", "namespace repro {\n" + PRELUDE),
    ("  const int h = blockIdx.x;\n  const int b = blockIdx.y;\n",
     "  stamp(0);\n  const int h = blockIdx.x;\n  const int b = blockIdx.y;\n"),
    ("  const int h = blockIdx.x;\n  const int qt = gridDim.z - 1 - blockIdx.z;\n",
     "  stamp(0);\n  const int h = blockIdx.x;\n"
     "  const int qt = gridDim.z - 1 - blockIdx.z;\n"),
    ("  if (real == 0) return 0;\n",
     "  if (tid == 0) stamp(1);\n  if (real == 0) return 0;\n"),
    ("  __syncthreads();\n  if (tid < 32) {\n    int n = 0;\n",
     "  __syncthreads();\n  stamp(2);\n  if (tid < 32) {\n    int n = 0;\n"),
    (_PLAN, _PLAN + "  stamp(3);\n"),
    ("  if (n_tiles > 0) load_tile(ks, kb, k_ss, 0, kv_len);\n"
     "  cp_async_commit();\n  cp_async_wait_all();\n  __syncthreads();\n",
     "  if (n_tiles > 0) load_tile(ks, kb, k_ss, 0, kv_len);\n"
     "  cp_async_commit();\n  cp_async_wait_all();\n  __syncthreads();\n"
     "  stamp(4);\n"),
    ("  load_keys(0);\n  cp_async_commit();\n"
     "  cp_async_wait_all();\n  __syncthreads();\n",
     "  load_keys(0);\n  cp_async_commit();\n"
     "  cp_async_wait_all();\n  __syncthreads();\n  stamp(4);\n"),
    ("          *reinterpret_cast<const uint4*>(qs_ptr + sw128(r, c));\n"
     "  }\n}\n",
     "          *reinterpret_cast<const uint4*>(qs_ptr + sw128(r, c));\n"
     "  }\n  stamp(5);\n  unsigned sm;\n"
     "  asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(sm));\n"
     "  stamp(6, n_tiles | (static_cast<long long>(sm) << 32));\n}\n", 2),
)

#: diagnostic variants of the packed mode, each an extra set of edits to
#: the copy.  Each is right only for case (a), eight segments of 1024 with
#: no prefix (the other packs are timed but their outputs are not
#: checked): "no_plan" drops the plan and visits case (a)'s tiles by
#: arithmetic with the causal mask, as the causal kernel would on each
#: segment; "plan_causal_loop" does the same after running the plan;
#: "causal_mask" keeps the plan's list of tiles but masks as the causal
#: kernel does.
_ARITH = (
    ("return (plan->list[j] & ~kMaskedTile) * kBK;",
     "return ((q0 / 1024) * 16 + j) * kBK;"),
    ("rows.softmax<true>(s, p0,", "rows.softmax<false>(s, p0,"),
    ("rows.softmax<true>(s, p_out,", "rows.softmax<false>(s, p_out,"),
)
VARIANTS = {
    "base": (),
    "no_plan": ((_PLAN, "  const int n_tiles = (q0 % 1024) / kBK + 1;\n"),)
    + _ARITH,
    "plan_causal_loop": (
        (_PLAN, "  const int planned = plan_tiles(*plan, pk, q0, sq, sk, "
                "offset);\n  const int n_tiles = planned ? (q0 % 1024) / kBK "
                "+ 1 : 0;\n"),) + _ARITH,
    "causal_mask": _ARITH[1:],
}

READER = r"""
extern "C" int repro_flash_read_trace(void* dst) {
  return static_cast<int>(cudaMemcpyFromSymbol(dst, repro::flash_trace,
                                               sizeof(repro::flash_trace)));
}
extern "C" int repro_flash_clear_trace() {
  static long long zeros[MAX_BLOCKS][8];
  return static_cast<int>(cudaMemcpyToSymbol(repro::flash_trace, zeros,
                                             sizeof(zeros)));
}
""".replace("MAX_BLOCKS", str(MAX_BLOCKS))


def build(variant: str) -> Path:
    from repro_torch.kernels import cuda_lib
    text = (cuda_lib.CSRC / "flash_attention.cu").read_text()
    for old, new, *times in EDITS + VARIANTS[variant]:
        if text.count(old) != (times[0] if times else 1):
            raise RuntimeError(f"flash_trace: anchor not found "
                               f"{times[0] if times else 1} times: {old!r}")
        text = text.replace(old, new)
    out = ROOT / "build" / "flash_trace" / variant
    out.mkdir(parents=True, exist_ok=True)
    (out / "flash_attention.cu").write_text(text + READER)
    (out / "common.cuh").write_text((cuda_lib.CSRC / "common.cuh").read_text())
    lib = out / "libflash_trace.so"
    run = subprocess.run(
        [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
         str(out / "flash_attention.cu"), "-o", str(lib)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if run.returncode != 0:
        raise RuntimeError(f"nvcc failed:\n{run.stdout}")
    return lib


def summary(lib, blocks: int, label: str) -> dict:
    rows = (ctypes.c_longlong * (MAX_BLOCKS * 8))()
    if lib.repro_flash_read_trace(ctypes.addressof(rows)) != 0:
        raise RuntimeError("could not read the trace")
    recs = [list(rows[8 * i:8 * i + 8])
            for i in range(min(blocks, MAX_BLOCKS))]
    recs = [r for r in recs if r[5]]        # blocks of padding only: none
    for r in recs:                           # the causal kernel: no plan
        for k in (1, 2, 3):
            r[k] = r[k] or r[0]
    t0 = min(r[0] for r in recs)
    t1 = max(r[5] for r in recs)
    tiles = [r[6] & 0xFFFFFFFF for r in recs]

    def mean_us(values):
        values = list(values)
        return sum(values) / len(values) / 1e3
    phases = {f"{STAMPS[k - 1]} -> {STAMPS[k]}": mean_us(
        r[k] - r[k - 1] for r in recs) for k in range(1, 5)}
    return {"run": label, "blocks_traced": len(recs),
            "launch_span_us": (t1 - t0) / 1e3,
            "block_span_us_mean": mean_us(r[5] - r[0] for r in recs),
            "block_span_us_max": max(r[5] - r[0] for r in recs) / 1e3,
            "phase_us_mean": phases,
            "us_per_visited_tile_after_the_first_mean": mean_us(
                (r[5] - r[4]) / max(t, 1) for r, t in zip(recs, tiles)),
            "visited_tiles_total": sum(tiles),
            "visited_tiles_max": max(tiles),
            "sms": len({r[6] >> 32 for r in recs})}


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import cuda_lib, flash_attention
    if not torch.cuda.is_available():
        print("flash_trace: no CUDA device", file=sys.stderr)
        return 2
    variants = sys.argv[1:] or ["base"]
    if len(variants) > 1:           # each in a process of its own: the
        for v in variants:          # copies share their kernels' symbols
            subprocess.run([sys.executable, __file__, v], check=True)
        return 0
    variant = variants[0]
    lib = ctypes.CDLL(str(build(variant)))
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if "flash_attention" in name:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    lib.repro_flash_read_trace.argtypes = [ctypes.c_void_p]
    cuda_lib._lib = lib              # the wrappers now launch this copy
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)

    def traced(fn, blocks, label):
        for _ in range(5):
            fn()
        torch.cuda.synchronize()
        lib.repro_flash_clear_trace()
        fn()
        torch.cuda.synchronize()
        print(json.dumps({"variant": variant,
                          **summary(lib, blocks, label)}), flush=True)

    g = torch.Generator(device=dev).manual_seed(1)
    q, k, v = [torch.randn((8, 1024, n, 128), generator=g,
                           device=dev).bfloat16().transpose(1, 2)
               for n in (16, 8, 8)]
    traced(lambda: flash_attention.flash_attention_cuda(q, k, v, causal=True),
           16 * 8 * 16, "causal B 8 x 1024")
    for label, fresh, prefix, width, pre_width in chip_smoke.PACKED_CASES:
        q, k, v, ids = chip_smoke.packed_inputs(dev, gen, fresh, prefix,
                                                width, pre_width)
        traced(lambda: flash_attention.flash_attention_packed_cuda(
            q, k, v, *ids), 16 * (width // 64), f"packed {label}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
