#!/usr/bin/env python3
"""Build the fused sampling kernel at other radix digit widths and
cluster sizes and time each variant on one NVIDIA H100, in one call:

    python3 tools/sample_variants.py 11:8 8:8 11:16 11:8:trace

Each ``BITS:CLUSTER`` argument rebuilds ``src/repro_torch/csrc/
sampling.cu`` with ``kDigitBits = BITS`` and ``kCluster = CLUSTER`` into
its own library under ``build/sample_variants/`` (one ``nvcc`` per
library, all started together), points the port's wrapper at it with the
plan's digit width and cluster size set to the variant's, and runs
``chip_smoke.sample_case`` (every token against the plain version,
device time with a cold and a warm L2) on f32 and bf16 logits at B 8,
V 92544, C 64, each variant in a process of its own.  One JSON line per
variant and dtype.  A cluster above 8 blocks is the non-portable size:
the copy's launcher is given the attribute that allows it.

``BITS:CLUSTER:trace[:ROW]`` instruments the copy instead (phase stamps
and block spans written into the source here, not in the shipped kernel)
and prints, for every row sampled at temperature 1, the cycles between
the phase stamps of the leader block of the check's row ROW (0 by
default; the rows are rolled so that it runs first, the row the stamps
follow) and, from every block's first and last global-timer reading, the
nanoseconds from the first block's start to the last one's end, each
block's own span and each row's, after 20 warm-up launches.
"""
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("max_abs_err", "device_ms", "device_ms_warm_l2", "bound_ms",
        "share_of_bound")


#: the phase stamps' names (``TRACE_EDITS``' STAMP), in order
def stamp_names(passes: int):
    names = ["start", "slice read"]
    for p in range(passes):
        names += [f"pass {p} counted", f"pass {p} cluster barrier",
                  f"pass {p} DSMEM sums", f"pass {p} digit"]
    return names + ["gather counted", "gather cluster barrier",
                    "gather written", "gather cluster barrier 2",
                    "leader sorted", "leader tail"]


#: what the trace adds to the kernel's source: stamps (SM clock) of row
#: 0's leader block, thread 0, at the phases of ``stamp_names``, and every
#: block's first and last global-timer reading
TRACE_PRELUDE = r"""
__device__ long long sample_stamps[32];
__device__ long long sample_spans[2][256];
__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define STAMP(i)                                                \
  do {                                                          \
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) \
      sample_stamps[i] = clock64();                             \
  } while (0)
#define SPAN(which)                                                      \
  do {                                                                   \
    if (threadIdx.x == 0)                                                \
      sample_spans[which][blockIdx.y * gridDim.x + blockIdx.x] =         \
          global_ns();                                                   \
  } while (0)
"""
TRACE_READER = r"""
// Copy the phase stamps (32 int64) and the blocks' spans (2 x 256 int64)
// of the last launch to host memory.
extern "C" int repro_sample_read_stamps(void* stamps, void* spans) {
  cudaError_t err = cudaMemcpyFromSymbol(stamps, repro::sample_stamps,
                                         sizeof(repro::sample_stamps));
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(spans, repro::sample_spans,
                               sizeof(repro::sample_spans));
  return static_cast<int>(err);
}
"""
#: (a line of csrc/sampling.cu, what the trace puts in its place)
TRACE_EDITS = (
    ("constexpr int kSampleSmemLimit = 232448 - 1024;\n",
     "constexpr int kSampleSmemLimit = 232448 - 1024;\n" + TRACE_PRELUDE),
    ("  cluster.sync();  // every block's histogram of this pass is "
     "complete\n",
     "  STAMP(2 + 4 * P);\n  cluster.sync();\n  STAMP(3 + 4 * P);\n"),
    ("  uint32_t total;\n  uint32_t above = block_exclusive_scan(",
     "  STAMP(4 + 4 * P);\n  uint32_t total;\n"
     "  uint32_t above = block_exclusive_scan("),
    ("  __syncthreads();\n  prefix |= sh.digit << kShift;\n",
     "  __syncthreads();\n  STAMP(5 + 4 * P);\n"
     "  prefix |= sh.digit << kShift;\n"),
    ("  __shared__ SelectShared sh;\n",
     "  __shared__ SelectShared sh;\n  SPAN(0);\n  STAMP(0);\n"
     "  constexpr int kGather = 2 + 4 * kPasses;\n"),
    ("  // radix select of the C-th largest key across the cluster\n",
     "  STAMP(1);\n"),
    ("    cluster.sync();  // the leader has read every peer\n"
     "    return;\n",
     "    cluster.sync();\n    SPAN(1);\n    return;\n"),
    ("  cluster.sync();  // every block's counts are visible\n",
     "  STAMP(kGather);\n  cluster.sync();\n  STAMP(kGather + 1);\n"),
    ("  cluster.sync();  // the leader's candidates are complete\n"
     "  if (rank != 0) return;\n",
     "  STAMP(kGather + 2);\n  cluster.sync();\n  STAMP(kGather + 3);\n"
     "  if (rank != 0) {\n    SPAN(1);\n    return;\n  }\n"),
    ("  __syncthreads();\n  if (tid >= 32) return;\n",
     "  __syncthreads();\n  STAMP(kGather + 4);\n"
     "  if (tid >= 32) {\n    SPAN(1);\n    return;\n  }\n"),
    ("  if (lane == 0) out[row] = sort_i[choice];\n}\n",
     "  if (lane == 0) out[row] = sort_i[choice];\n  STAMP(kGather + 5);\n"
     "  SPAN(1);\n}\n"),
)
#: the launcher's line after which a cluster above 8 is allowed
SMEM_SET = ("  cudaError_t err = set_smem_once(kernel, kSampleSmemLimit, "
            "smem_set);\n")
NON_PORTABLE = ("  if (err == cudaSuccess)\n    err = cudaFuncSetAttribute(\n"
                "        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed"
                ", 1);\n")


def edit(text: str, old: str, new: str) -> str:
    """``text`` with its one ``old`` replaced by ``new``; raises where the
    kernel's source no longer holds ``old`` exactly once."""
    if text.count(old) != 1:
        raise RuntimeError(f"sampling.cu: {old!r} found {text.count(old)} "
                           "times, not once")
    return text.replace(old, new)


def variant_source(src: str, bits: int, cluster: int, trace: bool) -> str:
    """csrc/sampling.cu with the variant's constants, the non-portable
    cluster attribute above 8 blocks, and the trace's stamps."""
    text = edit(src, "constexpr int kDigitBits = 8;",
                f"constexpr int kDigitBits = {bits};")
    text = edit(text, "constexpr int kCluster = 8;",
                f"constexpr int kCluster = {cluster};")
    if cluster > 8:
        text = edit(text, SMEM_SET, SMEM_SET + NON_PORTABLE)
    if trace:
        for old, new in TRACE_EDITS:
            text = edit(text, old, new)
        text += TRACE_READER
    return text


def build(variants):
    """One library per (digit width, cluster, trace), built in parallel."""
    from repro_torch.kernels import cuda_lib
    src = (cuda_lib.CSRC / "sampling.cu").read_text()
    procs = {}
    for bits, cluster, trace in sorted(set(variants)):
        out = (ROOT / "build" / "sample_variants" /
               f"bits{bits}_cluster{cluster}{'_trace' if trace else ''}")
        out.mkdir(parents=True, exist_ok=True)
        (out / "sampling.cu").write_text(
            variant_source(src, bits, cluster, trace))
        (out / "common.cuh").write_text(
            (cuda_lib.CSRC / "common.cuh").read_text())
        lib = out / "libsample.so"
        procs[bits, cluster, trace] = (lib, subprocess.Popen(
            [cuda_lib._nvcc(), *cuda_lib.NVCC_FLAGS, "-shared",
             str(out / "sampling.cu"), "-o", str(lib)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for key, (lib, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {lib}:\n{log}")
        libs[key] = lib
    return libs


def trace(lib, dev, gen, dtype, bits: int, row: int) -> dict:
    """Cycles between the phase stamps of the last of 20 launches, every
    row sampled at temperature 1 and ``row`` moved first, and the blocks'
    spans."""
    import ctypes

    import torch

    import chip_smoke
    from repro_torch.kernels import sampling
    logits, temp, top_k, top_p, gumbel = chip_smoke.sample_inputs(
        dev, gen, dtype)
    temp = temp * 0 + 1
    order = [(row + i) % logits.shape[0] for i in range(logits.shape[0])]
    logits, top_k, top_p, gumbel = (logits[order].contiguous(), top_k[order],
                                    top_p[order], gumbel[order].contiguous())
    for _ in range(20):
        sampling.sample_cuda(logits, temp, top_k, top_p, gumbel)
    torch.cuda.synchronize()
    stamps = (ctypes.c_longlong * 32)()
    spans = (ctypes.c_longlong * 512)()
    lib.repro_sample_read_stamps.argtypes = [ctypes.c_void_p] * 2
    if lib.repro_sample_read_stamps(ctypes.addressof(stamps),
                                    ctypes.addressof(spans)) != 0:
        raise RuntimeError("could not read the phase stamps")
    names = stamp_names(-(-32 // bits))
    cycles = {names[i]: stamps[i] - stamps[i - 1]
              for i in range(1, len(names))}
    blocks = logits.shape[0] * sampling.CLUSTER
    start, end = spans[:blocks], spans[256:256 + blocks]
    own = sorted(e - s for s, e in zip(start, end))
    return {"cycles_by_phase": cycles,
            "cycles_leader_row0": stamps[len(names) - 1] - stamps[0],
            "ns_first_start_to_last_end": max(end) - min(start),
            "ns_block_span_min_median_max": [own[0], own[len(own) // 2],
                                             own[-1]],
            "ns_last_block_start_after_first": max(start) - min(start),
            "ns_row_spans": [
                max(end[r * sampling.CLUSTER:(r + 1) * sampling.CLUSTER]) -
                min(start[r * sampling.CLUSTER:(r + 1) * sampling.CLUSTER])
                for r in range(logits.shape[0])]}


def time_one(bits: int, cluster: int, traced, path: str) -> None:
    """Time one variant: its own process, since the kernels of two
    variants share their symbols and their set-once attributes."""
    import ctypes

    import torch

    import chip_smoke
    from repro_torch.kernels import cuda_lib, sampling
    lib = ctypes.CDLL(path)
    for name, argtypes in cuda_lib._SIGNATURES.items():
        if "sample" in name:
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
    cuda_lib._lib = lib              # the wrapper now launches this variant
    sampling.DIGIT_BITS = bits
    sampling.CLUSTER = cluster
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(chip_smoke.SEED)
    for dtype in (torch.float32, torch.bfloat16):
        if traced is not None:
            print(json.dumps({"digit_bits": bits, "cluster": cluster,
                              "dtype": str(dtype), "traced_row": traced,
                              **trace(lib, dev, gen, dtype, bits, traced)}),
                  flush=True)
            continue
        line = chip_smoke.sample_case(dev, gen, dtype)
        print(json.dumps({"digit_bits": bits, "cluster": cluster,
                          "dtype": str(dtype),
                          **{k: line.get(k) for k in KEYS}}), flush=True)


def main() -> int:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    if not torch.cuda.is_available():
        print("sample_variants: no CUDA device", file=sys.stderr)
        return 2
    if sys.argv[1] == "--one":
        bits, cluster, traced = parse(sys.argv[2])
        time_one(bits, cluster, traced, sys.argv[3])
        return 0
    variants = [parse(a) for a in sys.argv[1:]]
    libs = build([(b, c, t is not None) for b, c, t in variants])
    for arg, (bits, cluster, traced) in zip(sys.argv[1:], variants):
        subprocess.run([sys.executable, __file__, "--one", arg,
                        str(libs[bits, cluster, traced is not None])],
                       check=True)
    return 0


def parse(arg: str):
    """"BITS:CLUSTER", "BITS:CLUSTER:trace" or "BITS:CLUSTER:trace:ROW" ->
    (bits, cluster, the traced row or None)."""
    parts = arg.split(":")
    traced = None
    if parts[2:3] == ["trace"]:
        traced = int(parts[3]) if len(parts) > 3 else 0
    return int(parts[0]), int(parts[1]), traced


if __name__ == "__main__":
    sys.exit(main())
