"""Build, load and count the port's CUDA kernels.

The sources under ``src/repro_torch/csrc/`` have plain C entry points.
At first use, :func:`library` compiles each ``.cu`` file with its own
``nvcc`` process (all started together), links the objects into one
shared library for ``sm_90a`` under ``build/repro_torch/`` at the root of
the checkout, and loads it with ``ctypes``.  The library's file name
carries a hash of the sources and flags, so an edited kernel rebuilds and
an unchanged one loads at once.  Nothing here runs at import time.

``LAUNCHES`` counts kernel launches per wrapper name: each wrapper adds
one where it launches its kernel, and nowhere else, so a run can show
which kernels its path went through.  ``LAUNCH_SHAPES`` counts the same
launches again by a shape class where a wrapper names one (the flash
kernel's suffix-aligned calls, Sk > Sq).  A launch recorded into a CUDA
graph runs nothing when it is recorded: it is counted into the open
:func:`recording` instead, and :func:`add_launches` adds that record once
per replay of the graph.

``nvcc`` runs with ``-Xptxas -v``; its report (registers, spills per
kernel) is kept beside the library and parsed by :func:`ptxas_usage`,
and :func:`sass_opcodes` counts instructions in ``cuobjdump -sass``
output, so a run can show what each kernel compiled to.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("norm.cu", "flash_attention.cu", "flash_decode.cu",
           "flash_decode_bf16kv.cu", "sampling.cu", "softmax.cu")
HEADERS = ("common.cuh", "flash_decode.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: kernel launches per wrapper, since the last reset
LAUNCHES: "collections.Counter[str]" = collections.Counter()
#: the same launches by (wrapper, shape class), where a wrapper gives one
LAUNCH_SHAPES: "collections.Counter[tuple]" = collections.Counter()

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "repro_norm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _I, _I,
                   _P],
    "repro_norm_blocks_per_sm": [_I, _I, _I],
    "repro_floor": [_I, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P, _I, _F, _I, _P],
    "repro_flash_attention_blocks_per_sm": [_I, _I],
    "repro_flash_attention_packed": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P,
                                     _I, _I, _I, _I, _I, _P, _F, _I, _P],
    "repro_flash_attention_packed_plan": [_P, _P, _P, _P, _P, _I, _I, _I,
                                          _P],
    "repro_flash_attention_packed_blocks_per_sm": [],
    "repro_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _F, _I, _I, _P],
    "repro_contiguous_decode": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                _I, _L, _L, _L, _I, _F, _I, _I, _P],
    "repro_flash_decode_blocks_per_sm": [_I, _I, _I, _I, _I],
    "repro_flash_decode_ring_bytes": [_I, _I],
    "repro_sample": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_sample_occupancy": [_I, _I, _P, _P],
    "repro_softmax": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: how the library was obtained: {"seconds", "path", "built", "ptxas"}
BUILD_INFO: Dict[str, object] = {}


#: the launches of the capture in progress, by (wrapper, shape class)
_recording: "Optional[collections.Counter[tuple]]" = None


def reset_launches() -> None:
    LAUNCHES.clear()
    LAUNCH_SHAPES.clear()


def count_launch(name: str, shape: Optional[str] = None) -> None:
    if torch.cuda.is_current_stream_capturing():
        if _recording is None:
            raise RuntimeError(f"{name}: launch captured into a CUDA graph "
                               "outside cuda_lib.recording()")
        _recording[(name, shape)] += 1
        return
    add_launches({(name, shape): 1})


def add_launches(counts: Dict[tuple, int]) -> None:
    """Count launches given by (wrapper, shape class or None): a graph
    replay adds what its capture recorded."""
    with _count_lock:      # replicas' pump threads count at once
        for (name, shape), n in counts.items():
            LAUNCHES[name] += n
            if shape is not None:
                LAUNCH_SHAPES[(name, shape)] += n


@contextlib.contextmanager
def recording():
    """Collect the launches recorded while a CUDA graph is captured, by
    (wrapper, shape class): what one replay of the graph launches."""
    global _recording
    if _recording is not None:
        raise RuntimeError("a launch recording is already open")
    _recording = collections.Counter()
    try:
        yield _recording
    finally:
        _recording = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _compile(out: Path) -> None:
    """Compile every source in parallel and link them into ``out``."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in SOURCES:
            obj = Path(tmp) / (Path(src).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs, failed = [], []
        for src, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src}\n{text}")
            if proc.returncode != 0:
                failed.append(src)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" +
                               "\n".join(logs))
        out.with_suffix(".ptxas.txt").write_text("\n".join(logs))
        lib_tmp = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib_tmp),
             *[str(obj) for _, obj, _ in procs]],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(lib_tmp, out)      # atomic: readers see all or nothing


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = BUILD_DIR / f"librepro_torch_kernels-{_digest()}.so"
        t0 = time.perf_counter()
        built = not path.exists()
        if built:
            _compile(path)
        lib = ctypes.CDLL(str(path))
        report = path.with_suffix(".ptxas.txt")
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(path),
                          built=built,
                          ptxas=ptxas_usage(report.read_text())
                          if report.exists() else {})
        _lib = lib
        return lib


def check(rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc} at launch")


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda(name: str, *tensors: Optional[torch.Tensor],
                 aligned: bool = True) -> None:
    """Device (and, for vectorised kernels, 16-byte alignment) checks
    shared by the wrappers."""
    dev = None
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: expected CUDA tensors, got one on "
                             f"{t.device}")
        if dev is not None and t.device != dev:
            raise ValueError(f"{name}: tensors on {dev} and {t.device}")
        dev = t.device
        if aligned and t.data_ptr() % 16:
            raise ValueError(f"{name}: tensor data must be 16-byte aligned")


def ptxas_usage(log: str) -> Dict[str, Dict[str, int]]:
    """Per kernel (mangled name), what ``ptxas -v`` reported: registers,
    spill stores and loads (bytes) and static shared memory (bytes)."""
    usage: Dict[str, Dict[str, int]] = {}
    fn = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            usage.setdefault(fn, {})
            continue
        m = re.search(r"Function properties for (\S+)", line)
        if m:                      # a non-entry function's block: skip it
            fn = m.group(1) if m.group(1) in usage else None
            continue
        if fn is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            usage[fn].update(spill_stores=int(m[1]), spill_loads=int(m[2]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            usage[fn]["registers"] = int(m[1])
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            usage[fn]["static_smem_bytes"] = int(m[1])
    return usage


# "/*0ab0*/  @!P0 HMMA.16816.F32.BF16 R24, ..." -> "HMMA.16816.F32.BF16"
_SASS_OP = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                      r"([A-Z][A-Z0-9_.]*)")


def sass_opcodes(sass: str, function: str,
                 opcodes: Iterable[str]) -> Dict[str, int]:
    """How many instructions of each opcode (its first dotted part, e.g.
    ``HMMA`` for ``HMMA.16816.F32.BF16``) the functions whose mangled name
    contains ``function`` hold, in ``cuobjdump -sass`` output."""
    counts = {op: 0 for op in opcodes}
    inside = False
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            inside = function in m.group(1)
            continue
        if not inside:
            continue
        m = _SASS_OP.search(line)
        if m and m.group(1).split(".")[0] in counts:
            counts[m.group(1).split(".")[0]] += 1
    return counts
