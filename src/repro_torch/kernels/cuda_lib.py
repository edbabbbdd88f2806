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
which kernels its path went through.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Dict, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("norm.cu", "flash_attention.cu", "flash_decode.cu",
           "sampling.cu", "softmax.cu")
HEADERS = ("common.cuh",)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC")

#: kernel launches per wrapper, since the last reset
LAUNCHES: "collections.Counter[str]" = collections.Counter()

# dtype codes shared with csrc/common.cuh
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_SIGNATURES = {
    "repro_norm": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _F, _I, _I, _P],
    "repro_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P, _I, _F, _I, _P],
    "repro_paged_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                           _I, _I, _I, _I, _F, _I, _P],
    "repro_contiguous_decode": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                _I, _I, _L, _L, _L, _I, _F, _I, _P],
    "repro_sample": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _I, _P],
    "repro_softmax": [_P, _P, _P, _I, _I, _F, _I, _I, _P],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
#: how the library was obtained: {"seconds", "path", "built"}
BUILD_INFO: Dict[str, object] = {}


def reset_launches() -> None:
    LAUNCHES.clear()


def count_launch(name: str) -> None:
    LAUNCHES[name] += 1


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
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        BUILD_INFO.update(seconds=time.perf_counter() - t0, path=str(path),
                          built=built)
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
