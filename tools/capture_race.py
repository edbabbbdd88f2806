#!/usr/bin/env python3
"""Which device calls from a second thread break a CUDA graph capture, on
one NVIDIA H100, with and without the port's device gate:

    python3 tools/capture_race.py

One thread captures a graph (``torch.cuda.graph``, the global capture
mode the port's cells use) whose body waits, mid-capture, until a second
thread has made one call: a fresh ``cudaMalloc`` (a new 1 GiB tensor), a
kernel launch from cached memory on the default stream, a device
synchronize, a tensor read to the host, ``torch.cuda.empty_cache``, or
the destruction of an earlier graph.  Each case runs in a process of its
own (a failed capture can leave the context unusable), first with the
threads free, then with the call held shared and the capture alone
through ``repro_torch.runtime.graphs.DEVICE_GATE``, which makes the
second thread wait until the capture ends.  One JSON line a case: did
the capture succeed, did the call raise, and the errors.
"""
import json
import subprocess
import sys
import threading
from pathlib import Path

CASES = ("malloc", "cached_launch", "synchronize", "read_to_host",
         "empty_cache", "destroy_graph")


def run_case(case: str, gated: bool) -> dict:
    import contextlib

    import torch

    from repro_torch.runtime.graphs import DEVICE_GATE
    dev = torch.device("cuda", 0)
    x = torch.randn(1024, 1024, device=dev)
    old = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(old, stream=side):
        y_old = x * 3
    torch.cuda.current_stream().wait_stream(side)
    keep = {"graph": old, "y": y_old}
    del old, y_old                    # ``keep`` holds the only references
    small = torch.ones(256, device=dev)
    spare = torch.empty(1 << 28, dtype=torch.uint8, device=dev)
    del spare                         # a cached block for empty_cache
    torch.cuda.synchronize()
    capturing, called = threading.Event(), threading.Event()
    out = {"case": case, "gated": gated, "call_error": None,
           "capture_error": None}

    def other():
        capturing.wait(10)
        hold = DEVICE_GATE.shared() if gated else contextlib.nullcontext()
        try:
            with hold:
                if case == "malloc":
                    torch.empty(1 << 30, dtype=torch.uint8, device=dev)
                elif case == "cached_launch":
                    (small * 2).sum()
                elif case == "synchronize":
                    torch.cuda.synchronize()
                elif case == "read_to_host":
                    small.sum().item()
                elif case == "empty_cache":
                    torch.cuda.empty_cache()
                else:
                    keep.clear()
        except Exception as e:          # the error is the observation
            out["call_error"] = f"{type(e).__name__}: {e}"[:300]
        finally:
            called.set()

    t = threading.Thread(target=other)
    t.start()
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):   # cuBLAS's handle and workspace for
        (x @ x) @ x                   # the capture stream, as the cells do
    stream.synchronize()
    hold = DEVICE_GATE.exclusive() if gated else contextlib.nullcontext()
    try:
        with hold:
            with torch.cuda.graph(graph, stream=stream):
                z = x @ x
                capturing.set()
                # the other thread's call lands here, mid-capture (with
                # the gate it waits until the capture has ended)
                called.wait(0.5 if gated else 10)
                z = z @ x
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
        out["replay_ok"] = bool(torch.isfinite(z).all())
    except Exception as e:              # the error is the observation
        out["capture_error"] = f"{type(e).__name__}: {e}"[:300]
    capturing.set()
    t.join(30)
    out["capture_ok"] = out["capture_error"] is None
    return out


def main() -> int:
    root = Path(__file__).resolve().parents[1]
    if len(sys.argv) == 3:
        sys.path.insert(0, str(root / "src"))
        print(json.dumps(run_case(sys.argv[1], sys.argv[2] == "gated")),
              flush=True)
        return 0
    import torch
    if not torch.cuda.is_available():
        print("capture_race: no CUDA device", file=sys.stderr)
        return 2
    for gated in ("free", "gated"):
        for case in CASES:
            try:
                proc = subprocess.run(
                    [sys.executable, __file__, case, gated],
                    capture_output=True, text=True, timeout=120)
                lines = proc.stdout.strip().splitlines()
                line = lines[-1] if lines else json.dumps(
                    {"case": case, "gated": gated == "gated",
                     "rc": proc.returncode,
                     "stderr": proc.stderr.strip()[-300:]})
            except subprocess.TimeoutExpired:
                line = json.dumps({"case": case, "gated": gated == "gated",
                                   "timeout": True})
            print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
