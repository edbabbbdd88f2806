#!/usr/bin/env python3
"""Which kernel event a torch.profiler window drops, on one CUDA card:

    python3 tools/trace_loss.py [LAUNCHES] [--decode WINDOWS]

Runs windows of LAUNCHES (default 50) calls of the port's fused RMSNorm
(bf16, 8 x 2048, each one kernel launch): alone, after one leading
PyTorch kernel, and before one trailing PyTorch kernel, each window three
times.  Prints, per window, the norm launches counted by the wrapper and
the norm kernel events the trace holds.  A window that loses an event
alone and none after a leading kernel loses the first kernel it runs.

``--decode WINDOWS`` then replays the window of
tests/test_torch_cuda.py's ``test_cuda_decode_is_one_launch_per_call``
(five paged-decode calls on rows of 1, 300 and 1024 keys, H 16, KV 8,
bf16 queries over an f32 pool, traced with the CUDA activity only) WINDOWS times alone and
WINDOWS times after one leading PyTorch kernel, and prints for each how
many windows came back empty, how many held fewer decode kernels than
calls, and how many lost the leading kernel.
"""
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402


def window(n: int, lead: bool, trail: bool, x, gamma) -> dict:
    from repro_torch.kernels import cuda_lib, ops
    torch.cuda.synchronize()
    cuda_lib.reset_launches()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        if lead:
            x.add_(0)
        for _ in range(n):
            ops.fused_rmsnorm(x, gamma)
        if trail:
            x.add_(0)
        torch.cuda.synchronize()
    seen = sum(1 for evt in prof.events()
               if evt.device_type == torch.autograd.DeviceType.CUDA and
               "norm_kernel" in evt.name)
    return {"lead": lead, "trail": trail,
            "counted": cuda_lib.LAUNCHES["norm"], "trace": seen}


def decode_window(calls: int, lead: bool, d) -> dict:
    """One window as the decode launch test traces it: the decode
    kernels and the other kernels the trace holds."""
    from repro_torch.kernels import ops
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        if lead:
            d["q"].add_(0)
        for _ in range(calls):
            ops.flash_decode_paged(d["q"], d["k"], d["v"], d["tables"],
                                   d["lens"])
        torch.cuda.synchronize()
    names = [evt.name for evt in prof.events()
             if evt.device_type == torch.autograd.DeviceType.CUDA]
    return {"decode": sum("decode_kernel" in n for n in names),
            "other": sum("repro" not in n for n in names)}


def decode_probe(windows: int) -> None:
    gen = torch.Generator(device="cuda").manual_seed(0)
    lens = (1, 300, 1024)
    bs, mb, kv = 16, 64, 8
    perm = torch.randperm(len(lens) * mb, generator=gen,
                          device="cuda").int() + 1
    d = {"q": torch.randn((len(lens), 16, 128), generator=gen,
                          device="cuda").bfloat16(),
         "k": torch.randn((len(lens) * mb + 1, bs, kv, 128), generator=gen,
                          device="cuda"),
         "tables": perm.reshape(len(lens), mb).contiguous(),
         "lens": torch.tensor(lens, dtype=torch.int32, device="cuda")}
    d["v"] = torch.randn_like(d["k"])
    calls = 5
    decode_window(calls, False, d)                 # build, load, warm
    for lead in (False, True):
        got = [decode_window(calls, lead, d) for _ in range(windows)]
        print(json.dumps({
            "probe": f"paged decode x{calls}", "lead": lead,
            "windows": windows,
            "empty": sum(g["decode"] == 0 and g["other"] == 0 for g in got),
            "short": sum(0 < g["decode"] < calls for g in got),
            "lost_lead": sum(lead and g["decode"] and g["other"] == 0
                             for g in got)}), flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device", file=sys.stderr)
        return 2
    args = sys.argv[1:]
    windows = 0
    if "--decode" in args:
        at = args.index("--decode")
        windows = int(args[at + 1])
        del args[at:at + 2]
    n = int(args[0]) if args else 50
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 2048), generator=gen, device="cuda").bfloat16()
    gamma = torch.randn((2048,), generator=gen, device="cuda").bfloat16()
    from repro_torch.kernels import ops
    ops.fused_rmsnorm(x, gamma)                  # build and load
    for _ in range(3):
        for lead, trail in ((False, False), (True, False), (False, True)):
            print(json.dumps(window(n, lead, trail, x, gamma)), flush=True)
    if windows:
        decode_probe(windows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
