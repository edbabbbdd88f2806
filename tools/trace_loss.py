#!/usr/bin/env python3
"""Which kernel event a torch.profiler window drops, on one CUDA card:

    python3 tools/trace_loss.py [LAUNCHES]

Runs windows of LAUNCHES (default 50) calls of the port's fused RMSNorm
(bf16, 8 x 2048, each one kernel launch): alone, after one leading
PyTorch kernel, and before one trailing PyTorch kernel, each window three
times.  Prints, per window, the norm launches counted by the wrapper and
the norm kernel events the trace holds.  A window that loses an event
alone and none after a leading kernel loses the first kernel it runs.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("trace_loss: no CUDA device", file=sys.stderr)
        return 2
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 50
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, 2048), generator=gen, device="cuda").bfloat16()
    gamma = torch.randn((2048,), generator=gen, device="cuda").bfloat16()
    from repro_torch.kernels import ops
    ops.fused_rmsnorm(x, gamma)                  # build and load
    for _ in range(3):
        for lead, trail in ((False, False), (True, False), (False, True)):
            print(json.dumps(window(n, lead, trail, x, gamma)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
