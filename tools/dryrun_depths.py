"""Trace one rank's step of a (16, 16) pod cell at several depths and
print each trace's op count, HBM bytes, FLOPs, collectives and
temporaries: whether the step is linear in depth, as
`repro_torch.launch.dryrun.run_scaled` assumes.  Each depth is traced in
a process of its own (``--fresh``), or all in one process one after the
other (the default); a train step over the cell's microbatches, or
``--micro`` of them.

  PYTHONPATH=src python tools/dryrun_depths.py --arch internlm2-1.8b \\
      --shape train_4k --depths 2,3,24 [--micro 3] [--fresh]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys


def trace_depths(arch: str, shape: str, depths, micro=None) -> None:
    from repro_torch.launch import dryrun
    from repro_torch.launch import graph_analysis as ga
    rules = dryrun.rules_for(arch, dryrun.production_mesh("single"))
    full = dryrun.build_cell(arch, shape, rules=rules)
    if micro is not None:
        shape = dataclasses.replace(full.shape, global_batch=micro * (
            full.shape.global_batch // full.grad_accum))
    for layers in depths:
        cell = dryrun.build_cell(arch, shape, rules=rules, cfg=dataclasses.
                                 replace(full.cfg, num_layers=layers),
                                 grad_accum=micro)
        gm, shape_env, _ = dryrun.trace(cell, rules=rules)
        table = ga.op_table(gm, shape_env)
        prof = ga.analyze(table)
        print(json.dumps({"arch": arch, "shape": full.shape.name,
                          "layers": layers,
                          "ops": len(table), "hbm_bytes": prof.hbm_bytes,
                          "flops": prof.flops,
                          "collective_counts": prof.collective_counts,
                          "collective_bytes": prof.collective_bytes,
                          "microbatches": cell.grad_accum,
                          "temp_bytes": dryrun.memory(
                              gm, shape_env)["temp_bytes"]}),
              flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python tools/dryrun_depths.py")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--depths", default="2,3,24")
    ap.add_argument("--micro", type=int, default=None,
                    help="a train step's microbatches (default the cell's)")
    ap.add_argument("--fresh", action="store_true",
                    help="each depth in a process of its own")
    args = ap.parse_args(argv)
    depths = [int(d) for d in args.depths.split(",")]
    if not args.fresh:
        trace_depths(args.arch, args.shape, depths, args.micro)
        return 0
    for layers in depths:
        more = [] if args.micro is None else ["--micro", str(args.micro)]
        rc = subprocess.run([sys.executable, __file__, "--arch", args.arch,
                             "--shape", args.shape, "--depths", str(layers)]
                            + more, env=dict(os.environ)).returncode
        if rc:
            return rc
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
