"""Offline re-analysis: recompute the roofline fields of dry-run records
from their saved op tables, without tracing again.  The counterpart of
`repro.launch.reanalyze` (which re-reads saved HLO); used after a change
to `repro_torch.launch.graph_analysis`'s formulas.

  PYTHONPATH=src python -m repro_torch.launch.reanalyze [--dir build/dryrun]

Each ``<tag>.json`` record beside a ``<tag>.ops.json.gz`` table (gzipped
JSON, stdlib only) gets its ``cost``, ``collectives`` and ``roofline``
rewritten with the H100 constants of `repro_torch.launch.dryrun` (a mesh
record's collectives at the rates of its ``collective_axes``); its
``memory`` (a property of the traced graph's lifetimes) is kept.  A
one-card record written before the one-card tag became ``card`` (mesh
``single``, one chip) is read as one and rewritten as ``card``.
"""
from __future__ import annotations

import argparse
import glob
import gzip
import json
import os

from repro_torch.launch.dryrun import apply_profile
from repro_torch.launch.graph_analysis import analyze


def ops_path(json_path: str) -> str:
    return json_path[:-len(".json")] + ".ops.json.gz"


def reanalyze_record(json_path: str) -> dict:
    with open(json_path) as f:
        rec = json.load(f)
    if rec.get("mesh") == "single" and rec.get("chips") == 1:
        rec["mesh"] = "card"
    table_path = ops_path(json_path)
    if not os.path.exists(table_path):
        return rec
    with gzip.open(table_path, "rt") as f:
        table = json.load(f)
    apply_profile(rec, analyze(table))
    with open(json_path, "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.reanalyze")
    ap.add_argument("--dir", default="build/dryrun")
    args = ap.parse_args(argv)
    for path in sorted(glob.glob(os.path.join(args.dir, "*.json"))):
        rec = reanalyze_record(path)
        r = rec["roofline"]
        print(f"{rec['arch']:22s} {rec['shape']:12s} {rec['mesh']:8s} "
              f"comp={r['t_compute_s'] * 1e3:8.2f}ms "
              f"mem={r['t_memory_s'] * 1e3:8.2f}ms "
              f"coll={r['t_collective_s'] * 1e3:8.2f}ms "
              f"dom={r['dominant']:10s} "
              f"useful={r['useful_flops_ratio']:6.2f} "
              f"frac={r['roofline_fraction']:.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
