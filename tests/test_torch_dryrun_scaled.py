"""The dry run's scaled records (`repro_torch.launch.dryrun.run_scaled`,
the CLI's path) held against its full traces (`run_cell`) on one card.

A scaled record traces a step at two depths of whole periods (the
hybrid's period is ``attn_every`` layers, every other family's one
layer; two and three periods, one and two for a period of three layers
and more) and, for train, two microbatch counts, and adds the traces'
counts with the weights of bilinear extrapolation.  Held here on the
smoke config of every family cut to four periods and more (five layers;
the hybrid nine: four periods of ``attn_every`` 2 and one layer over):
prefill and decode of every family; train at ``grad_accum`` 1, 2 and 4
for the dense family, 1 and 2 for the hybrid, 4 for the SSM family (its
microbatches extended too) and 2 for the others; the hybrid at a period
of three (train at 2, prefill, decode); and full-width
InternLM2-1.8B's ``prefill_32k`` and ``decode_32k``.  FLOPs by class,
HBM bytes, collective bytes by type and count, the op count, and the
arguments, outputs and aliases equal the full trace's; the temporaries
(the live-bytes peak, not a sum, extended in depth) are held to
``TEMP_REL``.  ``reanalyze`` rebuilds a scaled record's cost,
collectives and roofline from its op table (each trace's rows with its
weight).  `tests/test_torch_dryrun_scaled_mesh.py` holds the same on a
fake (2, 4) mesh.
"""
import dataclasses
import json
import shutil

import pytest

from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun, reanalyze

#: an arch of every family
FAMILIES = {"dense": "internlm2-1.8b", "moe": "olmoe-1b-7b",
            "vlm": "qwen2-vl-7b", "audio": "musicgen-large",
            "ssm": "falcon-mamba-7b", "hybrid": "zamba2-1.2b"}
#: each family's steps: (kind, grad_accum)
STEPS = {"dense": (("train", 1), ("train", 2), ("train", 4)),
         "moe": (("train", 2),), "vlm": (("train", 2),),
         "audio": (("train", 2),), "ssm": (("train", 4),),
         "hybrid": (("train", 1), ("train", 2))}
CASES = [(f, k, g) for f in FAMILIES
         for k, g in STEPS[f] + (("prefill", None), ("decode", None))]
SEQ, BATCH = 32, 8
#: the temporaries against the full trace's, relative.  They are the
#: largest live bytes at one op, a maximum over the step, not a sum: the
#: scaled record extends each op's live bytes from two short traces
#: (each period matched with its place in the other trace) and takes the
#: largest.  Where the op that holds the peak at full depth holds it in a
#: period of neither short trace alike, the extension misses it: the
#: hybrid's train step at one microbatch, 1.3 % over
TEMP_REL = 0.02


def smoke_cfg(arch):
    cfg = get_smoke_config(arch)
    period, _ = dryrun.layer_period(cfg)
    return dataclasses.replace(
        cfg, num_layers=5 if period == 1 else 4 * period + 1)


def exact_fields(rec):
    """Every field the scaled record must reproduce exactly."""
    mem = rec["memory"]
    coll = rec["collectives"]
    return {"flops_by_class": rec["cost"]["flops_by_class"],
            "flops": rec["cost"]["flops_per_device"],
            "bytes": rec["cost"]["bytes_per_device"],
            "collective_bytes": coll["bytes_by_type"],
            "collective_counts": coll["counts"],
            "collective_bytes_by_dim": coll.get("bytes_by_dim"),
            "collective_total": coll["total_bytes"],
            "ops": rec["ops"],
            "argument_bytes": mem["argument_bytes"],
            "output_bytes": mem["output_bytes"],
            "alias_bytes": mem["alias_bytes"]}


def check_scaled(full, scaled, exact=True):
    if exact:
        assert exact_fields(scaled) == exact_fields(full)
    else:
        # full width: float sums of numbers above 2 ** 53 round, in
        # another order in each record
        a, b = exact_fields(full), exact_fields(scaled)
        for k, v in a.items():
            if isinstance(v, dict):
                assert b[k].keys() == v.keys(), k
                for key in v:
                    assert b[k][key] == pytest.approx(v[key], rel=1e-12)
            else:
                assert b[k] == pytest.approx(v, rel=1e-12), k
    assert scaled["memory"]["temp_bytes"] == pytest.approx(
        full["memory"]["temp_bytes"], rel=TEMP_REL)
    assert scaled["memory"]["peak_bytes"] == \
        scaled["memory"]["argument_bytes"] + scaled["memory"]["temp_bytes"]
    for key in ("arch", "shape", "mesh", "chips", "params",
                "active_params", "global_batch", "seq_len"):
        assert scaled[key] == full[key], key
    assert scaled["roofline"]["model_flops"] == \
        full["roofline"]["model_flops"]
    s = scaled["scaled"]
    assert scaled["trace_s"] == pytest.approx(
        sum(t["trace_s"] for t in s["traces"]), abs=0.05)
    assert {t["layers"] for t in s["traces"]} <= {
        s["remainder"] + k * s["period"]
        for k in dryrun.scale_periods(s["period"])}


@pytest.mark.parametrize("family,kind,grad_accum", CASES)
def test_scaled_record_equals_the_full_trace(family, kind, grad_accum,
                                              tmp_path):
    arch = FAMILIES[family]
    cell = dryrun.build_cell(arch, ShapeConfig(kind, kind, SEQ, BATCH),
                             cfg=smoke_cfg(arch), grad_accum=grad_accum)
    full = dryrun.run_cell(cell)
    ops = tmp_path / "rec.ops.json.gz"
    scaled = dryrun.run_scaled(cell, ops_path=str(ops))
    check_scaled(full, scaled)
    plan = dryrun.scaled_plan(cell)
    # four periods and more: two depths, and for grad_accum 4 two
    # microbatch counts, the weights bilinear extrapolation's
    assert len(plan) == (4 if grad_accum == 4 else 2)
    assert sum(wk * wm for _, _, wk, wm in plan) == 1
    # reanalyze rebuilds the record from its op table
    with open(tmp_path / "rec.json", "w") as f:
        json.dump(scaled, f)
    assert reanalyze.reanalyze_record(str(tmp_path / "rec.json")) == scaled


#: the hybrid at a long period (``attn_every`` 3, three periods and one
#: layer over): its record is scaled from one and two periods
LONG_PERIOD_CASES = (("train", 2), ("prefill", None), ("decode", None))


@pytest.mark.parametrize("kind,grad_accum", LONG_PERIOD_CASES)
def test_a_long_period_scales_from_one_period(kind, grad_accum):
    cfg = dataclasses.replace(get_smoke_config("zamba2-1.2b"),
                              attn_every=dryrun.LONG_PERIOD,
                              num_layers=3 * dryrun.LONG_PERIOD + 1)
    cell = dryrun.build_cell("zamba2-1.2b", ShapeConfig(kind, kind, SEQ,
                                                        BATCH),
                             cfg=cfg, grad_accum=grad_accum)
    scaled = dryrun.run_scaled(cell)
    assert {t["layers"] for t in scaled["scaled"]["traces"]} == {4, 7}
    assert scaled["scaled"]["periods"] == 3
    check_scaled(dryrun.run_cell(cell), scaled)


@pytest.mark.parametrize("shape", ("prefill_32k", "decode_32k"))
def test_full_width_internlm2_scaled_equals_the_full_trace(shape):
    cell = dryrun.build_cell("internlm2-1.8b", shape)
    check_scaled(dryrun.run_cell(cell), dryrun.run_scaled(cell),
                 exact=False)


def test_the_plan_extends_to_the_full_depth_and_microbatches():
    cell = dryrun.build_cell("llama3-405b", "train_4k")
    # 126 layers from 2 and 3, 16 microbatches from 2 and 3
    assert dryrun.scaled_plan(cell) == [(2, 2, -123, -13), (2, 3, -123, 14),
                                        (3, 2, 124, -13), (3, 3, 124, 14)]
    hybrid = dryrun.build_cell("zamba2-1.2b", "prefill_32k")
    # 38 layers = 6 periods of 6 and 2 over; prefill has no microbatches
    assert dryrun.layer_period(hybrid.cfg) == (6, 2)
    # from one and two periods (a period of three layers and more)
    assert dryrun.scaled_plan(hybrid) == [(8, None, -4, 1),
                                          (14, None, 5, 1)]
    # a cell no longer than the traces is traced whole
    one = dryrun.build_cell("internlm2-1.8b", ShapeConfig(
        "t", "train", 64, 8), cfg=dataclasses.replace(
            get_smoke_config("internlm2-1.8b"), num_layers=3), grad_accum=1)
    assert dryrun.scaled_plan(one) == [(3, 1, 1, 1)]


def test_reanalyze_reads_a_directory_of_scaled_records(tmp_path):
    """The CLI's records are scaled; ``reanalyze`` over their directory
    rewrites each one equal to itself."""
    out = tmp_path / "cli"
    assert dryrun.main(["--arch", "internlm2-1.8b", "--shape",
                        "prefill_32k,decode_32k", "--out", str(out)]) == 0
    recs = {}
    for path in sorted(out.glob("*.json")):
        with open(path) as f:
            recs[path.name] = json.load(f)
        assert "scaled" in recs[path.name]
    copy = tmp_path / "again"
    shutil.copytree(out, copy)
    assert reanalyze.main(["--dir", str(copy)]) == 0
    for name, rec in recs.items():
        with open(copy / name) as f:
            assert json.load(f) == rec
