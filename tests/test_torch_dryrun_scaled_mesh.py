"""The dry run's scaled records held against its full traces over a fake
(2, 4) ``("data", "model")`` mesh: one rank's step, traced in a
subprocess (a process has one default group).

The cases: prefill and decode of every family; train at ``grad_accum``
4 for the dense family (its microbatches extended too) and 2 for the
MoE, SSM and hybrid families; and Llama3-405B's train step, whose
residual stream is sequence-sharded over ``model`` and whose Adafactor
statistics of the stacked layers keep their own placements.  FLOPs by
class, HBM bytes, collective bytes by type, count and mesh dim, the op
count, and the arguments, outputs and aliases equal the full trace's;
the temporaries are held to ``TEMP_REL`` of
`tests/test_torch_dryrun_scaled.py`, and so is the rest of the check.
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from test_torch_dryrun_scaled import BATCH, FAMILIES, SEQ, check_scaled, \
    smoke_cfg

MESH_SCRIPT = textwrap.dedent("""
    import dataclasses, json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    mesh = make_debug_mesh(2, 4, device_type="cpu")
    result = {}
    for arch, kind, ga, layers in json.loads(sys.argv[1]):
        rules = dryrun.rules_for(arch, mesh)
        cfg = dataclasses.replace(get_smoke_config(arch), num_layers=layers)
        cell = dryrun.build_cell(arch, ShapeConfig(kind, kind, %d, %d),
                                 cfg=cfg, rules=rules, grad_accum=ga)
        full = dryrun.run_cell(cell, rules=rules, mesh_tag="2x4")
        scaled = dryrun.run_scaled(cell, rules=rules, mesh_tag="2x4")
        result["%%s %%s %%s" %% (arch, kind, ga)] = {"full": full,
                                                  "scaled": scaled}
    print("RESULT" + json.dumps(result))
""" % (SEQ, BATCH))

#: (arch, kind, grad_accum)
CASES = [(FAMILIES[f], k, g) for f in FAMILIES
         for k, g in ((("train", 4),) if f == "dense" else
                      (("train", 2),) if f in ("moe", "ssm", "hybrid")
                      else ()) + (("prefill", None), ("decode", None))] + \
    [("llama3-405b", "train", 2)]


@pytest.fixture(scope="module")
def mesh_records():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    cases = [(a, k, g, smoke_cfg(a).num_layers) for a, k, g in CASES]
    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT,
                           json.dumps(cases)], env=env, capture_output=True,
                          text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT"))
    return json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("arch,kind,grad_accum", CASES)
def test_mesh_scaled_record_equals_the_full_trace(mesh_records, arch, kind,
                                                  grad_accum):
    got = mesh_records[f"{arch} {kind} {grad_accum}"]
    full, scaled = got["full"], got["scaled"]
    check_scaled(full, scaled)
    assert (scaled["mesh"], scaled["chips"]) == ("2x4", 8)
    assert scaled["seq_shard"] == (arch == "llama3-405b" and
                                   kind == "train")
    assert scaled["collective_axes"] == full["collective_axes"]
    assert scaled["collectives"]["total_bytes"] > 0
    assert scaled["roofline"] == full["roofline"]
