"""The port's dry run (`repro_torch.launch.dryrun`) and re-analysis
(`repro_torch.launch.reanalyze`) on full-width InternLM2-1.8B.

The CLI traces the three shapes of the arch (``train_4k``,
``prefill_32k``, ``decode_32k``; ``long_500k`` is skipped, as the JAX
package skips it for attention models) under fake tensors: no data and
no device memory, on the CPU.  The records are held to the JAX package's
configs and formulas: ``params`` and ``active_params`` equal its
``param_count`` / ``active_param_count``; ``model_flops`` is its 6 N D
(train) or 2 N D; the arguments are the weights (bf16 to serve, f32
masters with AdamW's m and v to train), the cache and the batch; the
roofline uses the H100's constants.  The JAX package's own dry run is
not imported: it sets ``XLA_FLAGS`` for 512 devices at import.

The one-card records are tagged ``card`` (``--mesh card``, the CLI's
default).  Over a mesh (``--mesh single|multi|both``, the JAX package's
pods) the dry run traces one rank's step under a ``"fake"`` process
group; the smoke config's three shapes on a fake (2, 4) mesh are traced
in a subprocess (a process has one default group) and held to the
one-card trace and the plan: per-device FLOPs times 8 at least the
one-card FLOPs, argument bytes equal to the plan's shards, collectives
by type, and ``reanalyze`` reading mesh records and the one-card records
written before the rename (tagged ``single``).
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap

import pytest

from repro.configs import get_config as jax_get_config
from repro_torch.launch import dryrun, reanalyze

ARCH = "internlm2-1.8b"
SHAPES = ("train_4k", "prefill_32k", "decode_32k")


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun")
    rc = dryrun.main(["--arch", ARCH, "--shape", "all", "--out", str(out)])
    assert rc == 0
    recs = {}
    for shape in SHAPES:
        with open(out / f"{ARCH}_{shape}_card.json") as f:
            recs[shape] = json.load(f)
    return out, recs


def test_cli_writes_a_record_and_an_op_table_per_shape(records, capsys):
    out, recs = records
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{ARCH}_{s}_card{ext}" for s in SHAPES
        for ext in (".json", ".ops.json.gz"))
    assert dryrun.main(["--arch", ARCH, "--shape", "all", "--out",
                        str(out)]) == 0
    text = capsys.readouterr().out
    assert text.count("CACHED") == 3
    assert f"SKIP  {ARCH} long_500k" in text


@pytest.mark.parametrize("shape", SHAPES)
def test_records_hold_the_reference_keys_and_counts(records, shape):
    rec = records[1][shape]
    ref_cfg = jax_get_config(ARCH)
    assert rec["params"] == ref_cfg.param_count() == 1_889_009_664
    assert rec["active_params"] == ref_cfg.active_param_count()
    assert (rec["arch"], rec["shape"], rec["mesh"], rec["chips"]) == \
        (ARCH, shape, "card", 1)
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes",
                                  "temp_bytes", "alias_bytes",
                                  "peak_bytes"}
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"]
    # pod-sized global shapes, reported whole on one 80 GB card
    assert rec["fits_hbm80"] is False
    assert rec["collectives"] == {"bytes_by_type": {}, "counts": {},
                                  "total_bytes": 0.0}


@pytest.mark.parametrize("shape", SHAPES)
def test_model_flops_and_the_h100_roofline(records, shape):
    rec = records[1][shape]
    n = jax_get_config(ARCH).active_param_count()
    b, s = rec["global_batch"], rec["seq_len"]
    want = {"train_4k": 6.0 * n * b * s, "prefill_32k": 2.0 * n * b * s,
            "decode_32k": 2.0 * n * b}[shape]
    r, cost = rec["roofline"], rec["cost"]
    assert r["model_flops"] == want
    assert dryrun.PEAK_FLOPS == {"bf16": 989e12, "f32": 67e12}
    assert (dryrun.HBM_BW, dryrun.NVLINK_BW, dryrun.HBM_BYTES) == \
        (3.35e12, 900e9, 80e9)
    assert r["t_compute_s"] == pytest.approx(sum(
        f / dryrun.PEAK_FLOPS[c] for c, f in cost["flops_by_class"].items()))
    assert r["t_memory_s"] == pytest.approx(cost["bytes_per_device"] / 3.35e12)
    assert r["step_time_bound_s"] == max(r["t_compute_s"], r["t_memory_s"],
                                         r["t_collective_s"])
    assert r["useful_flops_ratio"] == pytest.approx(
        want / cost["flops_per_device"])
    assert r["roofline_fraction"] == pytest.approx(
        min(1.0, want / 989e12 / r["step_time_bound_s"]))
    assert 0 < r["roofline_fraction"] <= 1


def test_memory_of_each_step(records):
    recs = records[1]
    cfg = jax_get_config(ARCH)
    n = cfg.param_count()
    prefill = recs["prefill_32k"]["memory"]
    # bf16 weights (and the norms' gains, which param_count leaves out)
    # and the int32 tokens
    assert 2 * n + 32 * 32768 * 4 < prefill["argument_bytes"] < \
        (2 * n + 32 * 32768 * 4) * 1.0001
    # the returned f32 cache: (L, B, S, KV, dh) for k and v
    cache = 2 * cfg.num_layers * 32 * 32768 * cfg.num_kv_heads * \
        cfg.head_dim * 4
    assert prefill["output_bytes"] >= cache
    assert prefill["alias_bytes"] == 0
    decode = recs["decode_32k"]["memory"]
    kv = 2 * cfg.num_layers * 128 * 32768 * cfg.num_kv_heads * \
        cfg.head_dim * 4
    assert decode["alias_bytes"] == kv           # written in place
    assert decode["argument_bytes"] > kv + 2 * n
    train = recs["train_4k"]["memory"]
    # f32 masters, AdamW's m and v, updated in place
    assert 12 * n < train["alias_bytes"] < 12 * n * 1.0001
    assert train["temp_bytes"] > 0


def test_reanalyze_round_trip_keeps_the_roofline(records, tmp_path):
    out, recs = records
    copy = tmp_path / "again"
    shutil.copytree(out, copy)
    assert reanalyze.main(["--dir", str(copy)]) == 0
    for shape in SHAPES:
        with open(copy / f"{ARCH}_{shape}_card.json") as f:
            again = json.load(f)
        assert again == recs[shape]


MESH_SCRIPT = textwrap.dedent("""
    import json, sys
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=8)
    from repro_torch.configs import get_smoke_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.distributed import plan as dplan
    from repro_torch.distributed.sharding import axes_size
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_debug_mesh
    from torch._subclasses.fake_tensor import FakeTensorMode
    out = sys.argv[1]
    mesh = make_debug_mesh(2, 4, device_type="cpu")
    rules = dryrun.rules_for("internlm2-1.8b", mesh)
    cfg = get_smoke_config("internlm2-1.8b")
    result = {}

    def shard_bytes(tree, specs):
        if isinstance(tree, dict):
            return sum(shard_bytes(tree[k], specs[k]) for k in tree)
        n = tree.element_size()
        for dim, part in zip(tree.shape, tuple(specs) +
                             (None,) * tree.dim()):
            n *= dim // axes_size(mesh, part)
        return n

    for kind in ("train", "prefill", "decode"):
        shape = ShapeConfig(name=kind, kind=kind, seq_len=64,
                            global_batch=8)
        cell = dryrun.build_cell("internlm2-1.8b", shape, cfg=cfg,
                                 rules=rules)
        tag = f"internlm2-1.8b_{kind}_2x4"
        rec = dryrun.run_cell(cell, ops_path=f"{out}/{tag}.ops.json.gz",
                              rules=rules, mesh_tag="2x4")
        json.dump(rec, open(f"{out}/{tag}.json", "w"), indent=1)
        one = dryrun.run_cell(dryrun.build_cell("internlm2-1.8b", shape,
                                                cfg=cfg))
        with FakeTensorMode():
            args = cell.inputs("cpu", 0)
        want = sum(shard_bytes(a, sp) for a, sp in
                   zip(args, cell.specs(rules, *args)))
        result[kind] = {"rec": rec, "one": one, "shard_bytes": want}
    print("RESULT" + json.dumps(result))
""")


@pytest.fixture(scope="module")
def mesh_records(tmp_path_factory):
    out = tmp_path_factory.mktemp("dryrun_mesh")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(os.path.dirname(__file__), "..", "src")
    proc = subprocess.run([sys.executable, "-c", MESH_SCRIPT, str(out)],
                          env=env, capture_output=True, text=True,
                          timeout=400)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = next(x for x in proc.stdout.splitlines()
                if x.startswith("RESULT"))
    return out, json.loads(line[len("RESULT"):])


@pytest.mark.parametrize("kind", ("train", "prefill", "decode"))
def test_mesh_records_are_one_rank_of_eight(mesh_records, kind):
    got = mesh_records[1][kind]
    rec, one = got["rec"], got["one"]
    assert (rec["mesh"], rec["chips"]) == ("2x4", 8)
    assert rec["mesh_shape"] == {"data": 2, "model": 4}
    assert 8 * rec["cost"]["flops_per_device"] >= \
        one["cost"]["flops_per_device"]
    assert rec["cost"]["flops_per_device"] < \
        one["cost"]["flops_per_device"]
    assert rec["memory"]["argument_bytes"] == got["shard_bytes"]
    assert rec["memory"]["argument_bytes"] < one["memory"]["argument_bytes"]
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] \
        + rec["memory"]["temp_bytes"]
    counts = rec["collectives"]["counts"]
    want = {"train": {"all-gather", "all-reduce", "reduce-scatter"},
            "prefill": {"all-gather", "all-reduce"},
            "decode": {"all-gather", "all-reduce"}}[kind]
    assert want <= set(counts) and all(counts[t] > 0 for t in want)
    by_dim = rec["collectives"]["bytes_by_dim"]
    assert set(by_dim) == {"data", "model"}
    assert sum(by_dim.values()) == rec["collectives"]["total_bytes"]
    # (2, 4) lies in one 8-GPU node: every dim at NVLink's rate
    axes = rec["collective_axes"]
    assert {a["dim"]: a["link"] for a in axes.values()} == \
        {"data": "nvlink", "model": "nvlink"}
    assert rec["roofline"]["t_collective_s"] == pytest.approx(
        rec["collectives"]["total_bytes"] / dryrun.NVLINK_BW)
    assert one["collectives"]["total_bytes"] == 0.0


def test_production_mesh_dims_cross_nodes():
    """On a 16 x 16 mesh every dim's group spans nodes of 8 GPUs, so
    each is charged at InfiniBand's rate; ranks 0..7 of a dim of 8 stay
    on NVLink."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    class Mesh(DeviceMesh):
        def get_group(self, dim):
            return type("G", (), {"group_name": f"g{dim}"})()

    def mesh(shape, names):
        n = 1
        for d in shape:
            n *= d
        return Mesh("cpu", torch.arange(n).reshape(shape),
                    mesh_dim_names=names, _init_backend=False, _rank=0)
    axes = dryrun.collective_axes(mesh((16, 16), ("data", "model")))
    assert {a["dim"]: (a["link"], a["rate"]) for a in axes.values()} == {
        "data": ("infiniband", dryrun.IB_BW),
        "model": ("infiniband", dryrun.IB_BW)}
    axes = dryrun.collective_axes(mesh((2, 8), ("data", "model")))
    assert {a["dim"]: a["link"] for a in axes.values()} == {
        "data": "infiniband", "model": "nvlink"}
    assert dryrun.IB_BW == 50e9 and dryrun.NODE_GPUS == 8


def test_reanalyze_reads_mesh_and_old_one_card_records(mesh_records,
                                                       records, tmp_path):
    out, got = mesh_records
    copy = tmp_path / "mesh"
    shutil.copytree(out, copy)
    # a one-card record as the dry run wrote it before the rename
    card = records[0] / f"{ARCH}_decode_32k_card"
    for ext in (".json", ".ops.json.gz"):
        shutil.copy(str(card) + ext, copy / f"{ARCH}_decode_32k_single{ext}")
    with open(copy / f"{ARCH}_decode_32k_single.json") as f:
        old = json.load(f)
    old["mesh"] = "single"
    with open(copy / f"{ARCH}_decode_32k_single.json", "w") as f:
        json.dump(old, f)
    assert reanalyze.main(["--dir", str(copy)]) == 0
    for kind in ("train", "prefill", "decode"):
        with open(copy / f"internlm2-1.8b_{kind}_2x4.json") as f:
            assert json.load(f) == got[kind]["rec"]
    with open(copy / f"{ARCH}_decode_32k_single.json") as f:
        again = json.load(f)
    assert again["mesh"] == "card"
    assert again["roofline"] == records[1]["decode_32k"]["roofline"]
