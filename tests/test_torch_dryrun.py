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
"""
import json
import shutil

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
        with open(out / f"{ARCH}_{shape}_single.json") as f:
            recs[shape] = json.load(f)
    return out, recs


def test_cli_writes_a_record_and_an_op_table_per_shape(records, capsys):
    out, recs = records
    assert sorted(p.name for p in out.iterdir()) == sorted(
        f"{ARCH}_{s}_single{ext}" for s in SHAPES
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
        (ARCH, shape, "single", 1)
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
        with open(copy / f"{ARCH}_{shape}_single.json") as f:
            again = json.load(f)
        assert again == recs[shape]
