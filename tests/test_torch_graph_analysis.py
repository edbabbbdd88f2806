"""The port's graph analysis (`repro_torch.launch.graph_analysis`) on
hand-computable programs, against the JAX package's HLO analysis, and
against ``FlopCounterMode`` on real steps.

- The counterparts of tests/test_hlo_analysis.py: a plain matmul's
  flops, L stacked layers cost L times one layer (the HLO analysis's
  trip counts; the port's loops are unrolled), nested loops, HBM bytes of
  the right order, and the op table's JSON round trip.
- The smoke prefill against the JAX package's ``hlo_analysis.analyze``
  of its jitted prefill.  Traced through the plain versions (no kernel
  node: the attention's products over the full S x S scores, as the JAX
  package computes them), the dot flops are equal.  With each kernel one
  node, the matrix products agree exactly; the gap is the attention,
  one flash node counting the causal pairs (4 dh H a visible pair), and
  the norms, kernel nodes whose elementwise flops the port counts and
  the HLO analysis (dots only) does not.  Both terms are computed here,
  so the totals agree to the flop.
- Each ``repro_torch::`` kernel operator's flops equal its hand formula,
  the one `chip_smoke.py` uses for the kernel's bound, under
  ``FlopCounterMode`` and in the analysis of its trace.
- The dry run's flops of a smoke prefill, decode step and train step,
  traced in fake mode, equal ``FlopCounterMode``'s on the real step on
  the CPU (the card's check in `chip_smoke.py`, at the smoke config).
"""
import gzip
import json
import math

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.proxy_tensor import make_fx
from torch.utils.flop_counter import FlopCounterMode

from repro.configs import get_smoke_config as jax_smoke_config
from repro.launch.hlo_analysis import analyze as hlo_analyze
from repro.models import init_params as jax_init_params
from repro.models import prefill as jax_prefill
from repro_torch.configs import get_smoke_config
from repro_torch.configs.base import ShapeConfig
from repro_torch.kernels import ops
from repro_torch.kernels.traced import traced_kernels
from repro_torch.launch import dryrun
from repro_torch.launch import graph_analysis as ga

ARCH = "internlm2-1.8b"


def trace(fn, *shapes, dtype=torch.float32):
    mode = FakeTensorMode()
    with mode:
        args = [torch.empty(s, dtype=dtype) for s in shapes]
    with traced_kernels(), mode:
        return make_fx(fn)(*args)


def test_plain_matmul_flops():
    p = ga.analyze(trace(lambda a, b: a @ b, (64, 128), (128, 32)))
    assert p.flops == 2 * 64 * 128 * 32
    assert p.flops_by_class == {ga.F32: 2 * 64 * 128 * 32}


def test_stacked_layers_cost_layers_times_one():
    def layers(w, x):
        for wl in w.unbind(0):
            x = torch.tanh(x @ wl)
        return x
    p = ga.analyze(trace(layers, (10, 64, 64), (8, 64)))
    one = ga.analyze(trace(layers, (1, 64, 64), (8, 64)))
    assert p.flops == 10 * 2 * 8 * 64 * 64 == 10 * one.flops


def test_nested_loops():
    def f(w, x):
        for wl in w.unbind(0):
            for _ in range(3):
                x = torch.tanh(x @ wl)
        return x
    p = ga.analyze(trace(f, (5, 32, 32), (4, 32)))
    assert p.flops == 5 * 3 * 2 * 4 * 32 * 32


def test_hbm_bytes_order_of_magnitude():
    p = ga.analyze(trace(lambda a, b: a @ b, (512, 512), (512, 512)))
    # 2 inputs + 1 output = 3 MB, each read or written once
    assert p.hbm_bytes == 3 * 512 * 512 * 4
    assert 2e6 < p.hbm_bytes < 1e7


def test_views_move_nothing_and_bf16_products_run_on_the_tensor_cores():
    def f(a, b):
        return (a.reshape(64, 128).t() @ b.reshape(64, 32)).reshape(-1)
    p = ga.analyze(trace(f, (8, 8, 128), (8, 8, 32), dtype=torch.bfloat16))
    assert p.flops_by_class == {ga.BF16: 2 * 128 * 64 * 32}
    assert p.hbm_bytes == 2 * (64 * 128 + 64 * 32 + 128 * 32)


def test_op_table_round_trips_through_json(tmp_path):
    gm = trace(lambda a, b: torch.relu(a @ b).sum(0), (16, 32), (32, 8))
    table = ga.op_table(gm)
    path = tmp_path / "ops.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump(table, f)
    with gzip.open(path, "rt") as f:
        again = json.load(f)
    assert again == table
    assert ga.analyze(again) == ga.analyze(gm)
    top = ga.top_contributors(again, k=2)
    assert len(top) == 2 and top[0][0] >= top[1][0]


B, S = 2, 32


@pytest.fixture(scope="module")
def reference_prefill_flops():
    jcfg = jax_smoke_config(ARCH)
    jparams = jax_init_params(jcfg, jax.random.key(0))
    compiled = jax.jit(lambda p, t: jax_prefill(jcfg, p, t, max_len=S)) \
        .lower(jparams, jax.ShapeDtypeStruct((B, S), jnp.int32)).compile()
    return hlo_analyze(compiled.as_text()).flops


def test_smoke_prefill_through_the_plain_versions_equals_the_reference(
        reference_prefill_flops):
    cell = dryrun.build_cell(ARCH, ShapeConfig("p", "prefill", S, B),
                             cfg=get_smoke_config(ARCH))
    mode = dryrun.fake_mode()
    with mode:
        args = cell.inputs("cpu", 0)
    with mode:
        gm = make_fx(cell.fn)(*args)
    assert not any(str(n.target).startswith("repro_torch.")
                   for n in gm.graph.nodes)
    assert ga.analyze(gm).flops == reference_prefill_flops


def test_smoke_prefill_against_the_reference_hlo_analysis(
        reference_prefill_flops):
    ref, cfg, b, s = reference_prefill_flops, get_smoke_config(ARCH), B, S
    cell = dryrun.build_cell(ARCH, ShapeConfig("p", "prefill", s, b),
                             cfg=cfg)
    gm, shape_env, _ = dryrun.trace(cell)
    by_op, count = {}, {}
    for row in ga.op_table(gm, shape_env):
        by_op[row["op"]] = by_op.get(row["op"], 0.0) + ga.row_cost(row)[0]
        count[row["op"]] = count.get(row["op"], 0) + 1
    layers, h, dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
    ref_attention = layers * 2 * (2 * b * h * s * s * dh)   # QK^T, PV
    flash = layers * 4 * dh * h * b * s * (s + 1) // 2
    plain = count["repro_torch.fused_norm.default"]
    with_residual = count["repro_torch.fused_norm_residual.default"]
    assert plain + with_residual == 2 * layers + 1
    # 5 flops an element, 6 where the residual is added in
    norms = (5 * plain + 6 * with_residual) * b * s * cfg.d_model
    matmuls = sum(v for k, v in by_op.items() if k.startswith("aten."))
    assert matmuls == ref - ref_attention
    assert by_op["repro_torch.flash_attention.default"] == flash
    assert by_op["repro_torch.fused_norm.default"] + \
        by_op["repro_torch.fused_norm_residual.default"] == norms
    total = ga.analyze(gm).flops
    assert total == ref - ref_attention + flash + norms
    assert 0.95 < total / ref < 1.0       # the causal half, the norms


def _kernel_cases():
    g = torch.Generator().manual_seed(0)

    def rand(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype)

    r, c = 24, 64
    b, h, kv, sq, sk, dh = 2, 4, 2, 16, 48, 16
    v = 300
    lens = torch.tensor([40, 48], dtype=torch.int32)
    nb, bs, mb = 9, 8, 4
    tables = torch.arange(1, 1 + b * mb, dtype=torch.int32).reshape(b, mb) \
        % nb
    seg = torch.zeros(sk, dtype=torch.int32)
    pos = torch.arange(sk, dtype=torch.int32)
    return {
        "fused_softmax": (lambda: ops.fused_softmax(
            rand(r, c), torch.full((r,), c, dtype=torch.int32), scale=0.5),
            5 * r * c),
        "fused_rmsnorm": (lambda: ops.fused_rmsnorm(rand(r, c), rand(c)),
                          5 * r * c),
        "fused_rmsnorm residual": (lambda: ops.fused_rmsnorm(
            rand(r, c), rand(c), None, rand(r, c), return_residual=True),
            6 * r * c),
        "fused_layernorm": (lambda: ops.fused_layernorm(
            rand(r, c), rand(c), rand(c), rand(c), rand(r, c)), 6 * r * c),
        "fused_sample": (lambda: ops.fused_sample(
            rand(b, v), torch.ones(b), torch.zeros(b, dtype=torch.int32),
            torch.ones(b), rand(b, 8)), 2 * b * v),
        "flash_attention causal": (lambda: ops.flash_attention(
            rand(b, h, sq, dh), rand(b, kv, sk, dh), rand(b, kv, sk, dh),
            lens), 4 * dh * h * b * (sq * (sk - sq) + sq * (sq + 1) // 2)),
        "flash_attention full": (lambda: ops.flash_attention(
            rand(b, h, sk, dh), rand(b, kv, sk, dh), rand(b, kv, sk, dh),
            causal=False), 4 * dh * h * b * sk * sk),
        "flash_attention_packed": (lambda: ops.flash_attention_packed(
            rand(1, h, sq, dh), rand(1, kv, sk, dh), rand(1, kv, sk, dh),
            seg[:sq], seg, pos[-sq:], pos),
            4 * dh * h * (sq * (sk - sq) + sq * (sq + 1) // 2)),
        "flash_attention_packed_plan": (
            lambda: ops.flash_attention_packed_plan(seg[:sq], seg,
                                                    pos[-sq:], pos), 0),
        "flash_decode": (lambda: ops.flash_decode(
            rand(b, h, dh), rand(b, kv, sk, dh), rand(b, kv, sk, dh), lens),
            4 * h * dh * b * sk),
        "flash_decode_paged": (lambda: ops.flash_decode_paged(
            rand(b, h, dh), rand(nb, bs, kv, dh), rand(nb, bs, kv, dh),
            tables, lens), 4 * h * dh * b * mb * bs),
    }


@pytest.mark.parametrize("case", sorted(_kernel_cases()))
def test_kernel_operator_flops_equal_the_hand_formula(case):
    run, want = _kernel_cases()[case]
    ga.register_flop_formulas()
    with traced_kernels(), FlopCounterMode(display=False) as counter:
        run()
    assert counter.get_total_flops() == want
    with traced_kernels():
        gm = make_fx(lambda: run())()
    kernel_rows = [r for r in ga.op_table(gm)
                   if r["op"].startswith("repro_torch.")]
    assert len(kernel_rows) == 1
    assert ga.row_cost(kernel_rows[0])[0] == want


@pytest.mark.parametrize("shape", [
    ShapeConfig("prefill", "prefill", 32, 2),
    ShapeConfig("decode", "decode", 32, 2),
    ShapeConfig("train", "train", 32, 4),
], ids=lambda s: s.kind)
def test_dry_run_flops_equal_flop_counter_mode_on_the_real_step(shape):
    cell = dryrun.build_cell(ARCH, shape, cfg=get_smoke_config(ARCH))
    rec = dryrun.run_cell(cell)
    args = cell.inputs("cpu", 0)
    ga.register_flop_formulas()
    with traced_kernels(), FlopCounterMode(display=False) as counter:
        cell.fn(*args)
    assert rec["cost"]["flops_per_device"] == counter.get_total_flops()
    assert math.isfinite(rec["roofline"]["step_time_bound_s"])
