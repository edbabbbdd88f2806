"""Dry run of the port: the work in one step of every (arch, shape) cell,
counted from its graph without running it.

The counterpart of `repro.launch.dryrun`.  The JAX package lowers each
cell on 512 fake TPU devices and reads XLA's memory analysis and HLO.
The port traces each cell's step with ``make_fx`` under a
``FakeTensorMode`` at full width on one device (no data, no device
memory: the weights, optimizer state and caches are fake tensors), each
kernel wrapper one node (`repro_torch.kernels.traced`), and reads from
that graph:

- ``cost`` and ``collectives``: `repro_torch.launch.graph_analysis`;
- ``memory``: the arguments' bytes (weights, optimizer state, cache,
  batch), the outputs' (those not among the arguments), the temporaries'
  (the live-bytes peak of the storages the step allocates, each alive
  from the op that makes it to its last reader, as the allocator's usage
  records count them, `repro_torch.core.usage_records.graph_lifetimes`),
  the aliases' (arguments written in place: the train state, a decode
  cache) and ``peak_bytes`` = arguments + temporaries; ``fits_hbm80``
  says whether that peak fits the card's 80 GB;
- ``roofline``: ``model_flops`` = 6 N_active tokens for train and
  2 N_active tokens otherwise (tokens of the whole global batch; one a
  row for decode), each class of the graph's flops over its peak, the
  bytes over HBM's rate, the collectives over NVLink's, and the step's
  bound the largest of the three.

The steps: train is ``make_train_step`` (``forward_train``, backward
and the optimizer, ``grad_accum`` microbatches); prefill is
``prefill``; decode is ``decode_step`` over a contiguous cache of the
shape's length.  The global shapes (`repro_torch.configs.SHAPES`) were
sized for a pod; on one card the dry run reports them whole and marks
what does not fit.  ``TRAIN_TUNING`` is the JAX package's table less its
sharding knobs (``seq_shard``, ``uneven``, ``kv_dh_shard``); a mesh
(``--mesh``) waits for the port's ``distributed/``.

Usage (CPU only, no device memory):

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch internlm2-1.8b --shape all [--out build/dryrun]

Each cell writes ``<arch>_<shape>_single.json`` (the record)
and ``.ops.json.gz`` (its op table, which
`repro_torch.launch.reanalyze` re-reads).
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.configs import ARCH_IDS, SHAPES, get_config, shapes_for
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.launch import graph_analysis as ga

#: the card the roofline is for, and its data-sheet peaks (SXM part,
#: dense, at its 700 W limit): bf16 on the tensor cores, f32 outside
#: them (TF32 off, as `chip_smoke.py` sets it), HBM3 and NVLink
CARD = "NVIDIA H100 SXM 80 GB (data sheet, 700 W)"
PEAK_FLOPS = {ga.BF16: 989e12, ga.F32: 67e12}
HBM_BW = 3.35e12
NVLINK_BW = 900e9
HBM_BYTES = 80e9

# Per-arch training knobs (the JAX package's table, less its sharding
# knobs).  grad_accum splits the global batch into microbatches.
TRAIN_TUNING: Dict[str, Dict[str, Any]] = {
    "llama3-405b": dict(grad_accum=16, optimizer="adafactor",
                        grad_dtype="bfloat16", param_dtype="bfloat16"),
    "qwen3-32b": dict(grad_accum=16, optimizer="adafactor"),
    "starcoder2-15b": dict(grad_accum=8, optimizer="adafactor"),
    "phi3.5-moe-42b-a6.6b": dict(grad_accum=8, optimizer="adafactor"),
    "qwen2-vl-7b": dict(grad_accum=8, optimizer="adamw"),
    "falcon-mamba-7b": dict(grad_accum=8, optimizer="adamw"),
    "olmoe-1b-7b": dict(grad_accum=2, optimizer="adamw"),
    "internlm2-1.8b": dict(grad_accum=2, optimizer="adamw"),
    # the SSD block-matmul form of Mamba-2
    "zamba2-1.2b": dict(grad_accum=4, optimizer="adamw", mamba_ssd=True),
    "musicgen-large": dict(grad_accum=4, optimizer="adamw"),
}


def runtime_for(shape: ShapeConfig, arch: str):
    """The JAX package's ``_runtime_for`` without ``seq_shard``."""
    from repro_torch.models import ModelRuntime
    tun = TRAIN_TUNING.get(arch, {})
    if shape.kind == "train":
        default_attn = "chunked_train" if shape.seq_len >= 2048 else "naive"
    else:
        default_attn = "chunked" if shape.seq_len >= 2048 else "naive"
    default_qb = 1024 if shape.kind != "train" else 512
    default_kb = 4096 if shape.kind != "train" else 1024
    return ModelRuntime(
        attn_impl=str(tun.get("attn_impl", default_attn)),
        q_block=int(tun.get("q_block", default_qb)),
        kv_block=int(tun.get("kv_block", default_kb)),
        remat=str(tun.get("remat",
                          "full" if shape.kind == "train" else "none")),
        unroll_decode=bool(tun.get("unroll_decode",
                                   shape.kind == "decode")))


def fake_mode():
    """A fake mode whose ops may take sizes from data (the embedding
    gradient's unique rows), each at the upper bound of its range."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.symbolic_shapes import ShapeEnv
    return FakeTensorMode(allow_non_fake_inputs=True, shape_env=ShapeEnv(
        allow_dynamic_output_shape_ops=True))


@dataclasses.dataclass
class Cell:
    """One (arch, shape) cell: its config, the step function ``fn`` and a
    function that makes its arguments (weights drawn from ``seed`` on
    ``device``; under a fake mode nothing is computed or allocated)."""
    arch: str
    shape: ShapeConfig
    cfg: ModelConfig
    fn: Callable
    inputs: Callable[..., Tuple]

    def model_flops(self) -> float:
        n_active = self.cfg.active_param_count()
        b, s = self.shape.global_batch, self.shape.seq_len
        if self.shape.kind == "train":
            return 6.0 * n_active * b * s
        if self.shape.kind == "prefill":
            return 2.0 * n_active * b * s
        return 2.0 * n_active * b


def build_cell(arch: str, shape: Union[str, ShapeConfig],
               cfg: Optional[ModelConfig] = None, rt=None) -> Cell:
    """The cell's step at full width: ``SHAPES[shape]``, or any
    ``ShapeConfig`` (the card's own shapes in `chip_smoke.py`); ``cfg``
    in place of the arch's full config (a test's reduced one), ``rt`` in
    place of :func:`runtime_for`'s (the card's train step runs the
    default ``ModelRuntime``)."""
    from repro_torch.models import decode_step, init_params, make_cache
    from repro_torch.models import io as mio
    from repro_torch.training import (OptimizerConfig, TrainConfig,
                                      init_state, make_train_step)
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    cfg = cfg if cfg is not None else get_config(arch)
    tun = TRAIN_TUNING.get(arch, {})
    if tun.get("mamba_ssd") and cfg.ssm and cfg.ssm.variant == "mamba2":
        cfg = dataclasses.replace(
            cfg, ssm=dataclasses.replace(cfg.ssm, ssd_matmul=True))
    rt = rt if rt is not None else runtime_for(shape, arch)
    b, s = shape.global_batch, shape.seq_len

    def batch_like(specs, device, seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        out = {}
        for k, spec in specs.items():
            if spec.is_floating_point():
                out[k] = torch.randn(spec.shape, generator=gen,
                                     device=device).to(spec.dtype)
            else:
                out[k] = torch.randint(0, cfg.vocab_size, spec.shape,
                                       generator=gen, device=device,
                                       dtype=spec.dtype)
        return out

    if shape.kind == "train":
        ga_steps = max(1, min(int(tun.get("grad_accum", 1)), b))
        tc = TrainConfig(
            optimizer=OptimizerConfig(name=tun.get("optimizer", "adamw")),
            grad_accum=ga_steps,
            param_dtype=str(tun.get("param_dtype", "float32")),
            compute_dtype="bfloat16",
            grad_dtype=str(tun.get("grad_dtype", "float32")))
        step = make_train_step(cfg, tc, rt)

        def inputs(device="cpu", seed=0):
            return (init_state(cfg, tc, seed, device=device),
                    batch_like(mio.train_input_specs(cfg, shape), device,
                               seed + 1))
        return Cell(arch, shape, cfg, step, inputs)

    def params_on(device, seed):
        return init_params(cfg, seed=seed, device=device,
                           param_dtype="bfloat16")

    if shape.kind == "prefill":
        from repro_torch.models import prefill

        def pf(params, batch):
            return prefill(cfg, params, batch["tokens"], max_len=s,
                           embeds_override=batch.get("embeds_override"))

        def inputs(device="cpu", seed=0):
            return (params_on(device, seed),
                    batch_like(mio.prefill_input_specs(cfg, shape), device,
                               seed + 1))
        return Cell(arch, shape, cfg, pf, inputs)

    def serve_step(params, cache, tokens_t):
        return decode_step(cfg, params, cache, tokens_t)

    def inputs(device="cpu", seed=0):
        cache = make_cache(cfg, b, s, device=device)
        cache["len"].fill_(s - 1)           # the step writes the last slot
        tok = batch_like({"t": mio.decode_input_specs(cfg, shape)[
            "tokens_t"]}, device, seed + 1)["t"]
        return params_on(device, seed), cache, tok
    return Cell(arch, shape, cfg, serve_step, inputs)


def trace(cell: Cell, seed: int = 0):
    """``(graph, shape_env, arguments)``: the cell's step traced under a
    fake mode with each kernel wrapper one node, profiler ranges
    removed."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels.traced import traced_kernels
    mode = fake_mode()
    with mode:
        args = cell.inputs("cpu", seed)
    with traced_kernels(), mode:
        gm = make_fx(cell.fn)(*args)
    for node in reversed(list(gm.graph.nodes)):
        if node.op == "call_function" and \
                str(node.target).startswith("profiler.") and not node.users:
            gm.graph.erase_node(node)
    return gm, mode.shape_env, args


def memory(gm: torch.fx.GraphModule, shape_env) -> Dict[str, int]:
    """Arguments, outputs, temporaries (live-bytes peak), aliases and the
    peak of one step, from its graph."""
    from repro_torch.core.allocator import TensorUsageRecord
    from repro_torch.core.usage_records import (_storage_key,
                                                graph_lifetimes,
                                                peak_live_bytes)

    def nbytes(t):
        return ga._concrete(t.untyped_storage().nbytes(), shape_env)

    args: Dict[Any, int] = {}
    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            for v in ga._tensors(node.meta.get("val")):
                args[_storage_key(v)] = nbytes(v)
    written: Dict[Any, int] = {}
    for node in gm.graph.nodes:
        schema = getattr(node.target, "_schema", None)
        if node.op != "call_function" or schema is None:
            continue
        for pos, arg in enumerate(schema.arguments):
            if arg.alias_info is None or not arg.alias_info.is_write:
                continue
            val = node.args[pos] if pos < len(node.args) else \
                node.kwargs.get(arg.name)
            if isinstance(val, torch.fx.Node):
                for v in ga._tensors(val.meta.get("val")):
                    if _storage_key(v) in args:
                        written[_storage_key(v)] = args[_storage_key(v)]
    out_node = next(n for n in gm.graph.nodes if n.op == "output")
    out_nodes: list = []
    torch.fx.node.map_arg(out_node.args, out_nodes.append)
    outs: Dict[Any, int] = {}
    for leaf in out_nodes:
        for v in ga._tensors(leaf.meta.get("val")):
            if _storage_key(v) not in args:
                outs[_storage_key(v)] = nbytes(v)
    lt = graph_lifetimes(gm, nbytes=nbytes)
    temps = peak_live_bytes([TensorUsageRecord(f"t{i}", first, last, size)
                             for i, (_, _, first, last, size)
                             in enumerate(lt["storages"])])
    arg_bytes = sum(args.values())
    return {"argument_bytes": arg_bytes, "output_bytes": sum(outs.values()),
            "temp_bytes": temps, "alias_bytes": sum(written.values()),
            "peak_bytes": arg_bytes + temps}


def roofline(prof: ga.Profile, model_flops: float,
             chips: int = 1) -> Dict[str, Any]:
    """The roofline fields of a record from a profile (H100 constants)."""
    t_comp = sum(f / PEAK_FLOPS[c] for c, f in prof.flops_by_class.items())
    t_mem = prof.hbm_bytes / HBM_BW
    t_coll = prof.collective_bytes / NVLINK_BW
    bound = max(t_comp, t_mem, t_coll)
    return {
        "t_compute_s": t_comp, "t_memory_s": t_mem,
        "t_collective_s": t_coll,
        "dominant": max((t_comp, "compute"), (t_mem, "memory"),
                        (t_coll, "collective"))[1],
        "model_flops": model_flops,
        "graph_flops_global": prof.flops * chips,
        "useful_flops_ratio": (model_flops / (prof.flops * chips)
                               if prof.flops else 0.0),
        "step_time_bound_s": bound,
        "roofline_fraction": (
            min(1.0, (model_flops / chips / PEAK_FLOPS[ga.BF16]) / bound)
            if bound > 0 else 0.0),
    }


def apply_profile(rec: Dict[str, Any], prof: ga.Profile) -> Dict[str, Any]:
    """Write a profile's cost, collectives and roofline into ``rec``."""
    rec["cost"] = {"flops_per_device": prof.flops,
                   "bytes_per_device": prof.hbm_bytes,
                   "flops_by_class": dict(prof.flops_by_class)}
    rec["collectives"] = {"bytes_by_type": dict(prof.collective_by_type),
                          "counts": dict(prof.collective_counts),
                          "total_bytes": prof.collective_bytes}
    rec["roofline"] = roofline(prof, rec["roofline"]["model_flops"],
                               rec["chips"])
    return rec


def run_cell(cell: Cell, ops_path: Optional[str] = None) -> Dict[str, Any]:
    """Trace and analyse one cell; its record (and, given ``ops_path``,
    its op table, gzipped JSON)."""
    t0 = time.time()
    gm, shape_env, _ = trace(cell)
    t1 = time.time()
    table = ga.op_table(gm, shape_env)
    prof = ga.analyze(table)
    mem = memory(gm, shape_env)
    t2 = time.time()
    if ops_path:
        with gzip.open(ops_path, "wt") as f:
            json.dump(table, f)
    rec = {"arch": cell.arch, "shape": cell.shape.name, "mesh": "single",
           "chips": 1, "card": CARD,
           "params": cell.cfg.param_count(),
           "active_params": cell.cfg.active_param_count(),
           "global_batch": cell.shape.global_batch,
           "seq_len": cell.shape.seq_len,
           "trace_s": round(t1 - t0, 2), "analyze_s": round(t2 - t1, 2),
           "ops": len(table), "memory": mem,
           "fits_hbm80": mem["peak_bytes"] < HBM_BYTES,
           "roofline": {"model_flops": cell.model_flops()}}
    return apply_profile(rec, prof)


def cells(archs, shape_names):
    for arch in archs:
        cfg = get_config(arch)
        valid = {s.name for s in shapes_for(cfg)}
        for sn in shape_names:
            if sn in valid:
                yield arch, sn
            else:
                yield arch, sn + ":SKIP"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--force", action="store_true",
                    help="trace cells whose record exists")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shape_names = list(SHAPES) if args.shape == "all" \
        else args.shape.split(",")

    os.makedirs(args.out, exist_ok=True)
    failures = []
    for arch, sn in cells(archs, shape_names):
        if sn.endswith(":SKIP"):
            print(f"SKIP  {arch} {sn.split(':')[0]} single "
                  f"(long-context needs sub-quadratic attention)")
            continue
        tag = f"{arch}_{sn}_single"
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path) and not args.force:
            print(f"CACHED {tag}")
            continue
        print(f"RUN   {tag} ...", flush=True)
        try:
            rec = run_cell(build_cell(arch, sn),
                           ops_path=os.path.join(args.out,
                                                 tag + ".ops.json.gz"))
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            r, m = rec["roofline"], rec["memory"]
            print(f"  ok: trace={rec['trace_s']}s "
                  f"mem_temp={m['temp_bytes'] / 1e9:.2f}GB "
                  f"args={m['argument_bytes'] / 1e9:.2f}GB "
                  f"fits_hbm80={rec['fits_hbm80']} "
                  f"dominant={r['dominant']} "
                  f"frac={r['roofline_fraction']:.3f}", flush=True)
        except Exception as e:   # noqa: BLE001 - report every cell
            failures.append((tag, str(e)))
            print(f"  FAIL {tag}: {e}")
            traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        return 1
    print("\nALL CELLS OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
