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

A record is scaled (:func:`run_scaled`, the CLI's path), as the JAX
package's HLO analysis multiplies a loop body by its trip count: the
port's step is one unrolled graph, so the dry run traces it short and
extends the counts.  The unit of depth is the arch's period (one layer;
the hybrid's ``attn_every`` layers, its shared block after the last of
them), the remainder ``r = L mod period`` kept in every trace; the step
is traced at ``r + k period`` layers for k = 2 and 3 (1 and 2 for a
period of three layers and more) and, for train, at 2 and 3
microbatches of the full cell's rows (one trace where the cell has no
more than that).  Every count of the profile (FLOPs by class,
HBM bytes, collective bytes by type, count and group, the op count) and
the outputs' bytes are bilinear in (periods, microbatches), so the
record adds the traces' with the weights of bilinear extrapolation:
exact where the layers and the microbatches repeat, which
``tests/test_torch_dryrun_scaled.py`` holds for every family against
:func:`run_cell`'s full trace.  The arguments' bytes are the full
cell's fake inputs' (over a mesh, the plan's shards), the aliases those
of them that the traces write: exact.  The temporaries (a live-bytes
peak, not a sum) are extended in depth op by op from the two traces of
the most microbatches (:func:`_temporaries`): equal to the full trace's
in the tests but for the hybrid's one-microbatch train step, 1.3 % over.
``trace_s`` is the traces' total; ``scaled`` lists each trace (layers,
microbatches, weight, seconds), and the op table holds each trace's
rows with its weight.  :func:`trace` and :func:`run_cell` still trace
the whole step.  With torch 2.11 a mesh step's trace depends on what
its process traced before (a 3-layer step traced after a 2-layer one
gains ops and bytes), so the CLI traces every part in a spawned process
of its own (:func:`trace_cells`), as many at once as it has CPUs;
:func:`run_scaled` traces them in its own process, which the tests and
the one-card records do.

The steps: train is ``make_train_step`` (``forward_train``, backward
and the optimizer, ``grad_accum`` microbatches); prefill is
``prefill``; decode is ``decode_step`` over a contiguous cache of the
shape's length.  ``TRAIN_TUNING`` is the JAX package's table, its
sharding knobs (``seq_shard``, ``uneven``, ``kv_dh_shard``) included.

``--mesh`` picks where each cell runs:

- ``card``: one H100 (the global shapes, sized for a pod, reported whole
  and marked where they do not fit; tag ``card``);
- ``single``: the JAX package's one pod, a (16, 16) ``("data",
  "model")`` mesh of 256 GPUs (tag ``pod16x16``); ``multi``: its two
  pods, (2, 16, 16) ``("pod", "data", "model")``, 512 GPUs (tag
  ``pod2x16x16``); ``both``: the two.

Over a mesh the dry run traces ONE rank's program: a ``"fake"`` process
group of the mesh's size (no communication), the arguments placed by
`repro_torch.distributed.plan` and each traced as this rank's shard
(so the graph's arguments are a device's bytes), the step run on
DTensors under ``sharding_rules``.  The graph holds the local ops, the
kernels on local shards, and the ``_c10d_functional`` collectives
DTensor's redistributions issue.  Every number in a mesh record is per
device but ``model_flops`` (the whole step's).  A collective's time is
its operand bytes over the rate of the slowest link its group crosses
(``collective_axes``: the group of each mesh dim, and its rate): NVLink
where the group lies in one 8-GPU node, else the node's InfiniBand.  On
the production meshes every dim crosses nodes (``model``'s 16 ranks
span two 8-GPU nodes), so every collective is charged at InfiniBand's
rate there.

Usage (CPU only, no device memory):

  PYTHONPATH=src python -m repro_torch.launch.dryrun \\
      --arch internlm2-1.8b --shape all [--mesh card|single|multi|both] \\
      [--out build/dryrun]

Each cell writes ``<arch>_<shape>_<tag>.json`` (the record) and
``.ops.json.gz`` (its op table, which `repro_torch.launch.reanalyze`
re-reads).
"""
from __future__ import annotations

import argparse
import dataclasses
import gzip
import json
import os
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple, Union

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
#: a GPU's rate across nodes: one ConnectX-7 NDR 400 Gb/s InfiniBand port
#: a GPU (NVIDIA DGX H100 data sheet: 8 ports for 8 GPUs), 50 GB/s
IB_BW = 50e9
#: GPUs a node (one NVLink domain: the DGX H100's NVSwitch fabric)
NODE_GPUS = 8
#: --mesh -> (mesh shape, dim names, record tag); ``card`` is one GPU
MESHES = {"card": (None, None, "card"),
          "single": ((16, 16), ("data", "model"), "pod16x16"),
          "multi": ((2, 16, 16), ("pod", "data", "model"), "pod2x16x16")}

# Per-arch training knobs (the JAX package's table).  grad_accum splits
# the global batch into microbatches; seq_shard shards the residual
# stream over 'model' (read over a mesh only, for train); kv_dh_shard and
# uneven are sharding-rule overrides (a mesh only).
TRAIN_TUNING: Dict[str, Dict[str, Any]] = {
    # kv_dh_shard off: at model 16 the 405B's decode caches shard their
    # sequence instead of the head dim
    "llama3-405b": dict(grad_accum=16, seq_shard=True,
                        optimizer="adafactor", grad_dtype="bfloat16",
                        param_dtype="bfloat16", kv_dh_shard=False),
    "qwen3-32b": dict(grad_accum=16, seq_shard=False,
                      optimizer="adafactor"),
    "starcoder2-15b": dict(grad_accum=8, seq_shard=True,
                           optimizer="adafactor"),
    "phi3.5-moe-42b-a6.6b": dict(grad_accum=8, seq_shard=False,
                                 optimizer="adafactor"),
    # uneven: the 28-head attention keeps its head shard on model 16
    "qwen2-vl-7b": dict(grad_accum=8, seq_shard=False, optimizer="adamw",
                        uneven=True),
    "falcon-mamba-7b": dict(grad_accum=8, seq_shard=False,
                            optimizer="adamw"),
    "olmoe-1b-7b": dict(grad_accum=2, seq_shard=False, optimizer="adamw"),
    "internlm2-1.8b": dict(grad_accum=2, seq_shard=False,
                           optimizer="adamw"),
    # the SSD block-matmul form of Mamba-2
    "zamba2-1.2b": dict(grad_accum=4, seq_shard=False, optimizer="adamw",
                        mamba_ssd=True),
    "musicgen-large": dict(grad_accum=4, seq_shard=False,
                           optimizer="adamw"),
}


def runtime_for(shape: ShapeConfig, arch: str, mesh: bool = False):
    """The JAX package's ``_runtime_for``; ``seq_shard`` only over a
    ``mesh`` (one card has no dim to shard the sequence over)."""
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
        seq_shard=mesh and bool(tun.get("seq_shard", False)) and
        shape.kind == "train",
        unroll_decode=bool(tun.get("unroll_decode",
                                   shape.kind == "decode")))


def rules_for(arch: str, mesh):
    """The sharding rules of ``arch`` on ``mesh``: the defaults with
    ``TRAIN_TUNING``'s ``kv_dh_shard`` and ``uneven``."""
    from repro_torch.distributed.sharding import make_rules
    tun = TRAIN_TUNING.get(arch, {})
    overrides = ({"kv_dh_shard": bool(tun["kv_dh_shard"])}
                 if "kv_dh_shard" in tun else None)
    return make_rules(mesh, overrides=overrides,
                      uneven=bool(tun.get("uneven", False)))


def production_mesh(kind: str):
    """The ``kind`` ("single" or "multi") mesh over a ``"fake"`` process
    group of its size, set up here (any other default group is torn down
    first): one rank's view, no communication."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import make_production_mesh
    shape = MESHES[kind][0]
    world = 1
    for n in shape:
        world *= n
    if dist.is_initialized():
        if dist.get_world_size() == world and \
                dist.get_backend() == "fake":
            return make_production_mesh(multi_pod=kind == "multi",
                                        device_type="cpu")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    return make_production_mesh(multi_pod=kind == "multi",
                                device_type="cpu")


def collective_axes(mesh) -> Dict[str, Dict[str, Any]]:
    """Each mesh dim's process group (rank 0's): its name, the dim, and
    the rate a collective over it is charged at (NVLink where its ranks
    lie in one node of ``NODE_GPUS``, else InfiniBand)."""
    out = {}
    ranks = mesh.mesh
    for i, name in enumerate(mesh.mesh_dim_names):
        index = [0] * ranks.dim()
        index[i] = slice(None)
        members = ranks[tuple(index)].tolist()
        nodes = {r // NODE_GPUS for r in members}
        out[mesh.get_group(i).group_name] = {
            "dim": name, "size": len(members),
            "link": "nvlink" if len(nodes) == 1 else "infiniband",
            "rate": NVLINK_BW if len(nodes) == 1 else IB_BW}
    return out


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
    #: ``specs(rules, *args)``: the arguments' spec trees over a mesh
    specs: Optional[Callable[..., Tuple]] = None
    #: the runtime given to :func:`build_cell` (None: :func:`runtime_for`)
    rt: Any = None
    #: microbatches of a train step (1 for prefill and decode)
    grad_accum: int = 1

    def model_flops(self) -> float:
        n_active = self.cfg.active_param_count()
        b, s = self.shape.global_batch, self.shape.seq_len
        if self.shape.kind == "train":
            return 6.0 * n_active * b * s
        if self.shape.kind == "prefill":
            return 2.0 * n_active * b * s
        return 2.0 * n_active * b


def build_cell(arch: str, shape: Union[str, ShapeConfig],
               cfg: Optional[ModelConfig] = None, rt=None,
               rules=None, grad_accum: Optional[int] = None) -> Cell:
    """The cell's step at full width: ``SHAPES[shape]``, or any
    ``ShapeConfig`` (the card's own shapes in `chip_smoke.py`); ``cfg``
    in place of the arch's full config (a test's reduced one), ``rt`` in
    place of :func:`runtime_for`'s (the card's train step runs the
    default ``ModelRuntime``).  With ``rules`` (a mesh's) the cell is one
    rank's: ``grad_accum`` keeps a row a data shard per microbatch, as
    the JAX package's does, and :attr:`Cell.specs` places its
    arguments.  ``grad_accum`` given: a train step of that many
    microbatches, in place of that rule (a scaled record's traces)."""
    given_rt = rt
    from repro_torch.distributed import plan as dplan
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
    rt = rt if rt is not None else runtime_for(shape, arch,
                                               mesh=rules is not None)
    b, s = shape.global_batch, shape.seq_len
    dp_ways = 1
    if rules is not None:
        from repro_torch.distributed.sharding import axes_size
        dp_ways = axes_size(rules.mesh, rules.physical("batch"))

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
        ga_steps = grad_accum if grad_accum is not None else \
            max(1, min(int(tun.get("grad_accum", 1)), b // dp_ways))
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
        return Cell(arch, shape, cfg, step, inputs, lambda r, st, bt: (
            dplan.state_specs(r, st), dplan.batch_specs(r, bt)),
            given_rt, ga_steps)

    def params_on(device, seed):
        return init_params(cfg, seed=seed, device=device,
                           param_dtype="bfloat16")

    if shape.kind == "prefill":
        from repro_torch.models import prefill

        def pf(params, batch):
            return prefill(cfg, params, batch["tokens"], max_len=s, rt=rt,
                           embeds_override=batch.get("embeds_override"))

        def inputs(device="cpu", seed=0):
            return (params_on(device, seed),
                    batch_like(mio.prefill_input_specs(cfg, shape), device,
                               seed + 1))
        return Cell(arch, shape, cfg, pf, inputs, lambda r, p, bt: (
            dplan.param_specs(r, p), dplan.batch_specs(r, bt)), given_rt)

    def serve_step(params, cache, tokens_t):
        return decode_step(cfg, params, cache, tokens_t, rt=rt)

    def inputs(device="cpu", seed=0):
        # bf16, as the JAX package's decode_input_specs (its cache_specs'
        # default) builds the cache it traces decode over
        cache = make_cache(cfg, b, s, torch.bfloat16, device=device)
        cache["len"].fill_(s - 1)           # the step writes the last slot
        tok = batch_like({"t": mio.decode_input_specs(cfg, shape)[
            "tokens_t"]}, device, seed + 1)["t"]
        return params_on(device, seed), cache, tok
    return Cell(arch, shape, cfg, serve_step, inputs, lambda r, p, c, t: (
        (dplan.param_specs(r, p),) + dplan.decode_specs(r, cfg, c, t)),
        given_rt)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    return fn(tree, other)


def fake_arguments(cell: Cell, mode, seed: int = 0, rules=None):
    """``(arguments, placed)``: the cell's arguments made under ``mode``
    (fake: nothing computed or allocated); with ``rules`` this rank's
    shards of them, and ``placed`` the DTensors they are shards of
    (else None)."""
    from repro_torch.distributed import plan as dplan
    with mode:
        args = cell.inputs("cpu", seed)
    if rules is None:
        return args, None
    with mode:
        placed = [dplan.distribute(a, dplan.to_shardings(rules, sp))
                  for a, sp in zip(args, cell.specs(rules, *args))]
    return tuple(dplan.local(p) for p in placed), placed


def trace(cell: Cell, seed: int = 0, rules=None):
    """``(graph, shape_env, arguments)``: the cell's step traced under a
    fake mode with each kernel wrapper one node, profiler ranges
    removed.  With ``rules`` it is one rank's step over their mesh: the
    arguments (this rank's shards) are the graph's inputs, wrapped as
    DTensors inside the traced function, whose outputs are this rank's
    shards again."""
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.distributed.sharding import (from_local, is_dtensor,
                                                  sharding_rules)
    from repro_torch.kernels.traced import traced_kernels
    mode = fake_mode()
    args, placed = fake_arguments(cell, mode, seed, rules)
    fn = cell.fn
    if rules is not None:
        def fn(*local_args):
            wrapped = [_zip_map(lambda t, d: from_local(
                t, d.device_mesh, d.placements, d.shape), la, pl)
                for la, pl in zip(local_args, placed)]
            with sharding_rules(rules):
                out = cell.fn(*wrapped)
            return _tree_map(lambda t: t.to_local() if is_dtensor(t)
                             else t, out)
    with traced_kernels(), mode:
        gm = make_fx(fn)(*args)
    if rules is not None:
        # DTensor's wrapping may trace global-shape buffers that nothing
        # reads (torch 2.11): not a device's memory
        gm.graph.eliminate_dead_code()
    for node in reversed(list(gm.graph.nodes)):
        if node.op == "call_function" and \
                str(node.target).startswith("profiler.") and not node.users:
            gm.graph.erase_node(node)
    return gm, mode.shape_env, args


def _written_storages(gm: torch.fx.GraphModule) -> set:
    """The storages that the graph's ops write in place (their schemas'
    write annotations)."""
    from repro_torch.core.usage_records import _storage_key
    written = set()
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
                written.update(_storage_key(v)
                               for v in ga._tensors(val.meta.get("val")))
    return written


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
    written = {k: args[k] for k in _written_storages(gm) if k in args}
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


def roofline(prof: ga.Profile, model_flops: float, chips: int = 1,
             axes: Optional[Dict[str, Dict[str, Any]]] = None
             ) -> Dict[str, Any]:
    """The roofline fields of a record from a profile (H100 constants):
    a collective over a group of ``axes`` at that group's rate; one over
    another group (DTensor's flattened dims) at the slowest of the mesh's
    rates; without a mesh at NVLink's."""
    t_comp = sum(f / PEAK_FLOPS[c] for c, f in prof.flops_by_class.items())
    t_mem = prof.hbm_bytes / HBM_BW
    axes = axes or {}
    slowest = min((a["rate"] for a in axes.values()), default=NVLINK_BW)
    t_coll = sum(b / axes.get(g, {}).get("rate", slowest)
                 for g, b in prof.collective_by_group.items())
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
    axes = rec.get("collective_axes")
    if axes:
        by_dim: Dict[str, float] = {}
        for g, b in prof.collective_by_group.items():
            key = axes[g]["dim"] if g in axes else "flattened"
            by_dim[key] = by_dim.get(key, 0.0) + b
        rec["collectives"]["bytes_by_dim"] = by_dim
    rec["roofline"] = roofline(prof, rec["roofline"]["model_flops"],
                               rec["chips"], axes)
    return rec


def run_cell(cell: Cell, ops_path: Optional[str] = None, rules=None,
             mesh_tag: str = "card") -> Dict[str, Any]:
    """Trace and analyse one cell, on one card or, with ``rules``, as one
    rank of their mesh (``mesh_tag`` names it); its record (and, given
    ``ops_path``, its op table, gzipped JSON)."""
    t0 = time.time()
    gm, shape_env, _ = trace(cell, rules=rules)
    t1 = time.time()
    table = ga.op_table(gm, shape_env)
    prof = ga.analyze(table)
    mem = memory(gm, shape_env)
    t2 = time.time()
    if ops_path:
        with gzip.open(ops_path, "wt") as f:
            json.dump(table, f)
    return apply_profile(_record(cell, rules, mesh_tag, t1 - t0, t2 - t1,
                                 len(table), mem), prof)


def _record(cell: Cell, rules, mesh_tag: str, trace_s: float,
            analyze_s: float, ops: int, mem: Dict[str, int]
            ) -> Dict[str, Any]:
    """A record's fields but its profile's (:func:`apply_profile`)."""
    chips = 1 if rules is None else rules.mesh.size()
    rec = {"arch": cell.arch, "shape": cell.shape.name,
           "mesh": mesh_tag, "chips": chips, "card": CARD,
           "params": cell.cfg.param_count(),
           "active_params": cell.cfg.active_param_count(),
           "global_batch": cell.shape.global_batch,
           "seq_len": cell.shape.seq_len,
           "trace_s": round(trace_s, 2), "analyze_s": round(analyze_s, 2),
           "ops": ops, "memory": mem,
           "fits_hbm80": mem["peak_bytes"] < HBM_BYTES,
           "roofline": {"model_flops": cell.model_flops()}}
    if rules is not None:
        rec["mesh_shape"] = dict(zip(rules.mesh.mesh_dim_names,
                                     rules.mesh.shape))
        rec["collective_axes"] = collective_axes(rules.mesh)
        rec["seq_shard"] = bool(TRAIN_TUNING.get(cell.arch, {}).get(
            "seq_shard")) and cell.shape.kind == "train"
    return rec


#: the periods of layers that a scaled record's traces take where the
#: cell has more: two and three, since the first layer may differ from
#: the others (nothing upstream needs its input's gradient) and one
#: period's temporaries are not yet on the line the deeper ones follow
#: (a period of two layers: 2 % off)
SCALE_PERIODS = (2, 3)
#: the periods for a period of ``LONG_PERIOD`` layers and more (the
#: hybrid's six): one and two, its first period holding layers after the
#: first that repeat; exact in the tests at periods of three to six
LONG_PERIOD, LONG_PERIOD_SCALE = 3, (1, 2)
#: the microbatches of a train step's traces, where the cell has more
#: (2 and 3: one microbatch takes another branch, with no accumulation)
SCALE_MICROBATCHES = (2, 3)


def layer_period(cfg: ModelConfig) -> Tuple[int, int]:
    """``(period, remainder)``: the layers that repeat as one unit (the
    hybrid's ``attn_every``, its shared block running after the last of
    them; 1 otherwise) and ``num_layers`` mod that period."""
    p = cfg.attn_every if cfg.family == "hybrid" and cfg.attn_every else 1
    return p, cfg.num_layers % p


def scale_periods(period: int) -> Tuple[int, int]:
    """The periods a scaled record's two depths take, for ``period``."""
    return LONG_PERIOD_SCALE if period >= LONG_PERIOD else SCALE_PERIODS


def _extend(full: int, samples: Tuple[int, int]) -> List[Tuple[int, int]]:
    """``(count, weight)`` of each trace along one count: a quantity
    linear in the count, taken at ``samples`` (two consecutive counts,
    so the weights are integers and the float sums stay exact), extended
    to ``full`` (one weight negative); ``full`` alone with weight 1 where
    it is no larger than the samples."""
    if full <= samples[-1]:
        return [(full, 1)]
    a, b = samples
    return [(a, b - full), (b, full - a)]


def live_bytes(gm: torch.fx.GraphModule, shape_env
               ) -> Tuple[List[str], List[int]]:
    """Each compute op's name, and the bytes the step's storages hold
    live at it (:func:`memory`'s temporaries are the largest)."""
    from repro_torch.core.usage_records import graph_lifetimes
    lt = graph_lifetimes(gm, nbytes=lambda t: ga._concrete(
        t.untyped_storage().nbytes(), shape_env))
    delta = [0] * (lt["n_ops"] + 2)
    for _, _, first, last, size in lt["storages"]:
        delta[first] += size
        delta[last + 1] -= size
    live, acc = [], 0
    for d in delta[:lt["n_ops"]]:
        acc += d
        live.append(acc)
    return [str(n.target) for n in lt["nodes"]], live


def _align(a: List[str], b: List[str], reach: int = 4096
           ) -> List[Tuple[int, int]]:
    """``(i, j)``: op ``i`` of ``a`` and op ``j`` of ``b``, the same op
    at the same place, where ``b`` is ``a`` with blocks of ops inserted
    (one more period of layers in each run of them): both are walked
    from the start, and at a mismatch ``b`` skips the ops after which
    ``a``'s next ops follow longest (up to ``reach``), the fewest of
    those that tie."""
    import numpy as np
    codes: Dict[str, int] = {}
    xa = np.array([codes.setdefault(n, len(codes)) for n in a])
    xb = np.array([codes.setdefault(n, len(codes)) for n in b])

    def run(i, j):
        n = min(reach, len(xa) - i, len(xb) - j)
        diff = np.flatnonzero(xa[i:i + n] != xb[j:j + n])
        return int(diff[0]) if diff.size else n

    pairs = []
    i = j = 0
    while i < len(xa) and j < len(xb):
        n = run(i, j)
        pairs.extend((i + k, j + k) for k in range(n))
        i, j = i + n, j + n
        if i >= len(xa) or j >= len(xb) or n == reach:
            continue
        skips = np.flatnonzero(xb[j + 1:] == xa[i]) + 1
        best = max(skips, key=lambda d: (run(i, j + d), -d), default=None)
        if best is None:
            break
        j += int(best)
    return pairs


def _temporaries(curves: List[Tuple[Any, List[str], List[int]]]) -> int:
    """The temporaries at full depth from the live bytes of two traces
    ``(weight, op names, live bytes)`` (or of one, the full depth).  The
    ops of the shorter are matched with the longer's from the start and
    from the end (:func:`_align`): a run of periods repeated k times in
    the one and k + 1 in the other has its first k matched from the
    start and its last k from the end.  Each op of the longer trace is
    extended in depth from its match, with the traces' weights; where it
    has a match each way and they differ (a period inside a run, matched
    with the shorter trace's first and with its last, one of which may
    differ from the others: the first layer's backward computes no
    input gradient), from the match that extends it less.  The largest
    of these."""
    if len(curves) == 1:
        return max(curves[0][2], default=0)
    (wa, na, la), (wb, nb, lb) = curves
    front = {j: i for i, j in _align(na, nb)}
    back = {len(nb) - 1 - j: len(na) - 1 - i
            for i, j in _align(na[::-1], nb[::-1])}
    best = 0
    for j, live in enumerate(lb):
        ext = [wa * la[i] + wb * live for i in {front.get(j), back.get(j)}
               if i is not None]
        if ext:
            best = max(best, min(ext))
    return int(best)


def _input_flags(gm: torch.fx.GraphModule) -> List[bool]:
    """For each placeholder, in order: whether the graph writes its
    storage in place."""
    from repro_torch.core.usage_records import _storage_key
    written = _written_storages(gm)
    return [any(_storage_key(v) in written
                for v in ga._tensors(n.meta.get("val")))
            for n in gm.graph.nodes if n.op == "placeholder"]


def _storage_bytes(tensors, pick=None) -> int:
    """The bytes of the distinct storages of ``tensors`` (those where
    ``pick`` is true)."""
    from repro_torch.core.usage_records import _storage_key
    seen: Dict[Any, int] = {}
    for i, t in enumerate(tensors):
        if isinstance(t, torch.Tensor) and (pick is None or pick[i]):
            seen[_storage_key(t)] = int(t.untyped_storage().nbytes())
    return sum(seen.values())


def scaled_plan(cell: Cell) -> List[Tuple[int, Optional[int], Any, Any]]:
    """``(layers, microbatches, depth weight, microbatch weight)`` of
    each trace of the cell's scaled record: ``r + k p`` layers
    (:func:`layer_period`) for two ``k`` of :data:`SCALE_PERIODS` (of
    :data:`LONG_PERIOD_SCALE` for a long period) and,
    for a train step, two microbatch counts of
    :data:`SCALE_MICROBATCHES` (``None`` for prefill and decode); the
    weights are bilinear extrapolation's to the full depth and
    microbatches (a trace's weight is their product)."""
    p, r = layer_period(cell.cfg)
    depth = _extend((cell.cfg.num_layers - r) // p, scale_periods(p))
    micro = [(None, 1)] if cell.shape.kind != "train" else \
        _extend(cell.grad_accum, SCALE_MICROBATCHES)
    return [(r + k * p, m, wk, wm) for k, wk in depth for m, wm in micro]


def trace_part(cell: Cell, layers: int, microbatches: Optional[int],
               rules=None, curve: bool = False) -> Dict[str, Any]:
    """One trace of a scaled record: the cell cut to ``layers`` and, for
    train, run over ``microbatches`` microbatches of the full cell's
    rows.  Its op table and profile, the bytes of its outputs and
    temporaries, which of its inputs it writes, its seconds and, with
    ``curve``, its ops' live bytes (:func:`live_bytes`).  Picklable: a
    part may be traced in a process of its own."""
    cfg = dataclasses.replace(cell.cfg, num_layers=layers)
    shape = cell.shape if microbatches is None else dataclasses.replace(
        cell.shape, global_batch=microbatches * (
            cell.shape.global_batch // cell.grad_accum))
    part = build_cell(cell.arch, shape, cfg=cfg, rt=cell.rt, rules=rules,
                      grad_accum=microbatches)
    t0 = time.time()
    gm, shape_env, _ = trace(part, rules=rules)
    t1 = time.time()
    out = {"layers": layers, "microbatches": microbatches,
           "table": ga.op_table(gm, shape_env),
           "memory": memory(gm, shape_env), "written": _input_flags(gm),
           "curve": live_bytes(gm, shape_env) if curve else None,
           "trace_s": t1 - t0}
    out["profile"] = ga.analyze(out["table"])
    out["analyze_s"] = time.time() - t1
    return out


def run_scaled(cell: Cell, ops_path: Optional[str] = None, rules=None,
               mesh_tag: str = "card") -> Dict[str, Any]:
    """The record of :func:`run_cell`, built from the short traces of
    :func:`scaled_plan`, traced here one after another
    (:func:`combine_parts`).  The CLI traces each in a process of its
    own (:func:`trace_cells`)."""
    plan = scaled_plan(cell)
    most = plan[-1][1]
    return combine_parts(cell, [trace_part(cell, layers, m, rules,
                                           curve=m == most)
                                for layers, m, _, _ in plan],
                         ops_path, rules, mesh_tag)


def combine_parts(cell: Cell, parts: List[Dict[str, Any]],
                  ops_path: Optional[str] = None, rules=None,
                  mesh_tag: str = "card") -> Dict[str, Any]:
    """The cell's scaled record from ``parts``, the traces of
    :func:`scaled_plan` in its order as :func:`trace_part` returns them,
    their profiles added with the plan's weights.  The arguments come
    from the full cell's fake inputs (with ``rules``, the plan's
    shards), the aliases are those of them the traces write, the outputs
    are extended like the profiles, and the temporaries in depth from
    the traces of the most microbatches (:func:`_temporaries`).  The op
    table (``ops_path``) holds each trace's rows with its weight."""
    from torch.utils._pytree import tree_leaves
    plan = scaled_plan(cell)
    most = plan[-1][1]
    prof = ga.Profile()
    ops, outputs, curves, tables, traces = 0, 0, [], [], []
    flags = None
    t_trace = t_analyze = 0.0
    for (layers, m, wk, wm), part in zip(plan, parts, strict=True):
        if (part["layers"], part["microbatches"]) != (layers, m):
            raise AssertionError(f"{cell.arch} {cell.shape.name}: part "
                                 f"{part['layers']}, {part['microbatches']}"
                                 f" in place of {layers}, {m}")
        w = wk * wm
        prof.add(part["profile"], w)
        ops += w * len(part["table"])
        outputs += w * part["memory"]["output_bytes"]
        if m == most:
            curves.append((wk,) + tuple(part["curve"]))
        flags = flags or part["written"]
        t_trace += part["trace_s"]
        t_analyze += part["analyze_s"]
        info = {"layers": layers, "microbatches": m, "weight": w,
                "trace_s": round(part["trace_s"], 2),
                "ops": len(part["table"]),
                "temp_bytes": part["memory"]["temp_bytes"]}
        traces.append(info)
        tables.append(dict(info, table=part["table"]))
    args, _ = fake_arguments(cell, fake_mode(), rules=rules)
    leaves = tree_leaves(args)
    if len(leaves) != len(flags):
        raise AssertionError(f"{cell.arch} {cell.shape.name}: "
                             f"{len(leaves)} arguments, the traces "
                             f"{len(flags)}")
    arg_bytes = _storage_bytes(leaves)
    temps = _temporaries(curves)
    mem = {"argument_bytes": arg_bytes, "output_bytes": outputs,
           "temp_bytes": temps, "alias_bytes": _storage_bytes(leaves, flags),
           "peak_bytes": arg_bytes + temps}
    p, r = layer_period(cell.cfg)
    scaled = {"period": p, "remainder": r,
              "periods": (cell.cfg.num_layers - r) // p,
              "microbatches": cell.grad_accum,
              "temp_bytes_from_microbatches": most, "traces": traces}
    if ops_path:
        with gzip.open(ops_path, "wt") as f:
            json.dump({"scaled": scaled, "parts": tables}, f)
    rec = _record(cell, rules, mesh_tag, t_trace, t_analyze, ops, mem)
    rec["scaled"] = scaled
    return apply_profile(rec, prof)


def _cell_rules(arch: str, kind: str):
    """The rules of ``arch`` on the CLI's ``kind`` of mesh (None: one
    card)."""
    return None if kind == "card" else rules_for(arch,
                                                 production_mesh(kind))


def _trace_cli_part(arch: str, shape: str, kind: str, layers: int,
                    microbatches: Optional[int]) -> Dict[str, Any]:
    """One trace of a CLI cell's scaled record (:func:`trace_part`), in
    a process of its own."""
    rules = _cell_rules(arch, kind)
    cell = build_cell(arch, shape, rules=rules)
    most = scaled_plan(cell)[-1][1]
    return trace_part(cell, layers, microbatches, rules,
                      curve=microbatches == most)


def trace_cells(todo: List[Tuple[str, str]], kind: str):
    """The traces of each ``(arch, shape)`` cell of ``todo`` on the
    ``kind`` mesh, in :func:`scaled_plan`'s order (or the exception that
    one raised), yielded cell by cell in ``todo``'s order: every trace
    in a spawned process of its own, as many at once as this process
    has CPUs, the longest (layers times microbatches) first.  A process
    of its own, because with torch 2.11 a trace over a mesh depends on
    what its process traced before (a 3-layer step traced after a
    2-layer one gains ops and bytes)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    plans = []
    for arch, sn in todo:
        try:
            plans.append(scaled_plan(build_cell(
                arch, sn, rules=_cell_rules(arch, kind))))
        except Exception as e:   # noqa: BLE001 - report every cell
            plans.append(e)
    jobs = sorted(((layers * (m or 1), i, layers, m)
                   for i, plan in enumerate(plans)
                   if not isinstance(plan, Exception)
                   for layers, m, _, _ in plan), reverse=True)
    workers = max(1, min(len(jobs), len(os.sched_getaffinity(0))))
    with ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"),
            max_tasks_per_child=1) as pool:
        futures = {(i, layers, m): pool.submit(
            _trace_cli_part, *todo[i], kind, layers, m)
            for _, i, layers, m in jobs}
        for i, plan in enumerate(plans):
            if isinstance(plan, Exception):
                yield plan
                continue
            try:
                yield [futures.pop((i, layers, m)).result()
                       for layers, m, _, _ in plan]
            except Exception as e:   # noqa: BLE001 - report every cell
                yield e


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
    ap.add_argument("--mesh", default="card",
                    choices=["card", "single", "multi", "both"],
                    help="one card, the (16, 16) pod, the (2, 16, 16) two "
                    "pods, or both pods")
    ap.add_argument("--force", action="store_true",
                    help="trace cells whose record exists")
    args = ap.parse_args(argv)

    archs = list(ARCH_IDS) if args.arch == "all" else args.arch.split(",")
    shape_names = list(SHAPES) if args.shape == "all" \
        else args.shape.split(",")

    kinds = {"both": ["single", "multi"]}.get(args.mesh, [args.mesh])
    os.makedirs(args.out, exist_ok=True)
    failures = []
    t0 = time.time()
    for kind in kinds:
        mesh_tag = MESHES[kind][2]
        todo = []
        for arch, sn in cells(archs, shape_names):
            if sn.endswith(":SKIP"):
                print(f"SKIP  {arch} {sn.split(':')[0]} {mesh_tag} "
                      f"(long-context needs sub-quadratic attention)")
                continue
            tag = f"{arch}_{sn}_{mesh_tag}"
            if os.path.exists(os.path.join(args.out, tag + ".json")) and \
                    not args.force:
                print(f"CACHED {tag}")
                continue
            todo.append((arch, sn))
        print(f"TRACE {len(todo)} cells on {mesh_tag}, each trace in a "
              f"process of its own", flush=True)
        for (arch, sn), parts in zip(todo, trace_cells(todo, kind)):
            tag = f"{arch}_{sn}_{mesh_tag}"
            print(f"RUN   {tag} ...", flush=True)
            try:
                if isinstance(parts, Exception):
                    raise parts
                rules = _cell_rules(arch, kind)
                rec = combine_parts(
                    build_cell(arch, sn, rules=rules), parts,
                    ops_path=os.path.join(args.out, tag + ".ops.json.gz"),
                    rules=rules, mesh_tag=mesh_tag)
                with open(os.path.join(args.out, tag + ".json"), "w") as f:
                    json.dump(rec, f, indent=1)
                r, m = rec["roofline"], rec["memory"]
                print(f"  ok: done_at={time.time() - t0:.2f}s "
                      f"trace={rec['trace_s']}s "
                      f"mem_temp={m['temp_bytes'] / 1e9:.2f}GB "
                      f"args={m['argument_bytes'] / 1e9:.2f}GB "
                      f"fits_hbm80={rec['fits_hbm80']} "
                      f"dominant={r['dominant']} "
                      f"frac={r['roofline_fraction']:.3f}", flush=True)
            except Exception as e:   # noqa: BLE001 - report every cell
                failures.append((tag, str(e)))
                print(f"  FAIL {tag}: {e}")
                traceback.print_exception(e)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for t, e in failures:
            print(" ", t, e[:200])
        return 1
    print("\nALL CELLS OK")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
