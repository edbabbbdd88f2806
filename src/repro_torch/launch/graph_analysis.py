"""Static analysis of an ATen-level FX graph: the port's counterpart of
`repro.launch.hlo_analysis`.

The JAX package parses XLA's optimized HLO text.  The port reads the
graph that ``make_fx`` records under a ``FakeTensorMode`` (shapes, dtypes
and storages, no data and no device memory), with each kernel wrapper of
`repro_torch.kernels.ops` one ``repro_torch::<name>`` node
(`repro_torch.kernels.traced`).  For each compute node it counts

  flops        every op that ``torch.utils.flop_counter`` has a formula
               for: ``mm``, ``bmm``, ``addmm``, ``baddbmm``, convolution
               (and attention ops the port does not call), plus the
               port's kernels, whose formulas this module registers
               (:func:`register_flop_formulas`), so that
               ``FlopCounterMode`` on a real step and this analysis of its
               graph count the same;
  hbm_bytes    operand plus result bytes of each op: a view moves nothing,
               a gather reads what it returns, an in-place update (an
               ``index_put_`` into a cache) moves its update region, and
               a kernel node moves what ``chip_smoke.py``'s bound counts
               for it (each input read once, each output written once);
  collectives  operand bytes of each c10d functional collective, by type
               and by process group (the group's name, the last string
               argument of the op: the dry run maps it to a mesh dim).
               A step traced over a DTensor mesh
               (`repro_torch.launch.dryrun`, ``--mesh``) is one rank's
               program: its collectives are the ``_c10d_functional``
               ops DTensor's redistributions record.

Each kernel's formula is the one its ``chip_smoke.py`` check uses for its
bound, on shapes alone: a trace has no data, so a length that the data
decides counts at its full extent (every row of a causal flash call at
its full Sq x Sk triangle, a decode row at the cache's capacity, a
packed call as one segment filling its pack: an upper bound).  A size
that an op's output takes from the data (the embedding gradient's unique
rows) counts at the upper bound the trace's shape environment gives it.

The port's forward is an unrolled Python loop over layers, so a graph
holds each layer's ops: there is no while loop whose body must be
multiplied by a trip count (the HLO analysis's ``_trip_count``), and L
stacked layers cost L times one by construction.

A graph is summarised as an op table (:func:`op_table`: each node's op,
its arguments' shapes and dtypes, its outputs'), which is JSON and is
what `repro_torch.launch.reanalyze` re-reads; :func:`analyze` and
:func:`top_contributors` take a GraphModule or such a table.
"""
from __future__ import annotations

import math
import operator
import threading
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Sequence, Tuple, Union

import torch

#: flop classes: the peak each op's flops run at on the card (bf16 on the
#: tensor cores; f32 outside them, TF32 off)
BF16, F32 = "bf16", "f32"

_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
                "all_gather_into_tensor": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "all_to_all_single": "all-to-all"}
_COLLECTIVE_NAMESPACES = ("_c10d_functional", "c10d_functional")
#: reads what they return (plus the indices), not the whole table
_GATHERS = ("aten::index.Tensor", "aten::embedding", "aten::index_select",
            "aten::gather")
#: write an update region in place: the region read and written
_UPDATES = {"aten::index_put_": 2, "aten::index_put": 2,
            "aten::index_copy_": 3, "aten::index_copy": 3,
            "aten::scatter_.src": 3, "aten::scatter.src": 3}

Graph = Union[torch.fx.GraphModule, Sequence[dict]]


@dataclass
class Profile:
    flops: float = 0.0
    hbm_bytes: float = 0.0
    collective_bytes: float = 0.0
    collective_by_type: Dict[str, float] = field(default_factory=dict)
    collective_counts: Dict[str, float] = field(default_factory=dict)
    #: collective operand bytes by process group name
    collective_by_group: Dict[str, float] = field(default_factory=dict)
    #: ``flops`` by class (:data:`BF16`, :data:`F32`)
    flops_by_class: Dict[str, float] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# The port's kernels: FLOP and byte formulas, on shapes alone
# ---------------------------------------------------------------------------

def _numel(t) -> int:
    return math.prod(t.shape) if t is not None else 0


def _nbytes(t) -> int:
    return _numel(t) * t.element_size() if t is not None else 0


def _rows_cols(x) -> Tuple[int, int]:
    c = x.shape[-1]
    return _numel(x) // c, c


def _flash_pairs(sq: int, sk: int, causal: bool) -> int:
    """Visible (query, key) pairs of one row and head at full length: the
    queries are the last ``sq`` of ``sk`` positions (suffix alignment)."""
    if not causal:
        return sq * sk
    return sq * (sk - sq) + sq * (sq + 1) // 2


def _softmax_cost(x, lengths, scale, out):
    r, c = _rows_cols(x)
    return 5.0 * r * c, _nbytes(x) + _nbytes(out) + 4 * r * (
        lengths is not None), F32


def _norm_cost(x, gamma, beta, bias, residual, eps, out):
    r, c = _rows_cols(x)
    outs = out if isinstance(out, (tuple, list)) else (out,)
    flops = (6.0 if residual is not None else 5.0) * r * c
    nbytes = _nbytes(x) + _nbytes(residual) + sum(_nbytes(o) for o in outs) \
        + _nbytes(gamma) + _nbytes(beta) + _nbytes(bias)
    return flops, nbytes, F32


def _sample_cost(logits, temperature, top_k, top_p, gumbel, out):
    b, v = logits.shape
    return 2.0 * b * v, sum(_nbytes(t) for t in (
        logits, temperature, top_k, top_p, gumbel, out)), F32


def _flash_cost(q, k, v, lengths, causal, scale, out):
    b, h, sq, dh = q.shape
    sk = k.shape[2]
    flops = 4.0 * dh * h * b * _flash_pairs(sq, sk, causal)
    nbytes = sum(_nbytes(t) for t in (q, k, v, out, lengths))
    return flops, nbytes, BF16 if q.dtype == torch.bfloat16 else F32


def _packed_cost(q, k, v, q_seg, k_seg, q_pos, k_pos, scale, plan, out):
    _, h, sq, dh = q.shape
    sk = k.shape[2]
    flops = 4.0 * dh * h * _flash_pairs(sq, sk, True)
    nbytes = sum(_nbytes(t) for t in (q, k, v, q_seg, k_seg, q_pos, k_pos,
                                      plan, out))
    return flops, nbytes, BF16 if q.dtype == torch.bfloat16 else F32


def _plan_cost(q_seg, k_seg, q_pos, k_pos, out):
    return 0.0, sum(_nbytes(t) for t in (q_seg, k_seg, q_pos, k_pos,
                                         out)), F32


def _decode_cost(q, k, v, lengths, scale, out):
    b, h, dh = q.shape
    s = k.shape[2]
    return 4.0 * h * dh * b * s, sum(_nbytes(t) for t in (
        q, k, v, lengths, out)), F32


def _paged_cost(q, k_pool, v_pool, block_tables, lengths, scale, out):
    b, h, dh = q.shape
    mb = block_tables.shape[1]
    bs, kv = k_pool.shape[1], k_pool.shape[2]
    kv_bytes = 2 * b * mb * bs * kv * dh * k_pool.element_size()
    return 4.0 * h * dh * b * mb * bs, kv_bytes + sum(
        _nbytes(t) for t in (q, block_tables, lengths, out)), F32


#: each ``repro_torch::`` operator's cost: (flops, bytes, flop class) of
#: its schema arguments and its output
KERNEL_COSTS: Dict[str, Callable] = {
    "fused_softmax": _softmax_cost,
    "fused_norm": _norm_cost,
    "fused_norm_residual": _norm_cost,
    "fused_sample": _sample_cost,
    "flash_attention": _flash_cost,
    "flash_attention_packed": _packed_cost,
    "flash_attention_packed_plan": _plan_cost,
    "flash_decode": _decode_cost,
    "flash_decode_paged": _paged_cost,
}

_REGISTERED = {"done": False}
_REGISTER_LOCK = threading.Lock()


def register_flop_formulas() -> None:
    """Register each kernel operator's FLOP formula with
    ``torch.utils.flop_counter`` (once a process; the operators are
    defined first), so ``FlopCounterMode`` counts a kernel node as this
    module does."""
    from torch.utils.flop_counter import register_flop_formula

    from repro_torch.kernels.traced import NAMESPACE, operators
    with _REGISTER_LOCK:
        if _REGISTERED["done"]:
            return
        operators()
        ns = getattr(torch.ops, NAMESPACE)
        for name, cost in KERNEL_COSTS.items():
            def formula(*args, out_val=None, _cost=cost, **kwargs):
                return int(_cost(*args, out_val, **kwargs)[0])
            register_flop_formula(getattr(ns, name), get_raw=True)(formula)
        _REGISTERED["done"] = True


# ---------------------------------------------------------------------------
# Op tables
# ---------------------------------------------------------------------------

def _concrete(n, shape_env) -> int:
    """An int, or a symbolic size at the upper bound of its range."""
    if isinstance(n, int):
        return n
    expr = n.node.expr
    if shape_env is not None and expr.free_symbols:
        expr = expr.xreplace({s: shape_env.var_to_range[s].upper
                              for s in expr.free_symbols})
    return int(expr)


def _encode(val, shape_env=None):
    if isinstance(val, torch.fx.Node):
        return _encode(val.meta.get("val"), shape_env)
    if isinstance(val, torch.Tensor):
        return {"shape": [_concrete(d, shape_env) for d in val.shape],
                "dtype": str(val.dtype).replace("torch.", "")}
    if isinstance(val, (list, tuple)):
        return [_encode(v, shape_env) for v in val]
    if isinstance(val, torch.SymInt):
        return _concrete(val, shape_env)
    if val is None or isinstance(val, (bool, int, float, str)):
        return val
    return {"repr": str(val)}


def _decode(val):
    if isinstance(val, list):
        return [_decode(v) for v in val]
    if isinstance(val, dict) and "shape" in val:
        return torch.empty(val["shape"], dtype=getattr(torch, val["dtype"]),
                           device="meta")
    if isinstance(val, dict):
        return val["repr"]
    return val


def _op_name(target) -> str:
    return str(target)           # "aten.mm.default", "repro_torch.fused_norm.default"


def _skipped(node: torch.fx.Node) -> bool:
    if node.op != "call_function" or node.target is operator.getitem:
        return True
    return _op_name(node.target).startswith("profiler.")


def op_table(gm: torch.fx.GraphModule, shape_env=None) -> List[dict]:
    """Each compute node of ``gm`` (every ``call_function`` but
    ``getitem`` and profiler ranges), in graph order, as JSON: its name,
    its op, its arguments and keyword arguments (tensors as shape and
    dtype) and its output.  Symbolic sizes are taken at the upper bound
    of their range in ``shape_env``."""
    rows = []
    for node in gm.graph.nodes:
        if _skipped(node):
            continue
        rows.append({"name": node.name, "op": _op_name(node.target),
                     "args": _encode(list(node.args), shape_env),
                     "kwargs": {k: _encode(v, shape_env)
                                for k, v in node.kwargs.items()},
                     "out": _encode(node.meta.get("val"), shape_env)})
    return rows


def _resolve(op: str):
    """The OpOverload named ``op`` ("ns.name.overload")."""
    ns, name, overload = op.split(".")
    if ns == "repro_torch":
        from repro_torch.kernels.traced import operators
        operators()
    return getattr(getattr(getattr(torch.ops, ns), name), overload)


def _tensors(val) -> List[torch.Tensor]:
    if isinstance(val, torch.Tensor):
        return [val]
    if isinstance(val, (list, tuple)):
        return [t for v in val for t in _tensors(v)]
    return []


def _is_view(overload) -> bool:
    """Every output aliases an input and none writes it: no bytes move."""
    from repro_torch.core.usage_records import _UNANNOTATED_VIEWS
    if overload._schema.name in _UNANNOTATED_VIEWS:
        return True
    rets = overload._schema.returns
    return bool(rets) and all(r.alias_info is not None and
                              not r.alias_info.is_write for r in rets)


def _flop_class(tensors: List[torch.Tensor]) -> str:
    lo = (torch.bfloat16, torch.float16)
    return BF16 if tensors and tensors[0].dtype in lo else F32


def row_cost(row: dict) -> Tuple[float, float, str, str]:
    """(flops, hbm bytes, flop class, collective type or "") of one op
    table row."""
    from torch.utils.flop_counter import flop_registry
    register_flop_formulas()
    overload = _resolve(row["op"])
    args, kwargs = _decode(row["args"]), {k: _decode(v) for k, v in
                                          row["kwargs"].items()}
    out = _decode(row["out"])
    ns, name = row["op"].split(".")[:2]
    if ns == "repro_torch":
        flops, nbytes, cls = KERNEL_COSTS[name](*args, out, **kwargs)
        return flops, float(nbytes), cls, ""
    ins = _tensors(args) + _tensors(list(kwargs.values()))
    outs = _tensors(out)
    if ns in _COLLECTIVE_NAMESPACES and name in _COLLECTIVES:
        return 0.0, 0.0, F32, _COLLECTIVES[name]
    flops = 0.0
    fn = flop_registry.get(overload.overloadpacket)
    if fn is not None:
        flops = float(fn(*args, **kwargs, out_val=out))
    schema = overload._schema.name + (
        f".{overload._schema.overload_name}"
        if overload._schema.overload_name else "")
    if _is_view(overload):
        nbytes = 0
    elif schema in _GATHERS or overload._schema.name in _GATHERS:
        nbytes = 2 * sum(_nbytes(t) for t in outs) + sum(
            _nbytes(t) for t in ins[1:] if not t.is_floating_point())
    elif schema in _UPDATES or overload._schema.name in _UPDATES:
        pos = _UPDATES.get(schema, _UPDATES.get(overload._schema.name))
        upd = args[pos] if len(args) > pos else None
        nbytes = 2 * (_nbytes(upd) if isinstance(upd, torch.Tensor)
                      else sum(_nbytes(t) for t in outs))
    else:
        nbytes = sum(_nbytes(t) for t in ins) + sum(_nbytes(t)
                                                    for t in outs)
    return flops, float(nbytes), _flop_class(ins), ""


def _rows(graph: Graph) -> Sequence[dict]:
    if isinstance(graph, torch.fx.GraphModule):
        return op_table(graph)
    return graph


def analyze(graph: Graph) -> Profile:
    """The graph's flops (by class), HBM bytes and collective bytes."""
    prof = Profile()
    for row in _rows(graph):
        flops, nbytes, cls, coll = row_cost(row)
        if coll:
            ins = _tensors(_decode(row["args"]))
            moved = float(sum(_nbytes(t) for t in ins))
            prof.collective_bytes += moved
            prof.collective_by_type[coll] = \
                prof.collective_by_type.get(coll, 0.0) + moved
            prof.collective_counts[coll] = \
                prof.collective_counts.get(coll, 0.0) + 1
            group = next((a for a in reversed(row["args"])
                          if isinstance(a, str)), "")
            prof.collective_by_group[group] = \
                prof.collective_by_group.get(group, 0.0) + moved
            prof.hbm_bytes += 2 * moved
            continue
        prof.flops += flops
        if flops:
            prof.flops_by_class[cls] = prof.flops_by_class.get(cls, 0.0) \
                + flops
        prof.hbm_bytes += nbytes
    return prof


def top_contributors(graph: Graph, k: int = 25) -> List[Tuple[float, str,
                                                               str]]:
    """The heaviest ops by HBM bytes: (bytes, node name, op and output
    shapes)."""
    rows = []
    for row in _rows(graph):
        _, nbytes, _, _ = row_cost(row)
        shapes = [t["shape"] for t in (row["out"] if isinstance(
            row["out"], list) else [row["out"]]) if isinstance(t, dict)
            and "shape" in t]
        rows.append((nbytes, row["name"], f"{row['op']} -> {shapes}"))
    rows.sort(key=lambda r: -r[0])
    return rows[:k]


__all__ = ["BF16", "F32", "KERNEL_COSTS", "Profile", "analyze", "op_table",
           "register_flop_formulas", "row_cost", "top_contributors"]
