"""Derive tensor usage records from the port's own op graph.

The paper's allocator consumes ``{first_op, last_op, size}`` tuples indexed
by a topological sort of the DNN graph (§4.2).  The JAX package reads them
from a jaxpr; the port reads them from a ``torch.fx.GraphModule`` that
``make_fx`` records in fake mode (shapes, dtypes and storages, no data),
with each kernel wrapper one node (`repro_torch.kernels.traced`).  The
rules are the JAX package's:

- the op index is a node's position among the graph's compute nodes (every
  ``call_function`` node but ``getitem``, which only names one output of a
  node with several), in graph order;
- inputs and parameters (placeholders and constants) get no record;
- a graph output lives to ``n_ops``;
- records under ``min_size`` bytes are dropped;
- ``tensor_id`` is ``f"t{n}"`` in order of first definition.

An ATen graph aliases where a jaxpr does not.  A record stands for one
storage that a node allocates, and its size is that storage's bytes.  A
view (an output that the op's schema aliases to an argument, or that
shares an argument's storage) allocates nothing and gets no record; a
node that reads a view, or writes a tensor in place, extends the base
storage's ``last_op`` as a read of the base would.
"""
from __future__ import annotations

import operator
from typing import Any, Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core.allocator import TensorUsageRecord

# ops whose output shares its first argument's storage with no alias
# annotation in their schema
_UNANNOTATED_VIEWS = ("aten::_unsafe_view",)


def _flat(val) -> List[Any]:
    if isinstance(val, (tuple, list)):
        return [x for v in val for x in _flat(v)]
    return [val]


def _storage_key(t: torch.Tensor):
    return t.untyped_storage()._cdata


def _storage_nbytes(t: torch.Tensor) -> int:
    return int(t.untyped_storage().nbytes())


def _is_op(node: torch.fx.Node) -> bool:
    """A node that counts as one op: every ``call_function`` but the
    ``getitem`` that picks one output of another node."""
    return node.op == "call_function" and node.target is not operator.getitem


def _aliased_arg(node: torch.fx.Node, j: int, n_out: int):
    """The argument (a Node) that output ``j`` of ``node`` aliases by the
    op's schema, else None."""
    schema = getattr(node.target, "_schema", None)
    if schema is None:
        return None
    if schema.name in _UNANNOTATED_VIEWS:
        return node.args[0]
    rets = schema.returns
    if not rets:
        return None
    ret = rets[j] if len(rets) == n_out else rets[0]
    if ret.alias_info is None:
        return None
    sets = set(ret.alias_info.before_set)
    for pos, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not sets & set(arg.alias_info.before_set):
            continue
        if arg.kwarg_only or pos >= len(node.args):
            return node.kwargs.get(arg.name)
        return node.args[pos]
    return None


def graph_lifetimes(gm: torch.fx.GraphModule,
                    nbytes: Callable[[torch.Tensor], int] = _storage_nbytes
                    ) -> Dict[str, Any]:
    """Every storage that a compute node allocates, in order of first
    definition: ``{"nodes": [compute nodes], "storages": [(node, output
    index, first_op, last_op, bytes)], "n_ops": n}``, ``last_op`` already
    ``n_ops`` for a graph output.  Needs each node's ``meta["val"]``, as
    ``make_fx`` records it.  ``nbytes`` gives a storage's bytes from one
    of its tensors (a trace with symbolic sizes passes its own)."""
    nodes = [n for n in gm.graph.nodes if _is_op(n)]
    index = {n: i for i, n in enumerate(nodes)}
    n_ops = len(nodes)
    # owner of each node's value(s): a storage number, None for an input
    owners: Dict[torch.fx.Node, Any] = {}
    by_storage: Dict[int, Optional[int]] = {}
    storages: List[list] = []           # [node, j, first, last, size]

    def owner_of(arg) -> List[Optional[int]]:
        return [o for a in _flat(arg) if isinstance(a, torch.fx.Node)
                for o in _flat(owners.get(a))]

    def touch(keys, i) -> None:
        for k in keys:
            if k is not None:
                storages[k][3] = max(storages[k][3], i)

    for node in gm.graph.nodes:
        if node.op in ("placeholder", "get_attr"):
            vals = _flat(node.meta.get("val"))
            for v in vals:
                if isinstance(v, torch.Tensor):
                    by_storage[_storage_key(v)] = None
            owners[node] = [None] * len(vals)
            continue
        if node.op == "output":
            for k in owner_of(node.args):
                if k is not None:
                    storages[k][3] = n_ops
            continue
        if node.op != "call_function":
            raise ValueError(f"records: unexpected node {node.op} "
                             f"{node.target}")
        if node.target is operator.getitem:
            src, idx = node.args
            owners[node] = owners[src][idx]
            continue
        i = index[node]
        touch(owner_of(list(node.args) + list(node.kwargs.values())), i)
        if "val" not in node.meta:
            raise ValueError(f"records: node {node.name} has no traced value"
                             " (trace with make_fx)")
        val = node.meta["val"]
        outs = list(val) if isinstance(val, (tuple, list)) else [val]
        mine: List[Optional[int]] = []
        for j, v in enumerate(outs):
            if not isinstance(v, torch.Tensor):
                mine.append(None)
                continue
            key = _storage_key(v)
            base = _aliased_arg(node, j, len(outs))
            if base is not None:
                found = owner_of(base)
                k = found[0] if found else None
            elif key in by_storage:
                k = by_storage[key]
            else:
                k = len(storages)
                storages.append([node, j, i, i, nbytes(v)])
            by_storage.setdefault(key, k)
            touch([k], i)
            mine.append(k)
        owners[node] = mine if isinstance(val, (tuple, list)) else mine[0]
    return {"nodes": nodes, "n_ops": n_ops,
            "storages": [tuple(s) for s in storages]}


def records_from_graph(gm: torch.fx.GraphModule, min_size: int = 1024
                       ) -> List[TensorUsageRecord]:
    """Intermediate-tensor usage records from a traced GraphModule.

    Model inputs and parameters (placeholders and constants) are excluded,
    as the paper manages *intermediate* ("activation") tensors; graph
    outputs get ``last_op = n_ops`` (they must survive the whole
    inference)."""
    records = []
    for n, (_, _, first, last, size) in enumerate(
            graph_lifetimes(gm)["storages"]):
        if size < min_size:
            continue
        records.append(TensorUsageRecord(tensor_id=f"t{n}", first_op=first,
                                         last_op=last, size=size))
    return records


def trace(fn: Callable, *args: Any) -> torch.fx.GraphModule:
    """``fn``'s op graph in fake mode (no data is computed and no device
    memory is taken), each kernel wrapper of ``ops`` one node.  Tensors
    ``fn`` closes over (the weights) become constants of the graph."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    from repro_torch.kernels.traced import traced_kernels
    mode = FakeTensorMode(allow_non_fake_inputs=True)
    fake = [mode.from_tensor(a) if isinstance(a, torch.Tensor) else a
            for a in args]
    with traced_kernels(), mode:
        return make_fx(fn)(*fake)


def records_for_fn(fn: Callable, *args: Any, min_size: int = 1024
                   ) -> List[TensorUsageRecord]:
    return records_from_graph(trace(fn, *args), min_size=min_size)


def dedup_repeated_structure(records: Sequence[TensorUsageRecord],
                             num_layers: int) -> List[TensorUsageRecord]:
    """Paper §6.2.2 trick: for models with repeated structures, compute
    offsets once for one block and reuse across blocks. We approximate by
    keeping only records whose first_op falls in the first 1/num_layers of
    the op range (plus globals), cutting planner cost from O((Ln)^2) to
    O(n^2)."""
    if num_layers <= 1 or not records:
        return list(records)
    max_op = max(r.last_op for r in records)
    cutoff = max_op / num_layers
    return [r for r in records if r.first_op <= cutoff]


def peak_live_bytes(records: Sequence[TensorUsageRecord]) -> int:
    """The most bytes the records hold live at one op: the sum of the
    sizes of the records with ``first_op <= t <= last_op``, at its
    largest over ``t``."""
    delta: Dict[int, int] = {}
    for r in records:
        delta[r.first_op] = delta.get(r.first_op, 0) + r.size
        delta[r.last_op + 1] = delta.get(r.last_op + 1, 0) - r.size
    peak = live = 0
    for t in sorted(delta):
        live += delta[t]
        peak = max(peak, live)
    return peak
