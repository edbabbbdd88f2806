"""Sharding rules: logical axes -> mesh dims, applied through DTensor.

Counterpart of `repro.distributed.sharding`.  Model code never names mesh
dims; it annotates activations with *logical* axes through
:func:`constrain`.  A caller installs a :class:`ShardingRules` context
(:func:`sharding_rules`) that maps logical axes onto the dims of a
``torch.distributed.device_mesh.DeviceMesh`` (``pod`` / ``data`` /
``model``).  Outside any context every annotation is a no-op, and so it
is for a plain tensor inside one: only a ``DTensor`` is redistributed.
So the same model code runs on one device and over a mesh.

Logical axes used across the package (:data:`DEFAULT_RULES`):

  ``batch``      request/example dim       -> ("pod", "data") (DP)
  ``embed``      d_model activation dim    -> None (replicated)
  ``heads``      attention heads           -> "model" (TP)
  ``kv_heads``   kv heads (may replicate)  -> "model" if divisible
  ``mlp``        FFN hidden dim            -> "model" (TP)
  ``vocab``      vocabulary                -> "model" (TP)
  ``expert``     MoE experts               -> "model" (EP)
  ``kv_seq``     cache sequence dim        -> "model" (context parallel)
  ``fsdp``       parameter shard dim       -> ("data", "pod") (ZeRO-3)
  ``ssm_inner``  mamba d_inner             -> "model" (TP)

A spec is a tuple with one entry per tensor dim: None, a mesh dim name, or
a tuple of names (the JAX package's ``PartitionSpec`` entries).  A tensor
dim sharded over several mesh dims is split in the MESH's dim order (the
earlier mesh dim major), which is DTensor's order; the JAX package splits
it in the entry's order.  For ``("data", "pod")`` on a ``(pod, data,
model)`` mesh the two put the same chunks on different devices.  No
result depends on it: every collective and every saved or resharded leaf
works on the global tensor.

The JAX package clears its trace caches when a context changes mesh
(``_LAST_MESH``): its traces bake a device set into their constraints.
The port runs eagerly and caches no trace, so it has no counterpart.
"""
from __future__ import annotations

import contextlib
import sys
import threading
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

Axis = Union[str, Tuple[str, ...], None]


def mesh_sizes(mesh: Any) -> Dict[str, int]:
    """Dim name -> size of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def axes_size(mesh: Any, part: Axis) -> int:
    """Devices a spec entry spans (1 for None)."""
    if part is None:
        return 1
    sizes = mesh_sizes(mesh)
    if isinstance(part, (tuple, list)):
        n = 1
        for a in part:
            n *= sizes[a]
        return n
    return sizes[part]


def placements(mesh: Any, spec: Tuple[Axis, ...]) -> Tuple[Any, ...]:
    """A spec tuple -> DTensor placements, one per mesh dim: ``Shard(i)``
    where tensor dim ``i``'s entry names the mesh dim, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dim = None
        for i, part in enumerate(spec):
            names = part if isinstance(part, tuple) else (part,)
            if name in names:
                dim = i
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


@dataclass(frozen=True)
class ShardingRules:
    mesh: Any                     # torch.distributed.device_mesh.DeviceMesh
    # logical axis -> mesh dim (or tuple of dims, or None); flags pass
    rules: Dict[str, Any] = field(default_factory=dict)
    # keep shardings whose axis does not divide the dim (DTensor splits
    # unevenly, as torch.chunk does) in activation constraints
    uneven: bool = False

    def physical(self, logical: Axis) -> Axis:
        if logical is None:
            return None
        if isinstance(logical, tuple):
            out = []
            for ax in logical:
                ph = self.rules.get(ax)
                if ph is None:
                    continue
                out.extend(ph if isinstance(ph, tuple) else (ph,))
            return tuple(out) if out else None
        return self.rules.get(logical)

    def spec(self, *logical_axes: Axis) -> Tuple[Axis, ...]:
        used = set()
        parts = []
        for ax in logical_axes:
            ph = self.physical(ax)
            if isinstance(ph, tuple):
                ph = tuple(a for a in ph if a not in used)
                used.update(ph)
                parts.append(ph if ph else None)
            else:
                if ph in used:
                    ph = None
                if ph is not None:
                    used.add(ph)
                parts.append(ph)
        return tuple(parts)

    def sharding(self, *logical_axes: Axis):
        """``(mesh, placements)`` of these logical axes."""
        return self.mesh, placements(self.mesh, self.spec(*logical_axes))


_STATE = threading.local()


def current_rules() -> Optional[ShardingRules]:
    return getattr(_STATE, "rules", None)


@contextlib.contextmanager
def sharding_rules(rules: Optional[ShardingRules]):
    """Install ``rules`` for this thread.  It sets nothing else: a plain
    tensor that meets a DTensor in an op raises, as DTensor does, so the
    model code places its positions, masks and constants on the mesh
    itself (:func:`replicate_like`)."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield rules
    finally:
        _STATE.rules = prev


def is_dtensor(x: Any) -> bool:
    """Whether ``x`` is a DTensor (without importing DTensor: where its
    module was never imported, no DTensor exists)."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def shard_offset(shape, mesh: Any, placements, dim: int) -> int:
    """The global index of this rank's first entry along ``dim`` of a
    tensor of global ``shape`` placed by ``placements`` (DTensor's split:
    ``torch.chunk``'s sizes, the earlier mesh dim major).  Read from the
    mesh coordinate, a Python int, so a trace keeps it a constant."""
    from torch.distributed.tensor import Shard
    coord = mesh.get_coordinate()
    size, off = int(shape[dim]), 0
    for i, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            k = mesh.size(i)
            chunk = -(-size // k)
            start = min(coord[i] * chunk, size)
            off += start
            size = min(start + chunk, size) - start
    return off


def _contiguous_stride(shape) -> tuple:
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def from_local(out, mesh, placements, shape):
    """A DTensor of global ``shape`` from this rank's contiguous shard."""
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(out.contiguous(), mesh, placements,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def from_local_like(out, like):
    """This rank's shard ``out`` as a DTensor placed and shaped as
    ``like``."""
    return from_local(out, like.device_mesh, like.placements, like.shape)


def to_local(t, partial_dims: Sequence[int] = ()):
    """``t``'s shard, its gradient ``Partial`` on ``partial_dims`` (mesh
    dims where ``t`` is replicated but read by sharded rows or heads)."""
    if t is None:
        return None
    from torch.distributed.tensor import Partial
    grad = [Partial() if i in partial_dims else p
            for i, p in enumerate(t.placements)]
    return t.to_local(grad_placements=grad)


def replicated_on(t: torch.Tensor, like: Any) -> torch.Tensor:
    """``t``, a plain tensor every rank computes alike (a position or
    frequency table, a mask, a constant), as a DTensor replicated on the
    mesh of ``like``; unchanged where ``like`` is no DTensor or ``t``
    already is one.  Model code places such tensors itself: a plain
    tensor meeting a DTensor raises."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate
    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def refuse_placement(name: str, what: str, t, i: int, takes: str):
    """Raise: ``what`` of ``name`` is placed on mesh dim ``i`` where the
    kernel takes only ``takes``."""
    mesh = t.device_mesh
    raise ValueError(
        f"{name}: {what} is placed {t.placements[i]} on mesh dim "
        f"{mesh.mesh_dim_names[i]!r}; the kernel takes {takes} there "
        "(redistribute first)")


def need_dtensor(name: str, what: str, t) -> None:
    """Raise where ``t`` is a plain tensor among DTensor inputs."""
    if t is not None and not is_dtensor(t):
        raise ValueError(f"{name}: {what} is a plain tensor beside DTensor "
                         "inputs; place every input on the mesh")


def local_kv_heads(name: str, q_off: int, q_n: int, group: int,
                   k_off: int, k_n: int):
    """The kv heads that query heads ``q_off .. q_off + q_n - 1`` (of
    ``group`` a kv head) read, as (first, count) within a shard holding
    kv heads ``k_off .. k_off + k_n - 1``: global kv head ``(q_off + j)
    // group`` for local query head ``j``.  No query head (an uneven
    split's last ranks) reads none, ``(0, 0)``.  Raises where they lie
    outside the shard or do not form equal local groups (``j // (q_n /
    count)``), the layout the kernels take."""
    if q_n == 0:
        return 0, 0
    first = q_off // group - k_off
    last = (q_off + q_n - 1) // group - k_off
    if first < 0 or last >= k_n:
        raise ValueError(f"{name}: the local query heads {q_off}.."
                         f"{q_off + q_n - 1} read kv heads outside this "
                         "rank's shard")
    n_kv = last - first + 1
    g_local = q_n // n_kv
    if g_local * n_kv != q_n or any(
            (q_off + j) // group - k_off - first != j // g_local
            for j in range(q_n)):
        raise ValueError(f"{name}: the local query heads {q_off}.."
                         f"{q_off + q_n - 1} do not form equal groups over "
                         f"kv heads (H/KV = {group})")
    return first, n_kv


def head_slices(name: str, q, kvs, rowed, *, q_head: int, kv_head: int):
    """Local tensors of a head-parallel call.  ``q`` is sharded on its
    batch dim (0) and/or its head dim ``q_head``, or replicated; each of
    ``kvs`` follows it (batch dim 0, head dim ``kv_head``), or is
    replicated where ``q``'s heads are sharded: then the kv heads of the
    local query heads are sliced out (:func:`local_kv_heads`), their
    gradient partial over those mesh dims.  ``rowed`` (lengths) follow
    ``q``'s batch.  Any other placement raises.  Returns (q, kvs, rowed)
    local."""
    from torch.distributed.tensor import Replicate, Shard
    need_dtensor(name, "q", q)
    for t in list(kvs) + list(rowed):
        need_dtensor(name, "an input", t)
    head_dims, batch_dims = [], []
    for i, p in enumerate(q.placements):
        if p == Shard(0):
            batch_dims.append(i)
        elif p == Shard(q_head):
            head_dims.append(i)
        elif not isinstance(p, Replicate):
            refuse_placement(name, "q", q, i, "Shard of the batch or the "
                             "heads, or Replicate")
    sliced = []
    for t in kvs:
        for i, p in enumerate(t.placements):
            if i in batch_dims:
                ok = p == Shard(0)
            elif i in head_dims:
                ok = p == Shard(kv_head) or isinstance(p, Replicate)
            else:
                ok = isinstance(p, Replicate)
            if not ok:
                refuse_placement(name, "k/v", t, i, "q's placement (or "
                                 "Replicate under sharded query heads)")
        sliced.append([i for i in head_dims
                       if isinstance(t.placements[i], Replicate)])
    for t in rowed:
        if t is None:
            continue
        for i, p in enumerate(t.placements):
            if p != (Shard(0) if i in batch_dims else Replicate()):
                refuse_placement(name, "lengths", t, i,
                                 "q's batch placement")
    mesh = q.device_mesh
    ql = q.to_local()
    q_n = ql.shape[q_head]
    q_off = shard_offset(q.shape, mesh, q.placements, q_head)
    group = q.shape[q_head] // kvs[0].shape[kv_head]
    out_kv = []
    for t, part in zip(kvs, sliced):
        tl = to_local(t, part)
        k_off = shard_offset(t.shape, mesh, t.placements, kv_head)
        first, n_kv = local_kv_heads(name, q_off, q_n, group,
                                     k_off, tl.shape[kv_head])
        if n_kv != tl.shape[kv_head]:
            tl = tl.narrow(kv_head, first, n_kv)
        out_kv.append(tl)
    return ql, out_kv, [None if t is None else t.to_local() for t in rowed]


# logical axes never split unevenly: the kv heads must split as the
# query heads do, or stay whole (each rank then reads the kv heads of its
# own query heads), and an uneven split of both does not line up
_EVEN_ONLY = frozenset({"kv_heads"})


def fit_activation(rules: ShardingRules, shape: Tuple[int, ...],
                   *logical_axes: Axis) -> Tuple[Axis, ...]:
    """The spec :func:`constrain` applies: the rules' spec with every
    entry that does not divide its dim dropped, unless ``rules.uneven``
    (then only dims of size 1 drop, and the kv heads still need an even
    split: the plan's ``_fit`` replicates them otherwise too), and every
    entry over mesh dims of size 1 (a shard of everything: the same as
    replicated, which is how the plan places arguments there)."""
    spec = rules.spec(*logical_axes)
    fixed = []
    for dim, part, ax in zip(shape, spec, logical_axes):
        size = axes_size(rules.mesh, part) if part is not None else 0
        uneven = rules.uneven and dim > 1 and ax not in _EVEN_ONLY
        keep = size > 1 and (dim % size == 0 or uneven)
        fixed.append(part if keep else None)
    return tuple(fixed)


def constrain(x: torch.Tensor, *logical_axes: Axis) -> torch.Tensor:
    """Annotate ``x`` with logical axes: a no-op outside a rules context
    and for a plain tensor; a DTensor is redistributed to the placements
    the rules give (a pending sum, ``Partial``, is reduced)."""
    rules = current_rules()
    if rules is None:
        return x
    if x.dim() != len(logical_axes):
        raise ValueError(
            f"constrain: rank {x.dim()} != {len(logical_axes)} axes")
    if not is_dtensor(x):
        return x
    want = placements(rules.mesh,
                      fit_activation(rules, tuple(x.shape), *logical_axes))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def fsdp_gathered(w: torch.Tensor, dtype: Optional[torch.dtype] = None
                  ) -> torch.Tensor:
    """A DTensor weight gathered over the batch's mesh dims (its FSDP
    shard: ZeRO-3's all-gather before use), its model-dim shards kept, so
    every product a weight enters is batch-parallel whatever DTensor's
    own strategy choice; cast to ``dtype`` first where given (its
    gradient is then reduce-scattered in that dtype).  A plain tensor, a
    weight not sharded there, and any weight outside a rules context
    pass unchanged."""
    rules = current_rules()
    if rules is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    batch = rules.physical("batch") or ()
    batch = batch if isinstance(batch, tuple) else (batch,)
    want = [Replicate() if name in batch else p for name, p in
            zip(w.device_mesh.mesh_dim_names, w.placements)]
    if want == list(w.placements):
        return w
    if dtype is not None:
        w = w.to(dtype)
    return w.redistribute(w.device_mesh, want)


def axis_size(logical: str) -> int:
    """Size of the mesh dims a logical axis maps to (1 if unmapped)."""
    rules = current_rules()
    if rules is None:
        return 1
    return axes_size(rules.mesh, rules.physical(logical))


DEFAULT_RULES: Dict[str, Any] = {
    "batch": ("pod", "data"),
    "act_seq": "model",
    "act_dh": "model",
    "heads": "model",
    "kv_heads": "model",
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    # capacity/group dim of the MoE dispatch buffer: routed tokens stay
    # inside their data shard
    "exp_cap": "data",
    "kv_seq": "model",
    # decode caches whose kv-head count does not divide the model dim
    # shard the head *dim* instead of the sequence
    "kv_dh_shard": True,
    # ZeRO-3 parameter / optimizer sharding, over the pod dim too on a
    # multi-pod mesh
    "fsdp": ("data", "pod"),
    "ssm_inner": "model",
    "embed": None,
}


def make_rules(mesh: Any, overrides: Optional[Dict[str, Any]] = None,
               uneven: bool = False) -> ShardingRules:
    """:data:`DEFAULT_RULES` pruned to ``mesh``'s dim names, then
    ``overrides``."""
    names = set(mesh.mesh_dim_names)

    def prune(ax: Any) -> Any:
        if ax is None or isinstance(ax, bool):
            return ax          # flags pass through untouched
        if isinstance(ax, tuple):
            kept = tuple(a for a in ax if a in names)
            return kept if kept else None
        return ax if ax in names else None

    rules = {k: prune(v) for k, v in DEFAULT_RULES.items()}
    if overrides:
        rules.update(overrides)
    return ShardingRules(mesh=mesh, rules=rules, uneven=uneven)
