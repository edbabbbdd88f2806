"""Checkpoints of a train state, in the JAX package's on-disk format.

Counterpart of `repro.runtime.checkpoint`:

- a checkpoint is a directory ``step_<N:010d>/`` holding one
  ``leaf_<i:05d>.npy`` per leaf (its raw bytes as a 1-D uint8 array) and
  ``manifest.json`` (each leaf's '/'-joined tree path, file, shape and
  dtype name, the step and the caller's metadata);
- it is written to ``step_<N>.tmp`` and published with an atomic
  ``os.replace``, so a crash mid-write never corrupts the latest one;
- ``keep_last`` bounds how many are kept;
- ``save_async`` copies every leaf to host memory before it returns and
  writes on a background thread (training goes on during the I/O);
- ``load_latest`` with the trainer's auto-resume gives crash restart.

Leaves are tensors (any device) or numpy arrays; they load as CPU
tensors.  bfloat16 leaves are written and read as their raw bytes
through torch's own dtype, with no ``ml_dtypes``; the dtype names are
numpy's, so each package reads the other's checkpoints.  A DTensor
leaf is written as its global value (every rank of its mesh takes part
in the gather: each calls ``save``, or the caller gathers first and one
rank saves), so a checkpoint does not depend on the mesh it came from;
:func:`reshard` places a loaded tree on a new one (elastic resume).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

MANIFEST = "manifest.json"

#: the dtype names of the manifest (numpy's) and the port's dtypes
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16, "float64": torch.float64,
          "int32": torch.int32, "int64": torch.int64, "int16": torch.int16,
          "int8": torch.int8, "uint8": torch.uint8, "bool": torch.bool}
_NAMES = {dt: name for name, dt in DTYPES.items()}


def _flatten(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            key = f"{prefix}/{k}" if prefix else str(k)
            out.update(_flatten(v, key))
        return out
    out[prefix] = tree
    return out


def _unflatten(flat: Dict[str, Any]) -> Any:
    root: Dict[str, Any] = {}
    for path, val in flat.items():
        parts = path.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return root


def _host(leaf: Any) -> torch.Tensor:
    """A leaf as a contiguous CPU tensor of its own (a copy: the caller
    may go on changing the original); a DTensor's global value."""
    from repro_torch.distributed.sharding import is_dtensor
    if is_dtensor(leaf):
        leaf = leaf.full_tensor()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to("cpu", copy=True).contiguous()
    arr = np.asarray(leaf)
    if arr.dtype.name not in DTYPES:
        raise TypeError(f"checkpoint leaf of dtype {arr.dtype.name}")
    if arr.dtype.name == "bfloat16":   # numpy holds it as an extension
        raw = np.ascontiguousarray(arr).view(np.uint16)
        return torch.from_numpy(raw.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def _raw(t: torch.Tensor) -> np.ndarray:
    return t.reshape(-1).view(torch.uint8).numpy()


def save(directory: str, step: int, tree: Any,
         metadata: Optional[Dict[str, Any]] = None,
         keep_last: int = 3) -> str:
    flat = {path: _host(leaf) for path, leaf in _flatten(tree).items()}
    return _write(directory, step, flat, metadata, keep_last)


def _write(directory: str, step: int, flat: Dict[str, torch.Tensor],
           metadata: Optional[Dict[str, Any]], keep_last: int) -> str:
    final = os.path.join(directory, f"step_{step:010d}")
    tmp = final + ".tmp"
    os.makedirs(tmp, exist_ok=True)
    manifest = {"step": step, "metadata": metadata or {}, "leaves": {}}
    for i, (path, t) in enumerate(sorted(flat.items())):
        if t.dtype not in _NAMES:
            raise TypeError(f"checkpoint leaf {path!r} of dtype {t.dtype}")
        fname = f"leaf_{i:05d}.npy"
        np.save(os.path.join(tmp, fname), _raw(t))
        manifest["leaves"][path] = {
            "file": fname, "shape": list(t.shape), "dtype": _NAMES[t.dtype]}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                       # atomic publish
    _gc(directory, keep_last)
    return final


def _gc(directory: str, keep_last: int) -> None:
    ckpts = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in ckpts[:-keep_last] if keep_last else []:
        shutil.rmtree(os.path.join(directory, d))


def save_async(directory: str, step: int, tree: Any,
               metadata: Optional[Dict[str, Any]] = None,
               keep_last: int = 3) -> threading.Thread:
    """Snapshot to host memory now; write in the background."""
    flat = {path: _host(leaf) for path, leaf in _flatten(tree).items()}
    t = threading.Thread(target=_write, daemon=True,
                         args=(directory, step, flat, metadata, keep_last))
    t.start()
    return t


def available_steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for d in os.listdir(directory):
        if d.startswith("step_") and not d.endswith(".tmp") and \
                os.path.exists(os.path.join(directory, d, MANIFEST)):
            out.append(int(d[len("step_"):]))
    return sorted(out)


def load(directory: str, step: int) -> Tuple[Any, Dict[str, Any]]:
    """The tree of CPU tensors saved at ``step`` and its manifest."""
    path = os.path.join(directory, f"step_{step:010d}")
    with open(os.path.join(path, MANIFEST)) as f:
        manifest = json.load(f)
    flat = {}
    for leaf_path, info in manifest["leaves"].items():
        if info["dtype"] not in DTYPES:
            raise TypeError(f"checkpoint leaf {leaf_path!r} of dtype "
                            f"{info['dtype']}")
        raw = np.load(os.path.join(path, info["file"]))
        flat[leaf_path] = torch.from_numpy(raw).view(
            DTYPES[info["dtype"]]).reshape(info["shape"])
    return _unflatten(flat), manifest


def load_latest(directory: str) -> Optional[Tuple[int, Any, Dict[str, Any]]]:
    steps = available_steps(directory)
    if not steps:
        return None
    tree, manifest = load(directory, steps[-1])
    return steps[-1], tree, manifest


def reshard(tree: Any, sharding_fn: Callable[[str, Any], Any]) -> Any:
    """Elastic reload: each leaf (its global value: a loaded tensor or
    array, or a DTensor of an old mesh) placed by ``sharding_fn(path,
    leaf)``, which returns ``(mesh, placements)`` of the new mesh (the
    leaves of `repro_torch.distributed.plan.to_shardings`).  A tensor is
    distributed from its value, which must be the same on every rank; a
    DTensor is redistributed, or taken whole first where its mesh is
    another."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    def place(path, leaf):
        mesh, placements = sharding_fn(path, leaf)
        if isinstance(leaf, DTensor):
            if leaf.device_mesh == mesh:
                return leaf.redistribute(mesh, placements)
            leaf = leaf.full_tensor()
        if not isinstance(leaf, torch.Tensor):
            leaf = _host(leaf)
        return distribute_tensor(leaf, mesh, placements)
    return _unflatten({p: place(p, a) for p, a in _flatten(tree).items()})
