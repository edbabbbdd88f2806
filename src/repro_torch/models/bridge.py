"""Carry weights from the JAX package into the port.

`repro.models.init_params` returns a nested dict of arrays; the caller
converts it to numpy (``jax.tree.map(np.asarray, params)``) and
:func:`params_from_numpy` turns that tree into the port's tensors with
the same keys and the same einsum layouts (``wq`` (d,H,dh), ``wo``
(H,dh,d), ``w_gate``/``w_up`` (d,f), the GELU FFN's ``b_up``/``b_down``,
``tok`` (K,V,d) and ``head`` (K,d,V) with K = max(num_codebooks, 1): one
table of each a codebook; the mamba blocks' leaves, their f32 ``A_log``,
``D`` and ``dt_bias`` kept f32, and the hybrid's ``shared`` block).
A train state (``{"params", "opt", "step"}``, `repro_torch.training`)
crosses the same way: :func:`params_from_numpy` takes any nested dict,
and :func:`tree_to_numpy` carries the port's tree back (bf16 leaves as
f32, which holds them exactly).  Nothing here imports JAX.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from repro_torch.runtime.device import resolve_device


def tensor_from_numpy(a: Any, device=None) -> torch.Tensor:
    """One array to a tensor; bfloat16 arrays (which numpy holds as an
    extension dtype torch cannot read) go through float32 exactly."""
    arr = np.asarray(a)
    dev = resolve_device(device)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.astype(np.float32)).to(
            device=dev, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True)).to(dev)


def params_from_numpy(tree: Dict[str, Any], device=None) -> Dict[str, Any]:
    """Nested dict of numpy arrays -> the same dict of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def tree_to_numpy(tree: Any) -> Any:
    """Nested dict of tensors -> the same dict of numpy arrays on the
    host; a bfloat16 tensor becomes float32 (exact), since numpy has no
    bfloat16 of its own."""
    if isinstance(tree, dict):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.numpy()
