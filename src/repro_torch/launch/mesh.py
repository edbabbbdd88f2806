"""Production and debug meshes.  Defined as FUNCTIONS, so importing this
module touches no process group: the caller initialises one (a real one,
or the dry run's ``"fake"`` group of 256 or 512 ranks) first."""
from __future__ import annotations

from typing import Optional


def _device_type() -> str:
    import torch
    return "cuda" if torch.cuda.is_available() else "cpu"


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: Optional[str] = None):
    """16x16 = 256 GPUs a pod, ``("data", "model")``; two pods, 512
    GPUs, ``("pod", "data", "model")`` with ``multi_pod``.  Needs a
    process group of that world size."""
    from torch.distributed.device_mesh import init_device_mesh
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type or _device_type(), shape,
                            mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: Optional[str] = None):
    """A small ``(n_data, n_model)`` ``("data", "model")`` mesh for the
    multi-rank tests (a gloo world of ``n_data * n_model`` ranks)."""
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type or _device_type(),
                            (n_data, n_model),
                            mesh_dim_names=("data", "model"))
