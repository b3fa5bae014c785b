"""Meshes for a MARP plan and for the production layouts, as
``torch.distributed.DeviceMesh`` over the process group that is up (the
JAX package's ``repro/launch/mesh.py``).  Functions, so importing this
module touches no process group."""
from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """A v5e pod's 16 x 16 ("data", "model") layout, or two pods with a
    leading "pod" axis; the process group must have 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_plan_mesh(d: int, t: int, device_type: str = "cuda", pods: int = 1):
    """Mesh for a MARP plan: d data x t model shards over the d * t ranks
    of the process group that is up; with ``pods`` > 1, pods x d x t ranks
    under a leading "pod" axis (``make_production_mesh(multi_pod=True)``
    is pods = 2, d = t = 16)."""
    if pods > 1:
        return init_device_mesh(device_type, (pods, d, t),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(device_type, (d, t), mesh_dim_names=("data", "model"))
