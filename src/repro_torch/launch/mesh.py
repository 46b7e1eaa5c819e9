"""Production meshes: 256 ranks as a (16, 16) ("data", "model") mesh; two
such groups add a leading "pod" axis that the sharding rules fold into
data parallelism. Port of ``repro/launch/mesh.py``.

Functions, never module-level meshes: each builds a CPU
``torch.distributed.DeviceMesh`` on the process group already initialised
(the dry run initialises a fake one of 256 or 512 ranks), so importing
this module touches no distributed state. The card's peaks live in
``launch.roofline.HW``.
"""
from __future__ import annotations

__all__ = ["make_production_mesh", "make_local_mesh"]


def make_production_mesh(*, multi_pod: bool = False):
    """The (16, 16) mesh, or (2, 16, 16) with ``multi_pod``, over a group
    of 256 / 512 ranks."""
    from torch.distributed.device_mesh import init_device_mesh

    if multi_pod:
        return init_device_mesh("cpu", (2, 16, 16), mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh("cpu", (16, 16), mesh_dim_names=("data", "model"))


def make_local_mesh(num_devices: int | None = None):
    """An (n, 1) ("data", "model") mesh over the group's ``n`` ranks (by
    default all of them)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    n = num_devices or dist.get_world_size()
    return init_device_mesh("cpu", (n, 1), mesh_dim_names=("data", "model"))
