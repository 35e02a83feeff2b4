"""Device meshes (``repro.launch.mesh`` counterpart) over
``torch.distributed``'s ``DeviceMesh``.

Importing this module starts nothing: a process group is started only
inside the functions, and only when none is running.  The one-device
meshes start a world-size-1 group from an in-process store; the
production mesh needs a group of 256 (512) ranks started by the caller
(e.g. ``torchrun``, one rank per card), and raises otherwise.
`production_shape` gives the production mesh's axes and sizes without
devices (`repro_torch.distributed.sharding.MeshShape`), which the spec
functions read.
"""
from __future__ import annotations

import math

from repro_torch.distributed.sharding import MeshShape


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """Single pod: (16, 16) = ("data", "model"), 256 devices.  Multi-pod:
    (2, 16, 16) = ("pod", "data", "model"), 512 devices; the pod axis
    extends data parallelism across the pods."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def _world_size_one(device_type: str):
    """A world-size-1 process group from an in-process store, unless a
    group runs already: gloo for the CPU, and NCCL for the card where
    there is one."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized():
        return
    backend = ("cpu:gloo,cuda:nccl" if device_type == "cuda" or
               torch.cuda.is_available() else "gloo")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (`production_shape`) on the card, one rank per
    device of the running process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    ms = production_shape(multi_pod=multi_pod)
    need = math.prod(ms.sizes)
    have = dist.get_world_size() if dist.is_initialized() else 1
    if have < need:
        raise RuntimeError(
            f"mesh {ms.sizes} needs {need} ranks, have {have}; start one "
            f"rank per card (e.g. torchrun --nproc-per-node ... with "
            f"WORLD_SIZE={need}) before building it")
    return init_device_mesh("cuda", ms.sizes, mesh_dim_names=ms.names)


def mesh_axes(mesh) -> tuple:
    """(dp_axes, tp_axis) of a mesh built here (a ``DeviceMesh`` or a
    `MeshShape`)."""
    names = getattr(mesh, "mesh_dim_names", None) or mesh.names
    if "pod" in names:
        return ("pod", "data"), "model"
    return ("data",), "model"


def smoke_mesh():
    """(1, 1) ("data", "model") mesh on the CPU (gloo), for tests of the
    sharding machinery."""
    from torch.distributed.device_mesh import init_device_mesh
    _world_size_one("cpu")
    return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def single_gpu_mesh():
    """(1, 1) ("data", "model") mesh on the current card (NCCL): the one
    H100's counterpart of a mesh."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    if not torch.cuda.is_available():
        raise RuntimeError("single_gpu_mesh: no CUDA device")
    torch.cuda.set_device(torch.cuda.current_device())
    _world_size_one("cuda")
    return init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
