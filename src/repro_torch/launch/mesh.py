"""Device meshes (``repro.launch.mesh`` counterpart) over
``torch.distributed``'s ``DeviceMesh``.

Importing this module starts nothing: a process group is started only
inside the functions, and only when none is running.  The one-device
meshes start a world-size-1 group from an in-process store; the
production mesh needs a group of 256 (512) ranks started by the caller
(e.g. ``torchrun``, one rank per card), and raises otherwise.
`fake_production_mesh` builds the production mesh on one process over a
``"fake"`` process group of 256 (512) ranks, whose collectives move
nothing: the dry run's partitioned step traces one device's program on
it.  `production_shape` gives the production mesh's axes and sizes
without devices (`repro_torch.distributed.sharding.MeshShape`), which the
spec functions read.
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


def fake_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh (`production_shape`) on this one process:
    rank 0 of a ``"fake"`` default process group of 256 (512) ranks
    (``torch.testing._internal.distributed.fake_pg``), whose collectives
    run no communication.  DTensors on it hold one device's shards, for
    the dry run's partitioned trace (on fake tensors).  A fake group
    already running is reused, or replaced by one of the other size; a
    group of another backend refuses: the production dry run then needs a
    process of its own (as the JAX package's dry run does, whose device
    count is fixed when JAX starts)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    ms = production_shape(multi_pod=multi_pod)
    need = math.prod(ms.sizes)
    if dist.is_initialized():
        backend = dist.get_backend()
        if backend != "fake":
            raise RuntimeError(
                f"fake_production_mesh: a {backend} process group of "
                f"{dist.get_world_size()} ranks is running; run the "
                f"production dry run in a process of its own (python -m "
                f"repro_torch.launch.dryrun --mesh production)")
        if dist.get_world_size() == need:
            return init_device_mesh(device_type, ms.sizes,
                                    mesh_dim_names=ms.names)
        dist.destroy_process_group()        # the other pod count's
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=need)
    return init_device_mesh(device_type, ms.sizes, mesh_dim_names=ms.names)


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
