"""Device mesh construction: the counterpart of the JAX package's
``parallel/mesh.py``.

The JAX package builds one ``jax.sharding.Mesh`` with axes ("data",
"model") and lets GSPMD insert the collectives. Here the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with the same dims over the
ranks of the default process group (one process per card), and the
collectives are written out where GSPMD puts them (``parallel/tp.py``,
``parallel/sharding.py``). Rank r sits at (r // model, r % model): the ranks
of one "model" group are neighbours, as JAX lays the model axis on
neighbouring chips.

The sub-groups take the default group's backend (NCCL on cards, gloo on the
CPU, or gloo on cards where a caller chose it), so a mesh never changes the
transport its caller set up.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
MODEL_AXIS = "model"


def effective_platform_devices() -> list[int]:
    """The ranks of the default process group (one card each); ``[0]`` when
    no group is initialized (a single process)."""
    return list(range(dist.get_world_size())) if dist.is_initialized() else [0]


def make_mesh(model_parallelism: int = 1, devices: list[int] | None = None) -> DeviceMesh:
    """2-D mesh (data, model) over ``devices`` (ranks of the default group,
    all of them by default). model_parallelism=1 gives pure data
    parallelism. Every rank of the default group must call it, in the same
    order as its other group creations; a rank outside ``devices`` gets
    ``None``."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.initialize_multihost, or torchrun)")
    devices = list(devices) if devices is not None else effective_platform_devices()
    n = len(devices)
    if n % model_parallelism != 0:
        raise ValueError(f"{n} devices not divisible by model={model_parallelism}")
    grid = torch.tensor(devices, dtype=torch.int64).reshape(n // model_parallelism,
                                                            model_parallelism)
    backend = dist.get_backend()
    rank = dist.get_rank()
    mine = {}
    # every rank creates every group, in one order (new_group is collective)
    for axis, lines in ((DATA_AXIS, grid.t()), (MODEL_AXIS, grid)):
        for line in lines.tolist():
            g = dist.new_group(line, backend=backend)
            if rank in line:
                mine[axis] = g
    if rank not in devices:
        return None
    device_type = "cuda" if backend == "nccl" or torch.cuda.is_available() else "cpu"
    return DeviceMesh.from_group([mine[DATA_AXIS], mine[MODEL_AXIS]], device_type,
                                 mesh=grid, mesh_dim_names=(DATA_AXIS, MODEL_AXIS))


def auto_mesh(
    model_parallelism: int = 1,
    devices: list[int] | None = None,
    batch_divisor: int | None = None,
) -> DeviceMesh | None:
    """Mesh for the CLI surface and ``Pipeline``, or ``None`` for one device.

    ``model_parallelism`` has the JAX package's semantics:

    - ``0``: opt out, never build a mesh.
    - ``1`` (default): pure data parallelism over every rank of the default
      group when it has more than one; ``None`` otherwise.
    - ``> 1``: dp x tp (data = ranks / model_parallelism); a world that it
      does not divide raises ``ValueError``.

    ``batch_divisor``: training batches shard evenly (``shard_batch``). The
    JAX package shrinks the data axis to a divisor of the batch and leaves
    the other chips idle; with one process per card that would leave
    processes without a mesh, so here a data axis that does not divide the
    batch raises ``ValueError`` naming the largest one that does."""
    if not model_parallelism:
        return None
    devices = list(devices) if devices is not None else effective_platform_devices()
    mp = max(model_parallelism, 1)
    if mp > 1 and len(devices) % mp != 0:
        raise ValueError(f"{len(devices)} devices not divisible by model_parallelism={mp}")
    dp = len(devices) // mp
    if batch_divisor is not None and batch_divisor % dp != 0:
        fits = max(d for d in range(1, dp + 1) if batch_divisor % d == 0)
        raise ValueError(f"the data axis ({dp}) does not divide the batch ({batch_divisor}); "
                         f"launch {fits * mp} processes (data={fits}) or change the batch")
    if dp * mp <= 1:
        return None
    return make_mesh(model_parallelism=mp, devices=devices)


def axis_size(mesh: DeviceMesh | None, axis: str) -> int:
    """The size of ``axis`` (1 without a mesh)."""
    return 1 if mesh is None else mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh | None, axis: str) -> int:
    """This rank's index along ``axis`` (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh | None, axis: str):
    """The process group of this rank along ``axis``, or None when the axis
    has one rank (nothing to communicate)."""
    return None if axis_size(mesh, axis) == 1 else mesh.get_group(axis)


def replicated(mesh: DeviceMesh) -> tuple:
    """Placements of a tensor held whole on every rank."""
    return tuple(Replicate() for _ in mesh.mesh_dim_names)


def data_sharding(mesh: DeviceMesh, ndim: int = 1) -> tuple:
    """Placements of a batch tensor: leading axis over "data", the rest
    whole (``ndim`` is accepted for the JAX signature; the placement does not
    depend on it)."""
    return (Shard(0), Replicate())
